"""SuperSloMo training in the port (v2e_tpu_torch/models/train.py) against
the JAX package's (v2e_tpu/models/train.py), on the CPU.

Inputs: JAX's `create_train_state(seed=0, base=8, host_init=True)` weights
(its numpy draw: jax.random's would spend ~20 s compiling) carried into the
port through `from_jax_params`, and one batch of B=2 triples of 32x64
frames drawn with numpy.  Tolerances:
* the loss and its three terms within 1e-5 relative (float32 sums in
  another order, convolutions by another library);
* every parameter's gradient within 1e-4 of that tensor's largest |g| (the
  same, through some 60 layers of backward);
* Adam against optax.adam, both fed the same gradients, within 1e-7 after
  three steps (the update is m/(sqrt(v)+eps) in both, rounded in another
  order; it is about sign(g), so the optimizers are held on identical
  gradients, not on the gradients each framework computed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from v2e_tpu.models import train as jax_train
from v2e_tpu_torch.models import train
from v2e_tpu_torch.models.convert_ckpt import from_jax_params, to_jax_params

B, H, W = 2, 32, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the module's torch ops on one thread, restoring the count after.
    Beside other test workers on the same cores, torch's CPU thread pool
    waits on descheduled threads: 8 training steps at base 8 took 108 s on
    8 threads and 2.7 s on one, with 5 busy processes beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    state, _ = jax_train.create_train_state(seed=0, base=8, host_init=True)
    return to_np(state.flow_params), to_np(state.interp_params)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    return {
        "I0": rng.normal(0, 0.3, (B, 1, H, W)).astype(np.float32),
        "I1": rng.normal(0, 0.3, (B, 1, H, W)).astype(np.float32),
        "It": rng.normal(0, 0.3, (B, 1, H, W)).astype(np.float32),
        "t": rng.uniform(0.1, 0.9, (B,)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_params, batch):
    def loss_fn(ps):
        return jax_train.slomo_loss(ps[0], ps[1], *(jnp.asarray(batch[k]) for k in
                                                      ("I0", "I1", "It", "t")))

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jax_params)
    return to_np(metrics), to_np(grads)


@pytest.fixture(scope="module")
def port_loss_and_grads(jax_params, batch):
    state = train.create_train_state(params=jax_params, device="cpu")
    b = train.batch_to(batch, torch.device("cpu"))
    loss, metrics = train.slomo_loss(state.flow_net, state.interp_net,
                                     b["I0"], b["I1"], b["It"], b["t"])
    loss.backward()
    grads = [{name: {"w": net.get_submodule(name).weight.grad.numpy(),
                     "b": net.get_submodule(name).bias.grad.numpy()} for name in tree}
             for net, tree in zip((state.flow_net, state.interp_net), jax_params)]
    return {k: float(v.detach()) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("term", ["loss", "l_r", "l_w", "l_s"])
def test_loss_terms_match_jax(jax_loss_and_grads, port_loss_and_grads, term):
    want = float(jax_loss_and_grads[0][term])
    got = port_loss_and_grads[0][term]
    assert abs(got - want) <= 1e-5 * abs(want), (term, got, want)


@pytest.mark.parametrize("net", [0, 1], ids=["flow", "interp"])
def test_gradients_match_jax(jax_loss_and_grads, port_loss_and_grads, net):
    want_tree = jax_loss_and_grads[1][net]
    got_tree = port_loss_and_grads[1][net]
    assert set(got_tree) == set(want_tree)
    for layer, wb in want_tree.items():
        for k in ("w", "b"):
            want, got = wb[k], got_tree[layer][k]
            scale = float(np.abs(want).max())
            assert scale > 0, (layer, k)
            err = float(np.abs(got - want).max())
            assert err <= 1e-4 * scale, (layer, k, err, scale)


def test_adam_matches_optax_on_the_same_gradients(jax_params):
    """Three steps of each optimizer on one fixed set of gradients."""
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(0, 1e-2, p.shape).astype(np.float32), jax_params)
    tx = optax.adam(1e-4)
    update = jax.jit(tx.update)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    opt_state = tx.init(params)
    state = train.create_train_state(params=jax_params, device="cpu", learning_rate=1e-4)
    nets = (state.flow_net, state.interp_net)
    for _ in range(3):
        updates, opt_state = update(jax.tree_util.tree_map(jnp.asarray, grads),
                                    opt_state, params)
        params = optax.apply_updates(params, updates)
        for net, tree in zip(nets, grads):
            for layer, wb in tree.items():
                conv = net.get_submodule(layer)
                conv.weight.grad = torch.from_numpy(wb["w"].copy())
                conv.bias.grad = torch.from_numpy(wb["b"].copy())
        state.optimizer.step()
    got = to_jax_params(*nets)
    for want_tree, got_tree in zip(to_np(params), got):
        for layer, wb in want_tree.items():
            for k in ("w", "b"):
                np.testing.assert_allclose(got_tree[layer][k], wb[k], rtol=0, atol=1e-7)


def test_params_round_trip(jax_params):
    back = to_jax_params(*from_jax_params(*jax_params, device="cpu"))
    for want_tree, got_tree in zip(jax_params, back):
        assert set(got_tree) == set(want_tree)
        for layer, wb in want_tree.items():
            for k in ("w", "b"):
                assert got_tree[layer][k].dtype == np.float32
                np.testing.assert_array_equal(got_tree[layer][k], wb[k])


def test_training_loss_decreases():
    """The analogue of tests/test_parallel.py's single-device check: Adam on
    the Super-SloMo loss of a static scene (It == I0 == I1) lowers it
    within 8 steps."""
    state = train.create_train_state(seed=1, learning_rate=2e-4, base=8, device="cpu")
    rng = np.random.default_rng(1)
    img = rng.normal(size=(B, 1, 32, 32)).astype(np.float32) * 0.2
    batch = {"I0": img, "I1": img, "It": img, "t": np.full((B,), 0.5, np.float32)}
    step = train.make_train_step()
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert state.step == 8
    assert losses[-1] < losses[0], losses
