"""K3's gradient (v2e_tpu_torch/ops/kernels/warp.py: `warp_plain_vjp`,
`BilinearWarpFn`, models/backwarp.py::backwarp_grad) against JAX's autodiff
of v2e_tpu/models/backwarp.py::backwarp, on the CPU.

Flows reach up to 20 px outside a 16x24 image, and a quarter of them land
on whole pixels (the fractional weight is exactly 0 there; the floor's
gradient is 0 in both frameworks).  Tolerance: 1e-6 absolute for the flow
and image gradients (float32, unit-scale images and output gradients; the
four taps are summed in another order than XLA's transpose).  The VJP
kernel itself runs only on the card (tests/test_torch_kernels_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import one_torch_thread  # noqa: F401 (autouse fixture)
from v2e_tpu.models.backwarp import backwarp as jax_backwarp
from v2e_tpu_torch.models.backwarp import backwarp_grad
from v2e_tpu_torch.ops.kernels.warp import BilinearWarpFn, warp_plain, warp_plain_vjp

N, H, W = 3, 16, 24
ATOL = 1e-6


def inputs(c=1, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(N, c, H, W)).astype(np.float32)
    flow = rng.uniform(-20, 20, (N, 2, H, W)).astype(np.float32)
    whole = rng.random((N, 2, H, W)) < 0.25
    flow[whole] = np.round(flow[whole]) + 0.5  # x + u - 0.5 is a whole pixel
    gout = rng.normal(size=(N, c, H, W)).astype(np.float32)
    return img, flow, gout


def jax_grads(img, flow, gout):
    _, vjp = jax.vjp(jax_backwarp, jnp.asarray(img), jnp.asarray(flow))
    g_img, g_flow = vjp(jnp.asarray(gout))
    return np.asarray(g_img), np.asarray(g_flow)


def test_inputs_reach_outside_and_whole_pixels():
    _, flow, _ = inputs()
    xs = np.arange(W)[None, None, :] + flow[:, 0] - 0.5
    assert (xs < 0).any() and (xs > W - 1).any()
    assert (xs == np.floor(xs)).mean() > 0.2


def test_plain_vjp_matches_jax():
    img, flow, gout = inputs()
    want_img, want_flow = jax_grads(img, flow, gout)
    t = torch.from_numpy
    g_flow, g_img = warp_plain_vjp(t(img[:, 0]), t(flow[:, 0]), t(flow[:, 1]), t(gout[:, 0]),
                                   need_img=True)
    np.testing.assert_allclose(g_flow.numpy(), want_flow, rtol=0, atol=ATOL)
    np.testing.assert_allclose(g_img.numpy(), want_img[:, 0], rtol=0, atol=ATOL)
    g_flow_only, none = warp_plain_vjp(t(img[:, 0]), t(flow[:, 0]), t(flow[:, 1]),
                                       t(gout[:, 0]))
    assert none is None
    assert torch.equal(g_flow_only, g_flow)


def test_autograd_through_warp_plain_matches_plain_vjp_and_jax():
    img, flow, gout = inputs()
    want_img, want_flow = jax_grads(img, flow, gout)
    ti = torch.from_numpy(img[:, 0]).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    out = warp_plain(ti, tf[:, 0], tf[:, 1])
    g_img, g_flow = torch.autograd.grad(out, (ti, tf), torch.from_numpy(gout[:, 0]))
    np.testing.assert_allclose(g_flow.numpy(), want_flow, rtol=0, atol=ATOL)
    np.testing.assert_allclose(g_img.numpy(), want_img[:, 0], rtol=0, atol=ATOL)
    p_flow, p_img = warp_plain_vjp(ti.detach(), tf[:, 0].detach(), tf[:, 1].detach(),
                                   torch.from_numpy(gout[:, 0]), need_img=True)
    np.testing.assert_allclose(g_flow.numpy(), p_flow.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(g_img.numpy(), p_img.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("img_grad", [False, True])
def test_backwarp_grad_matches_jax(c, img_grad):
    img, flow, gout = inputs(c, seed=c)
    want_img, want_flow = jax_grads(img, flow, gout)
    ti = torch.from_numpy(img).requires_grad_(img_grad)
    tf = torch.from_numpy(flow).requires_grad_()
    out = backwarp_grad(ti, tf)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(
        jax_backwarp(jnp.asarray(img), jnp.asarray(flow))))
    out.backward(torch.from_numpy(gout))
    np.testing.assert_allclose(tf.grad.numpy(), want_flow, rtol=0, atol=ATOL)
    if img_grad:
        np.testing.assert_allclose(ti.grad.numpy(), want_img, rtol=0, atol=ATOL)
    else:
        assert ti.grad is None


def test_function_gradcheck_float64():
    rng = np.random.default_rng(5)
    img = torch.tensor(rng.normal(size=(2, 7, 9)), dtype=torch.float64, requires_grad=True)
    flow = torch.tensor(rng.uniform(-5, 5, (2, 2, 7, 9)), dtype=torch.float64,
                        requires_grad=True)
    assert torch.autograd.gradcheck(BilinearWarpFn.apply, (img, flow))


def test_function_double_backward_raises():
    """The VJP is once differentiable on both devices: a double backward
    raises instead of dropping the second-order terms."""
    rng = np.random.default_rng(6)
    img = torch.tensor(rng.normal(size=(1, 5, 6)), dtype=torch.float32)
    flow = torch.tensor(rng.uniform(-3, 3, (1, 2, 5, 6)), dtype=torch.float32,
                        requires_grad=True)
    (g,) = torch.autograd.grad((BilinearWarpFn.apply(img, flow) ** 2).sum(), flow,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()
