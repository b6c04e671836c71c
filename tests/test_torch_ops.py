"""Port parity: v2e_tpu_torch.ops.core against v2e_tpu.ops.core (f32, CPU).

Inputs come from a numpy seed; the JAX functions' own random draws (leak
jitter, shot noise) are drawn with their keys and handed to the port.
Tolerance: integer outputs exact, float outputs 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2e_tpu.ops import core as jcore
from v2e_tpu_torch.ops import core as tcore

RTOL = 1e-6
SHAPE = (37, 53)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def frames():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, (4, *SHAPE)).astype(np.float32)


def test_lin_log_and_rescale(frames):
    ints = np.arange(256, dtype=np.float32)
    for x in (frames, ints):
        np.testing.assert_allclose(
            tcore.lin_log(t(x)).numpy(), np.asarray(jcore.lin_log(jnp.asarray(x))),
            rtol=RTOL,
        )
        np.testing.assert_allclose(
            tcore.rescale_intensity_frame(t(x)).numpy(),
            np.asarray(jcore.rescale_intensity_frame(jnp.asarray(x))), rtol=RTOL,
        )


def test_subtract_leak_current():
    rng = np.random.default_rng(1)
    base = rng.normal(4.0, 0.5, SHAPE).astype(np.float32)
    pos = rng.uniform(0.1, 0.3, SHAPE).astype(np.float32)
    rate = np.exp(rng.normal(0, 0.2, SHAPE)).astype(np.float32)
    key = jax.random.key(3)
    want = jcore.subtract_leak_current(
        jnp.asarray(base), 0.5, jnp.float32(0.01), jnp.asarray(pos), 0.1,
        jnp.asarray(rate), key,
    )
    rand = jax.random.normal(key, SHAPE, dtype=jnp.float32)
    got = tcore.subtract_leak_current(
        t(base), 0.5, torch.tensor(0.01), t(pos), 0.1, t(rate), t(rand)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_compute_event_map():
    rng = np.random.default_rng(2)
    diff = rng.normal(0, 0.6, SHAPE).astype(np.float32)
    pos = rng.uniform(0.1, 0.3, SHAPE).astype(np.float32)
    neg = rng.uniform(0.1, 0.3, SHAPE).astype(np.float32)
    jp, jn = jcore.compute_event_map(jnp.asarray(diff), jnp.asarray(pos), jnp.asarray(neg))
    tp, tn = tcore.compute_event_map(t(diff), t(pos), t(neg))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tp.dtype == torch.int32 and int(tp.sum()) > 0 and int(tn.sum()) > 0


def test_generate_shot_noise():
    rng = np.random.default_rng(4)
    inten = rng.uniform(0.07, 1.0, SHAPE).astype(np.float32)
    pre_p = rng.uniform(0.7, 1.4, SHAPE).astype(np.float32)
    pre_n = rng.uniform(0.7, 1.4, SHAPE).astype(np.float32)
    key = jax.random.key(5)
    args = (5000.0, jnp.float32(0.01), 0.25, jnp.asarray(inten),
            jnp.asarray(pre_p), jnp.asarray(pre_n))
    j_on, j_off = jcore.generate_shot_noise(key, *args)
    rand01 = jax.random.uniform(key, SHAPE, dtype=jnp.float32)
    t_on, t_off = tcore.generate_shot_noise(
        t(rand01), 5000.0, torch.tensor(0.01), 0.25, t(inten), t(pre_p), t(pre_n)
    )
    np.testing.assert_array_equal(t_on.numpy(), np.asarray(j_on))
    np.testing.assert_array_equal(t_off.numpy(), np.asarray(j_off))
    assert t_on.any() and t_off.any()


@pytest.mark.parametrize("R", [0.0005, 0.005, 1e-6])
def test_refractory_filter(R):
    rng = np.random.default_rng(6)
    count = rng.integers(0, 12, SHAPE).astype(np.int32)
    t_prev = np.float32(0.02)
    mem = (t_prev - rng.uniform(0, 0.01, SHAPE)).astype(np.float32)
    ts = np.float32(1e-4)
    want = jcore.refractory_filter(
        jnp.asarray(count), jnp.asarray(mem), jnp.float32(t_prev), jnp.float32(ts), R
    )
    got = tcore.refractory_filter(
        t(count), t(mem), torch.tensor(t_prev), torch.tensor(ts), R
    )
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.broadcast_to(a.numpy(), SHAPE),
                                      np.broadcast_to(np.asarray(b), SHAPE))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=RTOL)
