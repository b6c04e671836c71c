"""K1's plain version (v2e_tpu_torch refractory_scan on CPU tensors) against
the JAX package's XLA scan (emulator/core.py, the fast path's scan body)
and its Pallas kernel emulator_scan_refractory_pallas in interpret mode.

Leak and shot noise are on.  The scan's inputs are rebuilt from the JAX
run: lp = lin_log(frames) (cutoff 0), the leak deltas with jitter 0 (pure
products, so they rebuild exactly) and the shot maps the run returned.
Tolerance: counts, i0 and K identical; base and spike-time memory within
1e-6 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2e_tpu.emulator.config import EmulatorConfig as JaxConfig
from v2e_tpu.emulator.core import emulate_chunk
from v2e_tpu.emulator.state import init_state
from v2e_tpu.ops.core import lin_log
from v2e_tpu.ops.pallas.emulator_scan import emulator_scan_refractory_pallas
from v2e_tpu_torch.ops.kernels.emulator_scan import refractory_scan

ATOL = 1e-6


def scan_case(F, H, W, R, seed):
    rng = np.random.default_rng(seed)
    frames = np.clip(128 * np.exp(rng.normal(0, 0.4, (F, H, W))), 0, 255)
    frames = np.round(frames).astype(np.float32)
    times = (np.arange(1, F + 1) / 3000.0).astype(np.float32)
    cfg = JaxConfig(
        sigma_thres=0.03, leak_rate_hz=20.0, leak_jitter_fraction=0.0,
        shot_noise_rate_hz=50.0, cutoff_hz=0.0, refractory_period_s=R,
        use_pallas_scan=False,
    )
    params, state = init_state(cfg, jnp.asarray(frames[0]), jnp.float32(0.0),
                               jax.random.key(seed))
    new_state, outs = emulate_chunk(cfg, params, state, jnp.asarray(frames),
                                    jnp.asarray(times))
    tj = jnp.asarray(times)
    dts = jnp.diff(tj, prepend=state.t_prev[None])
    inputs = dict(
        lp=lin_log(jnp.asarray(frames)),
        leak=dts[:, None, None] * (cfg.leak_rate_hz * params.noise_rate_array)
        * (1.0 - 0.0 * jnp.zeros((F, H, W))) * params.pos_thres,
        shot=jnp.asarray(outs["shot_on"]) | jnp.asarray(outs["shot_off"]),
        pos=params.pos_thres, neg=params.neg_thres,
        base=state.base_log_frame, mem=state.timestamp_mem,
        dts=dts, t_prevs=tj - dts,
    )
    xla = (new_state.base_log_frame, new_state.timestamp_mem, outs["ev_count"],
           outs["i0"], outs["K"])
    return {k: np.asarray(v) for k, v in inputs.items()}, [np.asarray(a) for a in xla]


def run_port(inp, R):
    t = lambda k: torch.from_numpy(np.array(inp[k]))
    out = refractory_scan(
        t("lp"), t("leak"), t("shot").to(torch.uint8), t("pos"), t("neg"),
        t("base"), t("mem"), t("dts"), t("t_prevs"), R,
    )
    return [o.numpy() for o in out]


def run_pallas(inp, R):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    nb, nm, cnt, i0, K = emulator_scan_refractory_pallas(
        j["lp"], j["leak"], j["shot"], j["pos"], j["neg"], j["base"], j["mem"],
        j["dts"], j["t_prevs"], R, True,
    )
    return [np.asarray(a) for a in (nb, nm, cnt, i0, K)]


def assert_same(got, want):
    names = ("base", "mem", "counts", "i0", "K")
    for name, a, b in zip(names, got, want):
        if name in ("base", "mem"):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("R", [0.0005, 0.005])
def test_plain_matches_xla_scan_and_pallas(R):
    inp, xla = scan_case(40, 60, 80, R, seed=0)
    got = run_port(inp, R)
    assert np.abs(got[2]).sum() > 1000 and got[3].max() > 0  # events, refractory engaged
    assert_same(got, xla)
    assert_same(got, run_pallas(inp, R))


def test_plain_matches_above_256k_pixels():
    """A plane the TPU sends to the XLA scan (refractory_plane_ok false)."""
    R = 0.0005
    inp, xla = scan_case(3, 520, 520, R, seed=1)
    got = run_port(inp, R)
    assert np.abs(got[2]).sum() > 1000
    assert_same(got, xla)
    assert_same(got, run_pallas(inp, R))


def test_zero_refractory_is_plain_scan():
    """At R = 0 the filter never engages: i0 = 0 and the counts are the
    refractory-free scan's (the JAX package's R = 0 branch)."""
    inp, xla = scan_case(12, 30, 40, 0.0, seed=2)
    got = run_port(inp, 0.0)
    assert not got[3].any()
    assert_same(got, xla)
