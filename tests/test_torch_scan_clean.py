"""K2's plain version (v2e_tpu_torch `scan` on CPU tensors) against the JAX
package's refractory-free core: the XLA scan of emulator/core.py at R = 0
and the Pallas kernel emulator_scan_pallas in interpret mode.

F = 140 frames crosses the TPU kernel's 128-frame segments, which the port
does not have.  The scan's inputs are rebuilt from the JAX run as in
test_torch_emulator_scan.py (lin-log frames, leak deltas with jitter 0,
the shot maps the run returned).  Tolerance: counts identical; base within
1e-6 absolute.  The chunk-level dispatch (emulate_chunk_apply at R = 0) is
held to the XLA scan event for event.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2e_tpu.emulator.config import EmulatorConfig as JaxConfig
from v2e_tpu.emulator.core import emulate_chunk
from v2e_tpu.emulator.state import init_state
from v2e_tpu.ops.core import lin_log
from v2e_tpu.ops.pallas.emulator_scan import F_SEG, emulator_scan_pallas
from v2e_tpu_torch import tracing
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import emulate_chunk_apply
from v2e_tpu_torch.emulator.state import from_jax_emulator
from v2e_tpu_torch.ops.kernels.emulator_scan import scan

ATOL = 1e-6
F, H, W = 140, 24, 40


def jax_case(noise: bool, seed: int):
    rng = np.random.default_rng(seed)
    frames = np.clip(128 * np.exp(rng.normal(0, 0.4, (F, H, W))), 0, 255)
    frames = np.round(frames).astype(np.float32)
    times = (np.arange(1, F + 1) / 3000.0).astype(np.float32)
    cfg = JaxConfig(
        sigma_thres=0.03, leak_rate_hz=20.0 if noise else 0.0,
        leak_jitter_fraction=0.0, shot_noise_rate_hz=50.0 if noise else 0.0,
        cutoff_hz=0.0, refractory_period_s=0.0, use_pallas_scan=False,
    )
    params, state = init_state(cfg, jnp.asarray(frames[0]), jnp.float32(0.0),
                               jax.random.key(seed))
    new_state, outs = emulate_chunk(cfg, params, state, jnp.asarray(frames),
                                    jnp.asarray(times))
    tj = jnp.asarray(times)
    dts = jnp.diff(tj, prepend=state.t_prev[None])
    inp = dict(
        lp=lin_log(jnp.asarray(frames)),
        leak=dts[:, None, None] * (cfg.leak_rate_hz * params.noise_rate_array)
        * params.pos_thres if noise else None,
        shot=(jnp.asarray(outs["shot_on"]) | jnp.asarray(outs["shot_off"])).astype(jnp.uint8)
        if noise else None,
        pos=params.pos_thres, neg=params.neg_thres, base=state.base_log_frame,
    )
    inp = {k: (None if v is None else np.asarray(v)) for k, v in inp.items()}
    return cfg, params, state, frames, times, new_state, outs, inp


def run_port(inp):
    t = lambda k: None if inp[k] is None else torch.from_numpy(np.array(inp[k]))
    base, counts = scan(t("lp"), t("leak"), t("shot"), t("pos"), t("neg"), t("base"))
    return base.numpy(), counts.numpy()


@pytest.mark.parametrize("noise", [True, False], ids=["leak_shot", "no_noise"])
def test_plain_matches_xla_scan_and_pallas(noise):
    assert F > F_SEG
    _, _, _, _, _, new_state, outs, inp = jax_case(noise, seed=3)
    base, counts = run_port(inp)
    assert np.abs(counts).sum() > 1000
    np.testing.assert_array_equal(counts, np.asarray(outs["ev_count"]))
    np.testing.assert_allclose(base, np.asarray(new_state.base_log_frame), rtol=0, atol=ATOL)

    j = {k: (None if v is None else jnp.asarray(v)) for k, v in inp.items()}
    p_base, p_counts = emulator_scan_pallas(
        j["lp"], j["leak"], j["shot"], j["pos"], j["neg"], j["base"], True)
    np.testing.assert_array_equal(counts, np.asarray(p_counts))
    np.testing.assert_allclose(base, np.asarray(p_base), rtol=0, atol=ATOL)


def np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None and f.name != "key"}


@pytest.mark.parametrize("noise", [True, False], ids=["leak_shot", "no_noise"])
def test_chunk_at_zero_refractory_runs_k2(noise):
    """emulate_chunk_apply at R = 0 takes K2 (not K1) and gives the XLA
    scan's outputs: counts, i0 = 0, stride 1, K, num_on/num_off with the
    shot maps added, base; the spike-time memory is left as it was."""
    cfg_j, params_j, state_j, frames, times, new_state, outs, inp = jax_case(noise, seed=4)
    params, state = from_jax_emulator(np_fields(params_j), np_fields(state_j), "cpu")
    cfg = EmulatorConfig(
        sigma_thres=cfg_j.sigma_thres, leak_rate_hz=cfg_j.leak_rate_hz,
        leak_jitter_fraction=0.0, shot_noise_rate_hz=cfg_j.shot_noise_rate_hz,
        cutoff_hz=0.0, refractory_period_s=0.0,
    )
    shape = (F, H, W)
    draws = {
        "leak": torch.zeros(shape) if noise else None,
        "shot": None, "photoreceptor": None,
    }
    if noise:
        # uniforms that reproduce the JAX run's shot maps exactly
        on, off = np.asarray(outs["shot_on"]), np.asarray(outs["shot_off"])
        draws["shot"] = torch.from_numpy(np.where(on, 1.0, np.where(off, 0.0, 0.5)).astype(np.float32))
    before = tracing.counters()
    new, got = emulate_chunk_apply(cfg, params, state, torch.from_numpy(frames),
                                   torch.from_numpy(times), draws)
    after = tracing.counters()
    for k in ("launch.k1", "launch.k2"):  # CPU: plain
        assert after.get(k, 0) == before.get(k, 0), k
    np.testing.assert_array_equal(got["ev_count"].numpy(), np.asarray(outs["ev_count"]))
    for key in ("i0", "stride", "K", "num_on", "num_off"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(outs[key]), err_msg=key)
    np.testing.assert_allclose(new.base_log_frame.numpy(),
                               np.asarray(new_state.base_log_frame), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(new.timestamp_mem.numpy(),
                                  np.asarray(state_j.timestamp_mem))
