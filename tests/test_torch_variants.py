"""The emulator's pixel variants and its per-frame path on the port (CPU)
against the JAX package.

* SciDVS on the fast path: the port's `emulate_chunk_apply` (its plain
  SciDVS core, `_scidvs_core`) against v2e_tpu's `_emulate_chunk_fast`
  (its XLA scan), on a 40x56 bar moving over a texture, clean and with
  leak, shot noise and a 0.5 ms refractory period, over two consecutive
  chunks of 24 frames with the state carried over;
* the CSDVS surround, `_update_csdvs` exact (DCT-II) and Euler, against
  v2e_tpu's at 32x32, 37x53 and 64x96, dt 1e-4, 3e-3 and 1 s, with
  cs_tau_p_ms None (the zero-tau limit) and 3;
* the per-frame path (`emulator_step` over each frame) against v2e_tpu's
  `emulator_step` scan, with CSDVS, SciDVS or photoreceptor noise, the
  single-pixel probe and every model state;
* the dispatch: SciDVS and the per-frame path never reach K1 or K2 (nor
  their plain versions); the fast path without variants does.

Both packages get the same inputs: frames from a numpy generator, v2e_tpu's
parameters and state (from_jax_emulator) and the random draws v2e_tpu made
(test_torch_emulator.jax_draws).

Tolerances, with what these CPU runs measured:
* event counts, i0, K and stride equal at >= 99.9 % of pixel-frames and
  frames (measured: all equal in every case);
* SciDVS highpass and memorized base within 1e-6 absolute (measured 4.8e-7,
  about 4 ulp at 1.1: XLA's sinh is not torch's, and XLA contracts
  multiply-adds);
* the exact CSDVS surround within 1e-5 absolute at values up to 5.2
  (measured 3.3e-6: v2e_tpu takes the DCT with a float32 FFT, the port with
  float64 basis products); the Euler surround within 2e-6 (measured 9.5e-7);
* the probe's 9 values and every state frame within 1e-5 absolute
  (measured 2.9e-6, the CSDVS states).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_emulator import fields, jax_draws
from v2e_tpu.emulator.config import EmulatorConfig as JaxConfig
from v2e_tpu.emulator.core import _emulate_chunk_fast, _update_csdvs as jax_update_csdvs
from v2e_tpu.emulator.core import emulate_chunk
from v2e_tpu.emulator.emulator import MODEL_STATES as JAX_MODEL_STATES
from v2e_tpu.emulator.state import init_state as jax_init_state
from v2e_tpu_torch.emulator import core
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.emulator import MODEL_STATES
from v2e_tpu_torch.emulator.state import from_jax_emulator
from v2e_tpu_torch.ops.kernels import emulator_scan

F, H, W = 24, 40, 56
COUNT_SHARE = 1e-3
ATOL_SCIDVS = 1e-6
ATOL_CS_EXACT = 1e-5
ATOL_CS_EULER = 2e-6
ATOL_STATES = 1e-5

CLEAN = dict(sigma_thres=0.03, leak_rate_hz=0.0, shot_noise_rate_hz=0.0,
             refractory_period_s=0.0, cutoff_hz=0.0)
NOISY = dict(sigma_thres=0.03, leak_rate_hz=5.0, shot_noise_rate_hz=20.0,
             refractory_period_s=5e-4, cutoff_hz=0.0)


def moving_bar(n, seed=0):
    """n frames of a bright bar moving 1.5 px per frame over a texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    tex = 90 + 40 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    frames = np.stack([
        np.where(np.abs((xx - 1.5 * i) % W - 20) < 3, tex + 110, tex)
        + rng.normal(0, 2, (H, W)) for i in range(n)
    ])
    return np.clip(frames, 0, 255).round().astype(np.float32)


def start(kw, seed, vrms=None):
    """v2e_tpu's config, params and state from the bar's first frame, and
    the port's copies."""
    frames = moving_bar(2 * F + 1, seed)
    jcfg = JaxConfig(use_pallas_scan=False, **kw)
    params, state = jax_init_state(jcfg, jnp.asarray(frames[0]), jnp.float32(0.0),
                                   jax.random.key(seed))
    if vrms is not None:
        params = params.replace(photoreceptor_noise_vrms=jnp.float32(vrms))
    tparams, tstate = from_jax_emulator(fields(params), fields(state), "cpu")
    return frames, jcfg, params, state, EmulatorConfig(**kw), tparams, tstate


def port_chunk(cfg, params, state, frames, times, jax_state):
    draws = {k: torch.from_numpy(v) for k, v in jax_draws(jax_state, len(times), (H, W)).items()}
    return core.emulate_chunk_apply(cfg, params, state, torch.from_numpy(frames),
                                    torch.from_numpy(times), draws)


def assert_share_equal(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.mean(got != want) <= COUNT_SHARE, f"{name}: {np.mean(got != want)} differ"


def assert_counts_close(to, jo):
    for key in ("ev_count", "i0", "K", "stride"):
        assert_share_equal(to[key].numpy(), jo[key], key)
    for key in ("num_on", "num_off"):
        a, b = int(np.sum(jo[key])), int(to[key].sum())
        assert abs(a - b) <= COUNT_SHARE * max(a, 1), key


@pytest.mark.parametrize("kw", [CLEAN, NOISY], ids=["clean", "leak_shot_refractory"])
def test_scidvs_chunks_match_fast_path(kw):
    kw = dict(kw, scidvs=True)
    frames, jcfg, params, state, cfg, tparams, tstate = start(kw, seed=1)
    times = (np.arange(1, 2 * F + 1) / 1500.0).astype(np.float32)
    for c in range(2):  # two chunks, the state carried over
        sl = slice(c * F, (c + 1) * F)
        tstate, to = port_chunk(cfg, tparams, tstate, frames[1:][sl], times[sl], state)
        state, jo = _emulate_chunk_fast(jcfg, params, state, jnp.asarray(frames[1:][sl]),
                                        jnp.asarray(times[sl]))
        assert int(np.abs(np.asarray(jo["ev_count"])).sum()) > 10000
        assert_counts_close(to, jo)
        if kw["shot_noise_rate_hz"]:
            np.testing.assert_array_equal(to["shot_on"].numpy(), np.asarray(jo["shot_on"]))
        for name in ("scidvs_highpass", "base_log_frame"):
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       np.asarray(getattr(state, name)),
                                       rtol=0, atol=ATOL_SCIDVS, err_msg=name)
        # the last lin-log frame: XLA's log is one ulp off torch's at some DN
        np.testing.assert_allclose(tstate.scidvs_previous_photo.numpy(),
                                   np.asarray(state.scidvs_previous_photo), rtol=1e-6)
        np.testing.assert_array_equal(tstate.timestamp_mem.numpy(),
                                      np.asarray(state.timestamp_mem))
    if kw["refractory_period_s"]:
        assert np.asarray(jo["i0"]).any()


@pytest.mark.parametrize("solver,atol", [("exact", ATOL_CS_EXACT), ("euler", ATOL_CS_EULER)])
@pytest.mark.parametrize("h,w", [(32, 32), (37, 53), (64, 96)])
@pytest.mark.parametrize("tau_p_ms", [None, 3.0])
def test_csdvs_surround_update(solver, atol, h, w, tau_p_ms):
    rng = np.random.default_rng(h * w)
    lp = (4.0 + rng.normal(0, 0.5, (h, w))).astype(np.float32)
    surround = (4.0 + rng.normal(0, 0.5, (h, w))).astype(np.float32)
    kw = dict(cs_lambda_pixels=2.0, cs_tau_p_ms=tau_p_ms, csdvs_solver=solver)
    for dt in (1e-4, 3e-3, 1.0):
        want = np.asarray(jax_update_csdvs(JaxConfig(**kw), jnp.asarray(lp),
                                           jnp.asarray(surround), jnp.float32(dt)))
        got = core._update_csdvs(EmulatorConfig(**kw), torch.from_numpy(lp),
                                 torch.from_numpy(surround),
                                 torch.tensor(dt, dtype=torch.float32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol, err_msg=f"dt={dt}")


ALL_STATES = tuple(MODEL_STATES)
PER_FRAME = {
    "csdvs": (dict(NOISY, cs_lambda_pixels=2.0, cs_tau_p_ms=3.0, cutoff_hz=300.0), None),
    "csdvs_euler": (dict(NOISY, cs_lambda_pixels=2.0, cs_tau_p_ms=3.0,
                         csdvs_solver="euler"), None),
    "scidvs": (dict(NOISY, scidvs=True), None),
    "photoreceptor_noise": (dict(sigma_thres=0.03, leak_rate_hz=0.0, shot_noise_rate_hz=5.0,
                                 photoreceptor_noise=True, cutoff_hz=300.0,
                                 refractory_period_s=0.0), 0.05),
}


@pytest.mark.parametrize("case", list(PER_FRAME))
def test_per_frame_path_matches_emulator_step(case):
    kw, vrms = PER_FRAME[case]
    kw = dict(kw, probe=(17, 9), emit_states=ALL_STATES)
    frames, jcfg, params, state, cfg, tparams, tstate = start(kw, seed=2, vrms=vrms)
    times = (np.arange(1, F + 1) / 1500.0).astype(np.float32)
    new, to = port_chunk(cfg, tparams, tstate, frames[1:F + 1], times, state)
    jstate, jo = emulate_chunk(jcfg, params, state, jnp.asarray(frames[1:F + 1]),
                               jnp.asarray(times))
    assert int(np.abs(np.asarray(jo["ev_count"])).sum()) > 5000
    assert_counts_close(to, jo)
    np.testing.assert_array_equal(to["t_frame"].numpy(), np.asarray(jo["t_frame"]))
    np.testing.assert_array_equal(to["t_prev"].numpy(), np.asarray(jo["t_prev"]))
    assert to["probe"].shape == (F, 9)
    np.testing.assert_allclose(to["probe"].numpy(), np.asarray(jo["probe"]), rtol=0,
                               atol=ATOL_STATES)
    assert set(to["states"]) == set(jo["states"])
    for name, stack in to["states"].items():
        assert stack.shape == (F, H, W), name
        np.testing.assert_allclose(stack.numpy(), np.asarray(jo["states"][name]),
                                   rtol=0, atol=ATOL_STATES, err_msg=name)
    for name in ("base_log_frame", "lp_log_frame", "cs_surround_frame", "scidvs_highpass"):
        if getattr(jstate, name) is not None:
            np.testing.assert_allclose(getattr(new, name).numpy(),
                                       np.asarray(getattr(jstate, name)),
                                       rtol=0, atol=ATOL_STATES, err_msg=name)


def test_model_state_names_match():
    assert MODEL_STATES == JAX_MODEL_STATES


@pytest.mark.parametrize("kw,kernels", [
    (dict(NOISY, scidvs=True), False),
    (dict(CLEAN, scidvs=True), False),
    (dict(NOISY, cs_lambda_pixels=2.0), False),
    (dict(CLEAN, probe=(3, 4)), False),
    (dict(NOISY, emit_states=("diff_frame",)), False),
    (NOISY, True),
    (CLEAN, True),
], ids=["scidvs_refractory", "scidvs", "csdvs", "probe", "states", "fast_refractory",
        "fast_clean"])
def test_dispatch_to_the_scan_kernels(monkeypatch, kw, kernels):
    """Under SciDVS and on the per-frame path neither K1 nor K2 (nor their
    plain versions) is called; the fast path without variants calls one."""
    calls = []
    for mod, name in ((core, "scan"), (core, "refractory_scan"),
                      (emulator_scan, "scan_plain"), (emulator_scan, "refractory_scan_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    frames, _, _, state, cfg, tparams, tstate = start(kw, seed=3)
    times = (np.arange(1, 5) / 1500.0).astype(np.float32)
    port_chunk(cfg, tparams, tstate, frames[1:5], times, state)
    want = "refractory_scan" if kw["refractory_period_s"] > 0 else "scan"
    assert calls == ([want, want + "_plain"] if kernels else [])
