"""Time segments of the port (v2e_tpu_torch.parallel.convert) on the CPU.

* `emulate_chunk_segmented` over two chunks equals v2e_tpu's, every
  output bit for bit (cutoff 0, refractory on: K1's plain version once per
  segment), the port fed the JAX run's draws at the same absolute frames:
  the second chunk's warm-up frames take the first chunk's last draws;
* the port's segmented run against its own continuous run: exact when
  the log intensities sit on the threshold grid, and otherwise within the
  bounds tests/test_parallel.py holds the JAX package to (at most one
  threshold crossing per pixel per seam and the totals within 2.5 % with
  the leak off; cells 95 % equal and totals within 12 % with it on);
* `EventEmulator(parallel_mode="segment")` over two chunks equals the
  plain emulator's stream (grid values), and refuses what the JAX facade
  refuses;
* `dryrun_segments(8)` runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_emulator import fields, jax_draws
from v2e_tpu.emulator.config import EmulatorConfig as JaxConfig
from v2e_tpu.emulator.state import init_state as jax_init_state
from v2e_tpu.parallel.convert import emulate_chunk_segmented as jax_segmented
from v2e_tpu_torch.emulator import EventEmulator
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import draw_chunk_noise, emulate_chunk_apply
from v2e_tpu_torch.emulator.state import from_jax_emulator, init_state
from v2e_tpu_torch.parallel.convert import (
    dryrun_segments,
    emulate_chunk_segmented,
    make_segment_mesh,
    shard_segment_inputs,
)

CPU = torch.device("cpu")


def drifting(F, H, W, seed, step):
    rng = np.random.default_rng(seed)
    base = 128 * np.exp(rng.normal(0, 0.3, (H, W)))
    drift = np.cumsum(rng.normal(0, step, (F + 1, 1, 1)), axis=0)
    return np.clip(base[None] * np.exp(drift), 0, 255).astype(np.float32)


def test_two_chunks_equal_v2e_tpu():
    F, H, W, S, warm = 30, 12, 16, 4, 2
    kw = dict(sigma_thres=0.03, leak_rate_hz=5.0, shot_noise_rate_hz=20.0, cutoff_hz=0.0,
              refractory_period_s=0.0005)
    frames = drifting(2 * F, H, W, seed=5, step=0.08)
    times = (np.arange(2 * F + 1) / 400.0).astype(np.float32)
    jcfg = JaxConfig(use_pallas_scan=False, **kw)
    seg = jax.jit(jax_segmented, static_argnums=(0, 7, 8))
    params, state = jax_init_state(jcfg, jnp.asarray(frames[0]), jnp.float32(0.0),
                                   jax.random.key(6))
    cfg = EmulatorConfig(**kw)
    tparams, tstate = from_jax_emulator(fields(params), fields(state), "cpu")
    tail_f = np.broadcast_to(frames[0], (warm + 1, H, W))
    tail_t = np.full(warm + 1, times[0], np.float32)
    tail_d = None
    events = 0
    for c in range(2):
        fr, tm = frames[1 + c * F: 1 + (c + 1) * F], times[1 + c * F: 1 + (c + 1) * F]
        new_state, jo = seg(jcfg, params, state, jnp.asarray(fr), jnp.asarray(tm),
                            jnp.asarray(tail_f), jnp.asarray(tail_t), S, warm)
        draws = {k: torch.from_numpy(v) for k, v in jax_draws(state, F, (H, W)).items()
                 if k != "photoreceptor"}
        tstate, to = emulate_chunk_segmented(
            cfg, tparams, tstate, torch.from_numpy(fr), torch.from_numpy(tm),
            torch.from_numpy(np.ascontiguousarray(tail_f)), torch.from_numpy(tail_t), S, warm,
            make_segment_mesh(S, "cpu"), draws, tail_d)
        for k in ("ev_count", "i0", "stride", "K", "shot_on", "shot_off", "num_on", "num_off",
                  "t_prev", "t_frame"):
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=f"{c} {k}")
        # a segment's seed takes lin_log of its frame, and XLA's CPU log is
        # an ulp off the correctly rounded one at some levels
        np.testing.assert_allclose(tstate.base_log_frame.numpy(),
                                   np.asarray(new_state.base_log_frame), rtol=0, atol=1e-6)
        events += int(np.abs(np.asarray(jo["ev_count"])).sum())
        state = new_state
        tail_f = np.concatenate([tail_f, fr])[-(warm + 1):]
        tail_t = np.concatenate([tail_t, tm])[-(warm + 1):]
        tail_d = {k: v[-warm:] for k, v in draws.items()}
    assert events > 500


def _own_runs(cfg, frames, times, S, warm, seed):
    gen = torch.Generator().manual_seed(seed)
    params, state = init_state(cfg, torch.from_numpy(frames[0]), 0.0, gen)
    F, H, W = frames[1:].shape
    draws = draw_chunk_noise(cfg, F, (H, W), gen, CPU)
    fr, tm = torch.from_numpy(frames[1:]), torch.from_numpy(times[1:])
    s1, o1 = emulate_chunk_apply(cfg, params, state, fr, tm, draws)
    s2, o2 = emulate_chunk_segmented(
        cfg, params, state, fr, tm, torch.from_numpy(frames[0]).expand(warm + 1, H, W),
        torch.zeros(warm + 1), S, warm, draws=draws)
    return (s1, o1), (s2, o2)


def test_exact_on_grid_values():
    """HDR log intensities on the 0.25 threshold grid: the base stays on
    the grid in both runs, so the seeding is exact (shot noise and the
    dt = 0 replays that pad 30 frames to 4 segments of 8 included)."""
    rng = np.random.default_rng(0)
    F, H, W = 30, 12, 16
    frames = (rng.integers(-8, 8, (F + 1, H, W)) * 0.25).astype(np.float32)
    times = np.arange(F + 1, dtype=np.float32) / 100.0
    cfg = EmulatorConfig(pos_thres=0.25, neg_thres=0.25, sigma_thres=0.0, cutoff_hz=0.0,
                         leak_rate_hz=0.0, shot_noise_rate_hz=5.0, hdr=True)
    (s1, o1), (s2, o2) = _own_runs(cfg, frames, times, 4, 2, seed=1)
    for k in o1:
        assert torch.equal(o1[k], o2[k]), k
    assert torch.equal(s1.base_log_frame, s2.base_log_frame)
    assert int(o1["ev_count"].abs().sum()) > 500 and bool(o1["shot_on"].any())


@pytest.mark.parametrize("F,seed,step,leak,cells,total", [
    (288, 11, 0.05, 0.0, None, 0.025),
    (64, 7, 0.04, 1.0, 0.95, 0.12),
], ids=["seam_bound", "leak"])
def test_within_the_seam_bound(F, seed, step, leak, cells, total):
    """tests/test_parallel.py's two seam tests, their scenes and bounds."""
    H, W, S = 24, 32, 4
    frames = drifting(F, H, W, seed, step)
    times = np.arange(F + 1, dtype=np.float32) / 100.0
    cfg = EmulatorConfig(sigma_thres=0.03, cutoff_hz=80.0, leak_rate_hz=leak,
                         shot_noise_rate_hz=2.0)
    (_, o1), (_, o2) = _own_runs(cfg, frames, times, S, 8, seed=4)
    a, b = o1["ev_count"].numpy().astype(np.int64), o2["ev_count"].numpy().astype(np.int64)
    if cells is None:
        assert np.abs(a.sum(0) - b.sum(0)).max() <= S - 1  # one crossing per seam
    else:
        assert np.mean(a == b) > cells
    n1, n2 = np.abs(a).sum(), np.abs(b).sum()
    assert n1 > 1000 and abs(int(n1) - int(n2)) <= max(total * n1, 20)


def _emulators(**extra):
    kw = dict(pos_thres=0.25, neg_thres=0.25, sigma_thres=0.0, cutoff_hz=0.0,
              leak_rate_hz=0.0, shot_noise_rate_hz=5.0, refractory_period_s=0.0, hdr=True,
              seed=11, shuffle_events_within_iteration=False, device="cpu")
    return (EventEmulator(**kw), EventEmulator(mesh=make_segment_mesh(8, "cpu"),
                                               parallel_mode="segment", **extra, **kw))


def test_facade_segment_mode_two_chunks():
    """As tests/test_parallel.py: the tail of frames (and here of draws)
    seeds the second chunk's segments from the first chunk's frames."""
    rng = np.random.default_rng(3)
    frames = (rng.integers(-8, 8, (32, 16, 24)) * 0.25).astype(np.float32)
    times = np.arange(32) * 0.01
    plain, seg = _emulators(segment_warmup=2)
    ev_p, ev_s = [], []
    for s in range(0, 32, 16):
        ev_p.append(plain.generate_events_batch(frames[s:s + 16], times[s:s + 16]))
        ev_s.append(seg.generate_events_batch(frames[s:s + 16], times[s:s + 16]))
    ev_p, ev_s = np.concatenate(ev_p), np.concatenate(ev_s)
    assert len(ev_p) > 500
    np.testing.assert_allclose(ev_p, ev_s, atol=1e-6)


@pytest.mark.parametrize("extra,match", [
    (dict(record_single_pixel_states=(1, 1)), "probe"),
    (dict(pad_rows=2), "pad_rows"),
], ids=["probe", "pad_rows"])
def test_facade_segment_mode_refuses(extra, match):
    with pytest.raises(ValueError, match=match):
        _emulators(**extra)


def test_dryrun_segments_and_inputs():
    assert dryrun_segments(8, "cpu") > 0
    frames = torch.zeros(4, 3, 5)
    copies = shard_segment_inputs(make_segment_mesh(3, "cpu"), frames, torch.zeros(4),
                                  frames[:2], torch.zeros(2))
    assert [list(c) for c in copies] == [[CPU]] * 4 and copies[0][CPU] is frames
