"""Pixel strips and pad rows of the port (v2e_tpu_torch.parallel.mesh,
EmulatorConfig.pad_rows) against the JAX package on the CPU.

* K1 on strips: `refractory_scan_strips_plain` (each strip's count, the
  strips' maximum, each strip's apply, per frame) on 1, 2, 3 and 8 strips
  equals `refractory_scan_plain` on the whole plane bit for bit; the
  kernel's launch plan (`strips_plan`); a chunk on strips asks for K1 once
  per strip (one STRIPS request each);
* `emulate_chunk_sharded` on 2, 3 and 8 strips of the CPU equals
  v2e_tpu's `emulate_chunk_sharded` on its 8-device CPU mesh, event for
  event (cutoff 0; the port is handed the JAX run's draws), with the
  refractory filter (K1 on strips), without it (K2) and at H = 30 padded
  to 32;
* SciDVS, CSDVS (exact and Euler), the probe and the state frames on
  strips equal the port's single-device run bit for bit, and a mesh of
  one strip gives K1's own result; except the SciDVS highpass, within
  1e-6 (test_torch_variants.py's SciDVS tolerance): PyTorch's CPU sinh
  rounds the tail of a vectorized loop differently from its body, so the
  same element can differ by an ulp between a strip and the whole plane
  (on the card each element is computed alike; the GPU tests hold it
  bit for bit);
* a padded run equals the unpadded one event for event (with and without
  photoreceptor noise), and the padded state equals v2e_tpu's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_emulator import fields, jax_draws
from v2e_tpu.emulator.config import EmulatorConfig as JaxConfig
from v2e_tpu.emulator.state import init_state as jax_init_state
from v2e_tpu.parallel import emulate_chunk_sharded as jax_sharded
from v2e_tpu.parallel import make_mesh as jax_make_mesh
from v2e_tpu_torch import tracing
from v2e_tpu_torch.emulator import EventEmulator
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import (
    STRIPS,
    chunk_program,
    draw_chunk_noise,
    emulate_chunk_apply,
    run_local,
)
from v2e_tpu_torch.emulator.state import from_jax_emulator, init_state
from v2e_tpu_torch.ops.kernels.emulator_scan import (
    StripGrid,
    refractory_scan_plain,
    refractory_scan_strips,
    strips_plan,
)
from v2e_tpu_torch.parallel import emulate_chunk_sharded, make_mesh, shard_emulator_args
from v2e_tpu_torch.parallel.mesh import Mesh, strip_bounds

CPU = torch.device("cpu")


def strips(n):
    return Mesh([[CPU] * n], ("data", "spatial"))


def moving_frames(F, H, W, seed=0):
    """Frames [F+1,H,W] of a textured scene drifting and flickering."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = np.stack([
        110 + 80 * np.sin((xx + 1.7 * f) / 5.0) * np.cos((yy - 0.9 * f) / 4.0)
        + rng.normal(0, 4, (H, W)) for f in range(F + 1)])
    return np.round(np.clip(frames, 0, 255)).astype(np.float32)


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_strips_plain_equals_refractory_scan_plain(S):
    """K1 on S row strips of a 21x17 plane (the plain version, as the
    wrapper takes it for CPU tensors) equals K1's plain version on the
    whole plane: base, memory, counts, i0 and K bit for bit, the filter
    acting."""
    rng = np.random.default_rng(3)
    F, H, W, R = 10, 21, 17, 0.0005
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    lp = t(4.6 + 0.4 * rng.normal(size=(F, H, W)))
    leak = t(1e-3 * rng.uniform(size=(F, H, W)))
    shot = torch.from_numpy((rng.uniform(size=(F, H, W)) < 0.02).astype(np.uint8))
    pos, neg = t(0.2 + 0.03 * rng.uniform(size=(H, W))), t(0.2 + 0.03 * rng.uniform(size=(H, W)))
    base, mem = lp[0].clone(), torch.full((H, W), -R)
    dts = torch.full((F,), 1 / 3000.0)
    t_prevs = torch.cumsum(dts, 0) - dts
    args = (lp, leak, shot, pos, neg, base, mem, dts, t_prevs, R)
    want = refractory_scan_plain(*args)
    rows = lambda x, a, b: x[..., a:b, :].clone(memory_format=torch.contiguous_format)
    strips = [tuple(rows(x, a, b) for x in args[:7]) + (dts, t_prevs, R)
              for a, b in strip_bounds(H, S)]
    before = [x.clone() for x in strips[0][:7]]
    got = refractory_scan_strips(strips)
    assert len(got) == S and tracing.counters().get("launch.k1_strips", 0) == 0
    for s, (a, b) in enumerate(strip_bounds(H, S)):
        assert torch.equal(got[s][4], want[4]), (s, "K")
        for name, g, w in zip(("base", "mem", "counts", "i0"), got[s], want):
            assert torch.equal(g, w[..., a:b, :]), (s, name)
    assert all(torch.equal(x, y) for x, y in zip(before, strips[0][:7]))  # inputs kept
    assert want[3].any() and int(want[2].abs().sum()) > 100  # the filter acted


def test_strips_refuse_unequal_frames():
    F, h, W = 4, 3, 5
    strip = lambda F, R: (torch.zeros(F, h, W), None, None, torch.ones(h, W),
                          torch.ones(h, W), torch.zeros(h, W), torch.zeros(h, W),
                          torch.ones(F), torch.zeros(F), R)
    for other in (strip(F + 1, 0.001), strip(F, 0.002)):
        with pytest.raises(ValueError, match="strip 1"):
            refractory_scan_strips([strip(F, 0.001), other])


def fake_occupancy(device, regs, threads):
    """An H100-like occupancy: 64 registers a thread in the register form,
    32 in the global form, 65,536 registers and 2,048 threads an SM."""
    return min(2048 // threads, 65536 // (threads * (64 if regs else 32)))


@pytest.mark.parametrize("npixs,devices", [
    ((260 * 346,), (0,)),                            # one strip: K1's grid
    ((87 * 346, 87 * 346, 86 * 346), (0, 0, 0)),     # run B's plane in 3 strips of one card
    ((33 * 346,) * 8, (0,) * 8),                     # 8 strips of one card
    ((180 * 1280,) * 4, (0, 0, 0, 0)),               # 720x1280 in 4: the global form
    ((180 * 1280,) * 4, (0, 1, 2, 3)),               # one strip per card
    ((87 * 346,) * 3, (0, 0, 1)),                    # two strips on one card, one on another
    ((5,) * 3, (0, 0, 0)),                           # tiny strips
])
def test_strips_plan_grids_fit_together(npixs, devices):
    """The strips of a device fit on it together: in the register form one
    pixel per thread, at most one block per SM of the device in all; in the
    global form at most occupancy x SMs blocks; a strip alone on its device
    gets K1's grid (blocks = SMs, or occupancy x SMs)."""
    sms = {d: 132 for d in devices}
    grids = strips_plan(npixs, devices, sms, fake_occupancy)
    assert len(grids) == len(npixs)
    for d in set(devices):
        mine = [(p, g) for p, g, e in zip(npixs, grids, devices) if e == d]
        for p, g in mine:
            assert 1 <= g.blocks <= 512 and 32 <= g.threads <= 1024 and g.threads % 32 == 0
            assert fake_occupancy(d, g.regs, g.threads) >= 1
            if g.regs:
                assert g.threads - 32 < -(-p // g.blocks) <= g.threads
        if all(g.regs for _, g in mine):
            assert sum(g.blocks for _, g in mine) <= sms[d]
        else:
            assert not any(g.regs for _, g in mine)
            assert sum(g.blocks for _, g in mine) <= fake_occupancy(d, False, 1024) * sms[d]
        if len(mine) == 1:
            (p, g), = mine
            assert g.blocks == (min(-(-p // 32), 132) if g.regs
                                else fake_occupancy(d, False, 1024) * 132)
    if npixs == (87 * 346, 87 * 346, 86 * 346):
        assert grids[0] == StripGrid(44, 704, True)


def test_strips_plan_refuses_what_cannot_be_resident():
    """More strips on a device than it has SMs, or a block no SM holds,
    raise; so do no strips, more than 32, and an empty strip."""
    with pytest.raises(ValueError, match="one block per strip"):
        strips_plan((100,) * 5, (0,) * 5, {0: 4}, fake_occupancy)
    with pytest.raises(ValueError, match="does not fit"):
        strips_plan((1000,), (0,), {0: 132}, lambda d, r, t: 0)
    for npixs in ((), (10,) * 33, (10, 0)):
        with pytest.raises(ValueError):
            strips_plan(npixs, (0,) * len(npixs), {0: 132}, fake_occupancy)


@pytest.mark.parametrize("S", [1, 3])
def test_chunk_on_strips_requests_k1_once_per_strip(S):
    """Under R > 0 the chunk program of each strip yields exactly one
    request, a STRIPS request carrying its rows' arguments; answered
    together, the programs end with K1's result on the whole plane, and
    `run_local` answers the request of a lone strip alike."""
    F, H, W = 5, 12, 10
    cfg = EmulatorConfig(leak_rate_hz=5.0, refractory_period_s=0.0005,
                         shot_noise_rate_hz=20.0)
    frames = torch.from_numpy(moving_frames(F, H, W, seed=4))
    times = torch.arange(1, F + 1, dtype=torch.float32) / 1500.0
    gen = torch.Generator().manual_seed(5)
    params, state = init_state(cfg, frames[0], 0.0, gen)
    draws = draw_chunk_noise(cfg, F, (H, W), gen, CPU)
    pieces = shard_emulator_args(strips(S), params, state, frames[1:], times, draws)
    programs = [chunk_program(cfg, *piece, row0=a, split=True)
                for (a, _), piece in zip(strip_bounds(H, S), pieces)]
    requests = [p.send(None) for p in programs]
    assert [r[0] for r in requests] == [STRIPS] * S
    assert [tuple(r[1][0].shape) for r in requests] == [(F, b - a, W)
                                                       for a, b in strip_bounds(H, S)]
    results = []
    for program, answer in zip(programs, refractory_scan_strips([r[1] for r in requests])):
        with pytest.raises(StopIteration) as stop:
            program.send(answer)
        results.append(stop.value.value)
    _, want = emulate_chunk_apply(cfg, params, state, frames[1:], times, draws)
    got = torch.cat([r[1]["ev_count"] for r in results], dim=1)
    assert torch.equal(got, want["ev_count"]) and int(got.abs().sum()) > 20
    assert all(torch.equal(r[1]["K"], want["K"]) for r in results)
    # run_local answers a lone strip's request the same way
    _, alone = run_local(cfg, chunk_program(cfg, params, state, frames[1:], times, draws,
                                            split=True))
    assert all(torch.equal(alone[k], want[k]) for k in ("ev_count", "i0", "K"))


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh(8)


@pytest.mark.parametrize("refractory,H,pad", [(0.0005, 16, 0), (0.0, 16, 0), (0.0005, 30, 2)],
                         ids=["k1_strips", "k2", "h30_padded"])
def test_strips_equal_v2e_tpu_sharded(jax_mesh, refractory, H, pad):
    F, W = 8, 24
    kw = dict(sigma_thres=0.03, leak_rate_hz=5.0, leak_jitter_fraction=0.1,
              shot_noise_rate_hz=20.0, cutoff_hz=0.0, refractory_period_s=refractory,
              pad_rows=pad)
    frames = moving_frames(F, H, W)
    padded = np.pad(frames, ((0, 0), (0, pad), (0, 0)))
    times = (np.arange(1, F + 1) / 1500.0).astype(np.float32)
    jcfg = JaxConfig(use_pallas_scan=False, **kw)
    params, state = jax_init_state(jcfg, jnp.asarray(frames[0]), jnp.float32(0.0),
                                   jax.random.key(4))
    _, jo = jax_sharded(jcfg, jax_mesh, params, state, jnp.asarray(padded[1:]),
                        jnp.asarray(times))
    tparams, tstate = from_jax_emulator(fields(params), fields(state), "cpu")
    draws = {k: torch.from_numpy(v) for k, v in jax_draws(state, F, (H + pad, W)).items()}
    assert int(np.abs(np.asarray(jo["ev_count"])).sum()) > 300
    for S in (2, 3, 8):
        _, to = emulate_chunk_sharded(EmulatorConfig(**kw), strips(S), tparams, tstate,
                                      torch.from_numpy(padded[1:]), torch.from_numpy(times),
                                      draws=draws)
        for k in ("ev_count", "i0", "stride", "K", "shot_on", "shot_off", "num_on", "num_off"):
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=f"{S} {k}")
    if refractory:
        assert np.asarray(jo["i0"]).any()


VARIANTS = {
    "scidvs": dict(scidvs=True, refractory_period_s=0.0005),
    "csdvs": dict(cs_lambda_pixels=2.0, cs_tau_p_ms=3.0, refractory_period_s=0.0005),
    "csdvs_euler": dict(cs_lambda_pixels=2.0, cs_tau_p_ms=3.0, csdvs_solver="euler"),
    "probe_states": dict(probe=(5, 13), emit_states=("base_log_frame", "diff_frame"),
                         refractory_period_s=0.0005, photoreceptor_noise=True,
                         shot_noise_rate_hz=5.0, cutoff_hz=200.0),
    "k1_one_strip": dict(refractory_period_s=0.0005, shot_noise_rate_hz=20.0),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_strips_equal_single_device(name):
    """Every path on 1 to 3 strips equals the port's run on the whole plane
    (one strip: K1 on strips against K1)."""
    F, H, W = 6, 16, 20
    cfg = EmulatorConfig(leak_rate_hz=5.0, **VARIANTS[name])
    frames = torch.from_numpy(moving_frames(F, H, W, seed=1))
    times = torch.arange(1, F + 1, dtype=torch.float32) / 1500.0
    gen = torch.Generator().manual_seed(2)
    params, state = init_state(cfg, frames[0], 0.0, gen)
    if cfg.photoreceptor_noise:
        params = dataclasses.replace(params, photoreceptor_noise_vrms=torch.tensor(0.05))
    draws = draw_chunk_noise(cfg, F, (H, W), gen, CPU)
    s1, o1 = emulate_chunk_apply(cfg, params, state, frames[1:], times, draws)
    for S in ((1,) if name == "k1_one_strip" else (2, 3)):
        s2, o2 = emulate_chunk_sharded(cfg, strips(S), params, state, frames[1:], times,
                                       draws=draws)
        assert o1.keys() == o2.keys()
        for k in o1:
            pairs = ([(o1[k][n], o2[k][n]) for n in o1[k]] if k == "states"
                     else [(o1[k], o2[k])])
            for a, b in pairs:
                assert torch.equal(a, b), (S, k)
        for f in dataclasses.fields(s1):
            a, b = getattr(s1, f.name), getattr(s2, f.name)
            if f.name == "scidvs_highpass" and a is not None:
                torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
            else:
                assert (a is None and b is None) or torch.equal(a, b), (S, f.name)
    assert int(o1["ev_count"].abs().sum()) > 100


def _stream(H, W, pad_rows, mesh=None, **extra):
    rng = np.random.default_rng(13)
    frames = np.clip(128 * np.exp(rng.normal(0, 0.25, (8, H, W))), 0, 255).astype(np.float32)
    em = EventEmulator(sigma_thres=0.03, leak_rate_hz=1.0, shot_noise_rate_hz=2.0,
                       cutoff_hz=50.0, seed=9, shuffle_events_within_iteration=False,
                       pad_rows=pad_rows, mesh=mesh, device="cpu", **extra)
    return em.generate_events_batch(frames, np.arange(8) * 0.01)


@pytest.mark.parametrize("H,W,pad,extra", [
    (13, 24, 3, {}),
    (10, 16, 6, {"photoreceptor_noise": True}),
    (30, 16, 2, {"mesh": make_mesh(8, device="cpu")}),
], ids=["noise", "photoreceptor_noise", "strips"])
def test_padded_run_equals_unpadded(H, W, pad, extra):
    """As tests/test_parallel.py::TestPadRows: pad rows change nothing about
    the logical pixels (30 rows padded to 32 over make_mesh(8)'s 4 strips)."""
    mesh = extra.pop("mesh", None)
    ev0 = _stream(H, W, 0, **extra)
    ev1 = _stream(H, W, pad, mesh, **extra)
    np.testing.assert_array_equal(ev0, ev1)
    assert len(ev0) > 50 and ev0[:, 2].max() < H


def test_padded_state_equals_v2e_tpu():
    """With the draws switched off (no mismatch, no rate spread, a fixed
    SciDVS tau) the padded parameters and state are v2e_tpu's: the pad
    rows exactly, the logical rows within 1e-6 relative (XLA's CPU log is
    an ulp off the correctly rounded one at some levels,
    test_torch_ops.py)."""
    kw = dict(sigma_thres=0.0, noise_rate_cov_decades=0.0, scidvs=True, scidvs_tau_cov=0.0,
              refractory_period_s=0.0005, pad_rows=3)
    frame = moving_frames(0, 13, 24)[0]
    jp, js = jax_init_state(JaxConfig(**kw), jnp.asarray(frame), jnp.float32(0.25),
                            jax.random.key(0))
    tp, ts = init_state(EmulatorConfig(**kw), torch.from_numpy(frame), 0.25,
                        torch.Generator())
    for obj, ref in ((tp, fields(jp)), (ts, fields(js))):
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if value is not None:
                assert value.shape == ref[f.name].shape, f.name
                np.testing.assert_allclose(value.numpy(), ref[f.name], rtol=1e-6, atol=0,
                                           err_msg=f.name)
                if value.ndim == 2:
                    np.testing.assert_array_equal(value[13:].numpy(), ref[f.name][13:])
    assert ts.base_log_frame.shape == (16, 24) and float(tp.pos_thres[13:].min()) == 1e9


def test_csdvs_refuses_pad_rows():
    with pytest.raises(ValueError, match="center-surround"):
        EventEmulator(pad_rows=2, cs_lambda_pixels=1.5, cs_tau_p_ms=1.0, device="cpu")
