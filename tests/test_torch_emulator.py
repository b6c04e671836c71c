"""Port parity of the emulator chunk, compaction, event materialization and
the AEDAT-2/text sinks against the JAX package (CPU).

* the chunk: the port's apply step is handed the random draws the JAX fast
  path made (fold_in(key, step + f) -> split 3 -> normal / uniform), with
  leak jitter, shot noise, cutoff 0 and refractory on;
* the photoreceptor lowpass on its own (cutoff on): the JAX package solves
  the IIR with an associative scan and the port sequentially, so it is held
  at 1e-6 relative rather than bit for bit;
* a moving-dot conversion with the `clean` preset and refractory 0.5 ms
  through both `EventEmulator`s, the port holding the JAX run's thresholds
  (from_jax_emulator).

Tolerance: events event for event; AEDAT-2 payload byte-identical after the
header; base state within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2e_tpu.emulator import EventEmulator as JaxEmulator
from v2e_tpu.emulator.config import EmulatorConfig as JaxConfig
from v2e_tpu.emulator.core import emulate_and_compact
from v2e_tpu.emulator.events import materialize_events_sparse as jax_materialize
from v2e_tpu.emulator.state import init_state as jax_init_state
from v2e_tpu.synthetic.moving_dot import moving_dot
from v2e_tpu_torch.emulator import EventEmulator
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import emulate_and_compact_impl, unpack_scalars
from v2e_tpu_torch.emulator.events import materialize_events_sparse
from v2e_tpu_torch.emulator.state import from_jax_emulator

F, H, W = 24, 40, 56


def fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if getattr(obj, f.name) is not None
            and f.name != "key"}


def jax_draws(state, n, shape):
    """The draws of v2e_tpu's _emulate_chunk_fast, as numpy."""
    keys = jax.vmap(lambda i: jax.random.fold_in(state.key, state.step_idx + i))(
        jnp.arange(n))
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    normal = jax.vmap(lambda k: jax.random.normal(k, shape, dtype=jnp.float32))
    uniform = jax.vmap(lambda k: jax.random.uniform(k, shape, dtype=jnp.float32))
    return {"leak": np.array(normal(sub[:, 0])), "shot": np.array(uniform(sub[:, 1])),
            "photoreceptor": np.array(normal(sub[:, 2]))}


def chunk_inputs(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = np.stack([
        110 + 80 * np.sin((xx + 1.3 * f) / 6.0) * np.cos(yy / 5.0)
        + rng.normal(0, 3, (H, W)) for f in range(F + 1)
    ])
    frames = np.round(np.clip(frames, 0, 255)).astype(np.float32)
    times = (np.arange(1, F + 1) / 1500.0).astype(np.float32)
    return frames, times


def run_both(kw, capacity, seed=0):
    frames, times = chunk_inputs(seed)
    jcfg = JaxConfig(use_pallas_scan=False, **kw)
    params, state = jax_init_state(jcfg, jnp.asarray(frames[0]), jnp.float32(0.0),
                                   jax.random.key(seed))
    jstate, jouts, jpacked = emulate_and_compact(
        jcfg, params, state, jnp.asarray(frames[1:]), jnp.asarray(times), capacity)
    tparams, tstate = from_jax_emulator(fields(params), fields(state), "cpu")
    draws = {k: torch.from_numpy(v) for k, v in jax_draws(state, F, (H, W)).items()}
    tstate2, touts, tpacked = emulate_and_compact_impl(
        EmulatorConfig(**kw), tparams, tstate, torch.from_numpy(frames[1:]),
        torch.from_numpy(times), capacity, draws)
    return (jstate, jouts, jpacked), (tstate2, touts, tpacked)


NOISY = dict(sigma_thres=0.03, leak_rate_hz=5.0, leak_jitter_fraction=0.1,
             shot_noise_rate_hz=20.0, cutoff_hz=0.0, refractory_period_s=0.0005)


@pytest.mark.parametrize("capacity", [1 << 16, 512])
def test_chunk_and_compaction_match(capacity):
    (js, jo, jp), (ts, to, tp) = run_both(NOISY, capacity)
    for k in ("ev_count", "i0", "stride", "K", "shot_on", "shot_off", "num_on", "num_off"):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=k)
    assert int(np.abs(np.asarray(jo["ev_count"])).sum()) > 1000
    assert np.asarray(jo["shot_on"]).any() and np.asarray(jo["i0"]).any()
    np.testing.assert_array_equal(tp["scalars"].numpy(), np.asarray(jp["scalars"]))
    for k in ("idx", "count", "i0", "shot"):
        np.testing.assert_array_equal(tp["sparse"][k].numpy(),
                                      np.asarray(jp["sparse"][k]), err_msg=k)
    np.testing.assert_allclose(ts.base_log_frame.numpy(),
                               np.asarray(js.base_log_frame), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts.timestamp_mem.numpy(), np.asarray(js.timestamp_mem))


def test_lowpass_and_photoreceptor_noise_within_tolerance():
    kw = dict(sigma_thres=0.03, leak_rate_hz=0.0, shot_noise_rate_hz=5.0,
              photoreceptor_noise=True, cutoff_hz=300.0, refractory_period_s=0.0)
    (js, jo, _), (ts, to, _) = run_both(kw, 1 << 16)
    np.testing.assert_allclose(ts.lp_log_frame.numpy(), np.asarray(js.lp_log_frame),
                               rtol=1e-6)
    np.testing.assert_allclose(ts.photoreceptor_noise_arr.numpy(),
                               np.asarray(js.photoreceptor_noise_arr), rtol=1e-6, atol=1e-9)
    # a rounding-level difference may move an event at a threshold boundary
    jc, tc = np.asarray(jo["ev_count"]), to["ev_count"].numpy()
    assert np.abs(jc).sum() > 1000 and np.mean(jc == tc) > 0.999


@pytest.mark.parametrize("shuffle", [False, True])
def test_materialize_events_sparse(shuffle):
    (_, _, jp), _ = run_both(NOISY, 1 << 16, seed=3)
    sc = unpack_scalars(np.asarray(jp["scalars"]))
    n = sc["n_occ"]
    sp = {k: np.asarray(v)[:n] for k, v in jp["sparse"].items()}
    args = (sp["idx"], sp["count"], sp["i0"], sp["shot"], sc["stride"], sc["K"],
            sc["t_prev"], sc["t_frame"], H, W, 12.5)
    rng = (lambda: np.random.default_rng(7)) if shuffle else (lambda: None)
    want = jax_materialize(*args, rng=rng(), label_signal_noise=True)
    got = materialize_events_sparse(*args, rng=rng(), label_signal_noise=True)
    assert want[0].shape[0] > 1000
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def moving_dot_frames():
    src = moving_dot(346, 260, arg_list=["--t_total", "0.006", "--dt", "1e-4"])
    frames, times = [], []
    while True:
        fr, t = src.next_frame()
        if fr is None:
            break
        frames.append(fr)
        times.append(t)
    return np.stack(frames), np.asarray(times, dtype=np.float64)


def test_moving_dot_clean_conversion_aedat2_and_text(tmp_path):
    frames, times = moving_dot_frames()
    kw = dict(refractory_period_s=0.0005, seed=11, output_width=346, output_height=260,
              dvs_aedat2="ev.aedat", dvs_text="ev.txt")
    jem = JaxEmulator(output_folder=str(tmp_path / "jax"), **kw)
    tem = EventEmulator(output_folder=str(tmp_path / "port"), device="cpu", **kw)
    for em in (jem, tem):
        em.set_dvs_params("clean")
        em.cfg = dataclasses.replace(em.cfg, refractory_period_s=0.0005)
    jem.generate_events_batch(frames[:1], times[:1])
    tem.generate_events_batch(frames[:1], times[:1])
    tem.params, tem.state = from_jax_emulator(fields(jem.params), fields(jem.state), "cpu")
    n_events = 0
    for s in range(1, len(frames), 20):
        je = jem.generate_events_batch(frames[s:s + 20], times[s:s + 20])
        te = tem.generate_events_batch(frames[s:s + 20], times[s:s + 20])
        if je is None:
            assert te is None
            continue
        np.testing.assert_array_equal(te, je)
        n_events += len(je)
    jem.cleanup()
    tem.cleanup()
    assert n_events > 500

    def payload(path, text):
        data = open(path, "rb").read()
        lines = data.split(b"\n")
        if text:
            return b"\n".join(ln for ln in lines if not ln.startswith(b"#"))
        # AEDAT-2: header lines start with '#', end with CRLF
        off = 0
        while data[off:off + 1] == b"#":
            off = data.index(b"\r\n", off) + 2
        return data[off:]

    for name, text in (("ev.aedat", False), ("ev.txt", True)):
        jp = payload(tmp_path / "jax" / name, text)
        tp = payload(tmp_path / "port" / name, text)
        assert len(tp) > 1000 and tp == jp, name
