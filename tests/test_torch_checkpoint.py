"""Checkpoint and resume of the port's EventEmulator (CPU).

* save after a chunk, load into a new emulator and convert the next chunk:
  the events, counters and state equal the continuous run's bit for bit
  (the generator's and the event shuffle's states travel in the
  checkpoint, so the noise draws and the event order do too), with the
  refractory filter on, with the SciDVS pixel, and across a per-frame
  (CSDVS + probe) run, each with leak and shot noise;
* save_state before the first frame and load_state into an emulator that
  has converted frames raise;
* the single-frame API and reset: frame by frame equals one chunk (a
  deterministic pixel: the generator's draws depend on the chunking), and
  after reset the emulator starts again from the next frame;
* a checkpoint written by v2e_tpu loads into the port: its parameters and
  state equal from_jax_emulator's on the same arrays, and the host counters
  are v2e_tpu's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_emulator import fields
from v2e_tpu.emulator import EventEmulator as JaxEmulator
from v2e_tpu_torch.emulator import EventEmulator
from v2e_tpu_torch.emulator.state import from_jax_emulator

H, W = 30, 44


def frames(n, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    tex = 100 + 50 * np.sin(xx / 4.0) * np.cos(yy / 6.0)
    fr = np.stack([np.where(np.abs((xx - 2 * i) % W - 15) < 3, tex + 90, tex)
                   + rng.normal(0, 2, (H, W)) for i in range(n)])
    return np.clip(fr, 0, 255).round().astype(np.float32)


NOISE = dict(sigma_thres=0.03, leak_rate_hz=2.0, shot_noise_rate_hz=10.0,
             refractory_period_s=5e-4, seed=7, shuffle_events_within_iteration=True)
CASES = {
    "refractory": NOISE,
    "scidvs": dict(NOISE, scidvs=True),
    "csdvs_probe": dict(NOISE, cs_lambda_pixels=2.0, cs_tau_p_ms=3.0,
                        record_single_pixel_states=(5, 7)),
}


def make(tmp_path, name, kw):
    return EventEmulator(device="cpu", output_folder=str(tmp_path / name), **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_resume_equals_continuous_run(tmp_path, case):
    kw = CASES[case]
    fr = frames(33)
    t = np.arange(33) / 1000.0
    ckpt = str(tmp_path / "emu.npz")

    cont = make(tmp_path, "cont", kw)
    cont.generate_events_batch(fr[:17], t[:17])
    cont.save_state(ckpt)
    want = cont.generate_events_batch(fr[17:], t[17:])

    resumed = make(tmp_path, "resumed", kw)
    resumed.load_state(ckpt)
    assert resumed.frame_counter == 17
    got = resumed.generate_events_batch(fr[17:], t[17:])
    assert want is not None and len(want) > 500
    np.testing.assert_array_equal(got, want)
    for name in ("num_events_on", "num_events_off", "frame_counter", "t_previous", "t_origin"):
        assert getattr(resumed, name) == getattr(cont, name), name
    for obj in ("params", "state"):
        a, b = getattr(resumed, obj), getattr(cont, obj)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert torch.equal(x, y), f.name
    if "record_single_pixel_states" in kw:
        assert resumed.single_pixel_sample_count == 16


def test_save_before_first_frame_and_load_into_used_emulator_raise(tmp_path):
    em = make(tmp_path, "a", NOISE)
    with pytest.raises(RuntimeError, match="no state to save"):
        em.save_state(str(tmp_path / "x.npz"))
    em.generate_events_batch(frames(3), np.arange(3) / 1000.0)
    em.save_state(str(tmp_path / "x.npz"))
    with pytest.raises(RuntimeError, match="fresh emulator"):
        em.load_state(str(tmp_path / "x.npz"))


@pytest.mark.parametrize("variant", [{}, dict(scidvs=True), dict(cs_lambda_pixels=2.0)],
                         ids=["plain", "scidvs", "csdvs"])
def test_loads_a_v2e_tpu_checkpoint(tmp_path, caplog, variant):
    kw = dict(NOISE, **variant)
    jem = JaxEmulator(**kw)
    jem.generate_events_batch(frames(9), np.arange(9) / 1000.0)
    ckpt = str(tmp_path / "jax.npz")
    jem.save_state(ckpt)

    em = EventEmulator(device="cpu", **kw)
    caplog.set_level("INFO")
    em.load_state(ckpt)
    assert "written by v2e_tpu" in caplog.text
    params, state = from_jax_emulator(fields(jem.params), fields(jem.state), "cpu")
    for got, want in ((em.params, params), (em.state, state)):
        for f in dataclasses.fields(got):
            x, y = getattr(got, f.name), getattr(want, f.name)
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert torch.equal(x, y), f.name
    assert (em.frame_counter, em.t_previous, em.t_origin) == (
        jem.frame_counter, jem.t_previous, jem.t_origin)
    assert (em.num_events_on, em.num_events_off) == (jem.num_events_on, jem.num_events_off)
    # the conversion goes on from the loaded state, with the port's noise draws
    assert em.generate_events_batch(frames(5, seed=1), (9 + np.arange(5)) / 1000.0) is not None


@pytest.mark.parametrize("variant", [{}, dict(scidvs=True), dict(cs_lambda_pixels=2.0)],
                         ids=["plain", "scidvs", "csdvs"])
def test_single_frame_api_and_reset(variant):
    """No noise, so the generator's draws are the parameter maps alone and
    both emulators' generators stay in step, reset included."""
    kw = dict(sigma_thres=0.03, leak_rate_hz=0.0, shot_noise_rate_hz=0.0,
              refractory_period_s=5e-4, seed=4, shuffle_events_within_iteration=False,
              **variant)
    fr, t = frames(9), np.arange(9) / 1000.0
    batch = EventEmulator(device="cpu", **kw)
    single = EventEmulator(device="cpu", **kw)
    for _ in range(2):  # the second round after reset, from new parameter maps
        want = batch.generate_events_batch(fr, t)
        assert single.generate_events(fr[0], t[0]) is None  # initializes
        got = [single.generate_events(fr[i], t[i]) for i in range(1, 9)]
        np.testing.assert_array_equal(np.concatenate([g for g in got if g is not None]), want)
        assert single.num_events_total == batch.num_events_total == len(want) > 100
        for em in (batch, single):
            em.reset()
            assert em.state is None and em.num_events_total == em.frame_counter == 0
