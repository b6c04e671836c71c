"""Each cell's check at a small size on the CPU: a sound run is correct;
a run with the timed path broken underneath (the harness's look for a
card skipped) is not, for each fault the cell can have; and the control,
the reference one precision lower in the program's place, reads above the
cell's limits."""
import numpy as np
import pytest

from portbench import bench, controls

CONVERT = ["dvs346_slomo_u10", "dvs346_noisy_u12"]
TRAIN = "train_b8_step_bound"


def small(name):
    """The cell at 240x180 (base 8; U=2 and 2 pairs a chunk), with its own
    limits."""
    cell = bench.cell_file(name)
    cfg = bench.config_file(cell["config"])
    if cell["runner"] == "train":
        cfg.update(base=8, batch_size=2, crop=[64, 96])
        cell["clips"] = {"count": 2, "frames": 8, "size": [72, 128]}
        return cell, cfg
    cfg.update(width=240, height=180, base=8, batch_pairs=2)
    cell.update(upsampling=2)
    cell["check"].update(check_every=1, frame_chunks=1)
    return cell, cfg


def run_small(name, seconds=5.0):
    cell, cfg = small(name)
    return bench.run_cell(name, 2 ** 33 + 5, seconds, False, "cpu", cell=cell, config=cfg)


def state_unchanged(monkeypatch):
    """The emulator returns its state unchanged after every chunk."""
    import v2e_tpu_torch.emulator.emulator as em_mod
    import v2e_tpu_torch.fused as fused_mod

    orig = em_mod.emulate_and_compact_impl

    def broken(cfg, params, state, *a, **k):
        _, outs, packed = orig(cfg, params, state, *a, **k)
        return state, outs, packed

    monkeypatch.setattr(em_mod, "emulate_and_compact_impl", broken)
    monkeypatch.setattr(fused_mod, "emulate_and_compact_impl", broken)


def half_chunk(monkeypatch):
    """Half of each chunk's frames left out: their events dropped."""
    import v2e_tpu_torch.emulator.emulator as em_mod
    import v2e_tpu_torch.fused as fused_mod
    from v2e_tpu_torch.emulator.core import emulate_chunk_apply, pack_chunk

    def broken(cfg, params, state, frames, times, capacity, draws):
        state, outs = emulate_chunk_apply(cfg, params, state, frames, times, draws)
        half = frames.shape[0] // 2
        for k in ("ev_count", "shot_on", "shot_off"):
            if k in outs:
                outs[k][half:] = 0
        return state, outs, pack_chunk(cfg, outs, capacity)

    monkeypatch.setattr(em_mod, "emulate_and_compact_impl", broken)
    monkeypatch.setattr(fused_mod, "emulate_and_compact_impl", broken)


def events_altered(monkeypatch):
    """Every tenth event's polarity flipped where the host makes them."""
    import v2e_tpu_torch.emulator.emulator as em_mod

    orig = em_mod.materialize_events_sparse

    def broken(*a, **k):
        events, labels, offsets = orig(*a, **k)
        events[::10, 3] *= -1
        return events, labels, offsets

    monkeypatch.setattr(em_mod, "materialize_events_sparse", broken)


@pytest.mark.parametrize("name", CONVERT)
def test_sound_conversion_is_correct(name):
    run = run_small(name)
    assert run.correct, run.checks


@pytest.mark.parametrize("fault", [state_unchanged, half_chunk, events_altered])
@pytest.mark.parametrize("name", CONVERT)
def test_conversion_fault_is_caught(name, fault, monkeypatch):
    fault(monkeypatch)
    run = run_small(name)
    assert not run.correct, run.checks


@pytest.mark.parametrize("name", CONVERT)
def test_conversion_control_fails(name):
    cell, cfg = small(name)
    got = controls.readings(name, 5, "cpu", cell, cfg)["control"]
    limits = cell["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def step_unchanged(monkeypatch):
    """The optimizer's step leaves the parameters as they were."""
    import torch

    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(monkeypatch):
    """The loss's mean taken over half of the batch."""
    import v2e_tpu_torch.models.train as train_mod

    orig = train_mod.slomo_loss

    def broken(flow_net, interp_net, I0, I1, It, t):
        h = I0.shape[0] // 2
        return orig(flow_net, interp_net, I0[:h], I1[:h], It[:h], t[:h])

    monkeypatch.setattr(train_mod, "slomo_loss", broken)


def target_altered(monkeypatch):
    """The sampler hands the first sample's first frame as its target."""
    from v2e_tpu_torch.dataset_tools.train_slomo import TripletSampler

    orig = TripletSampler.sample_batch

    def broken(self, batch_size):
        b = orig(self, batch_size)
        b["It"][0] = b["I0"][0]
        return b

    monkeypatch.setattr(TripletSampler, "sample_batch", broken)


def test_sound_training_is_correct():
    run = run_small(TRAIN)
    assert run.correct, run.checks


@pytest.mark.parametrize("fault", [step_unchanged, half_batch, target_altered])
def test_training_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    run = run_small(TRAIN)
    assert not run.correct, run.checks


def test_training_control_fails():
    cell, cfg = small(TRAIN)
    got = controls.readings(TRAIN, 5, "cpu", cell, cfg)["control"]
    limits = cell["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got
    assert np.isfinite(list(got.values())).all()
