"""The port's library surface against v2e_tpu's: each package's __all__,
the embedding example, `materialize_events` / `materialize_frame` (the
dense per-frame path) against v2e_tpu's numpy path, and the checkpoint
conversion.
"""
import importlib

import numpy as np
import pytest
import torch

import v2e_tpu.emulator.events as jax_events
from v2e_tpu_torch.emulator import (
    EmulatorConfig,
    emulate_chunk,
    init_state,
    materialize_events,
)
from v2e_tpu_torch.emulator.events import materialize_frame, materialize_frame_numpy

# v2e_tpu names with no counterpart in the port, by design (ROADMAP.md,
# "No counterpart, by design")
BY_DESIGN = {
    ("models", "UNetSpec"): "the port's UNet is an nn.Module that carries its "
                            "layer spec (models/unet.py::UNet)",
    ("models", "init_unet"): "a UNet draws its own weights; seeded weights come "
                             "from init_random_slomo_params",
}
# names the port exports beyond v2e_tpu's
PORT_ONLY = {("", "resolve_device"), ("models", "UNet"), ("synthetic", "make_source_frames")}
PACKAGES = ["", "emulator", "models", "io", "ops", "utils", "render", "analysis",
            "synthetic", "parallel"]


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p or "root")
def test_all_matches_v2e_tpu(pkg):
    ref = importlib.import_module("v2e_tpu" + (f".{pkg}" if pkg else ""))
    port = importlib.import_module("v2e_tpu_torch" + (f".{pkg}" if pkg else ""))
    want = {n for n in ref.__all__ if (pkg, n) not in BY_DESIGN}
    have = {n for n in port.__all__ if (pkg, n) not in PORT_ONLY}
    assert have == want
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_root_imports_the_embedding_names():
    from v2e_tpu_torch import (  # noqa: F401
        EmulatorConfig, EventEmulator, EventRenderer, ExposureMode, SuperSloMo, __version__,
    )


def test_example_runs_on_the_cpu(capsys):
    from v2e_tpu_torch.examples import library_embedding

    assert library_embedding.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "frame 4:" in out and "chunk of 55 frames" in out
    total = int(out.split("totals: ")[1].split()[0])
    assert total > 0


@pytest.fixture(scope="module")
def chunk_outs():
    """A noisy chunk (shot noise on) of 6 frames of 24x32 through the port's
    public emulate_chunk, its outputs as numpy arrays."""
    cfg = EmulatorConfig(sigma_thres=0.0, cutoff_hz=0.0, leak_rate_hz=0.0,
                         shot_noise_rate_hz=30.0, refractory_period_s=0.0)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(np.clip(
        100 + np.cumsum(rng.normal(0, 25, (7, 24, 32)), axis=0), 0, 255).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    params, state = init_state(cfg, frames[0], 0.0, gen)
    times = torch.arange(1, 7, dtype=torch.float32) / 300.0
    _, outs = emulate_chunk(cfg, params, state, frames[1:], times, gen)
    return {k: v.numpy() for k, v in outs.items()}


@pytest.mark.parametrize("labels", [False, True], ids=["events", "labels"])
def test_materialize_events_matches_v2e_tpu_numpy(chunk_outs, monkeypatch, labels):
    assert "shot_on" in chunk_outs and int(np.abs(chunk_outs["ev_count"]).sum()) > 100
    ev, lab, off = materialize_events(chunk_outs, 2.5, label_signal_noise=labels)
    monkeypatch.setattr(jax_events, "get_lib", lambda: None)
    ev_j, lab_j, off_j = jax_events.materialize_events(chunk_outs, 2.5,
                                                       label_signal_noise=labels)
    np.testing.assert_array_equal(ev, ev_j)
    np.testing.assert_array_equal(off, off_j)
    if labels:
        np.testing.assert_array_equal(lab, lab_j)
        assert 0 < lab.sum() < lab.size


def test_materialize_frame_shuffled_numpy_matches_v2e_tpu(chunk_outs, monkeypatch):
    """With a generator the native and numpy paths shuffle differently (as
    in v2e_tpu): the numpy one equals v2e_tpu's numpy one draw for draw,
    and the native one holds the same events."""
    o = {k: v[2] for k, v in chunk_outs.items()}
    args = (o["ev_count"], o["i0"], int(o["stride"]), int(o["K"]), 2.5 + float(o["t_prev"]),
            2.5 + float(o["t_frame"]), o["shot_on"], o["shot_off"])
    ev_np, _ = materialize_frame_numpy(*args, np.random.default_rng(1))
    monkeypatch.setattr(jax_events, "get_lib", lambda: None)
    ev_j, _ = jax_events.materialize_frame(*args, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(ev_np, ev_j)
    ev_n, _ = materialize_frame(*args, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(np.sort(ev_n, axis=0), np.sort(ev_np, axis=0))
    assert np.all(np.diff(ev_n[:, 0]) >= 0)


def test_convert_torch_checkpoint_round_trip(tmp_path):
    from v2e_tpu_torch.models import (
        convert_torch_checkpoint,
        init_random_slomo_params,
        load_slomo_params,
    )

    flow, interp = init_random_slomo_params(seed=1, base=4)
    ckpt = {key: {f"{name}.{t}": torch.from_numpy(p[k]) for name, p in params.items()
                  for k, t in (("w", "weight"), ("b", "bias"))}
            for key, params in (("state_dictFC", flow), ("state_dictAT", interp))}
    torch.save(ckpt, tmp_path / "m.ckpt")
    out = convert_torch_checkpoint(str(tmp_path / "m.ckpt"), str(tmp_path / "m.npz"))
    for a, b in zip(load_slomo_params(out), (flow, interp)):
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name]["w"], b[name]["w"])
            np.testing.assert_array_equal(a[name]["b"], b[name]["b"])
