"""The port's CLI (v2e_tpu_torch.cli) on the CPU: its video and AEDAT-2
outputs, the multi-device flags, the sink, SloMo, emulator-variant and
synthetic-input flags it runs, and its import boundary (no jax, no
v2e_tpu).  test_torch_cli.py
holds the CLI against the JAX package's.
"""
import json
import logging
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from v2e_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "slomo_golden.npz")


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """Four 346x260 frames of a bright bar moving 8 px per frame."""
    d = tmp_path_factory.mktemp("frames")
    for i in range(4):
        f = np.full((260, 346), 80, np.uint8)
        f[:, 20 + 8 * i: 40 + 8 * i] = 200
        cv2.imwrite(str(d / f"{i:04d}.png"), f)
    return str(d)


def test_cli_writes_videos_and_aedat(frames_dir, tmp_path):
    """The default video outputs (dvs-video.avi, video_orig.avi and
    video_slomo.avi, which keep every window staged) and an AEDAT-2 file
    of 8 bytes per event after its header."""
    out = tmp_path / "out"
    stats = cli.run(["-i", frames_dir, "--input_frame_rate", "30", "-o", str(out),
                     "--slomo_model", GOLDEN, "--batch_size", "2",
                     "--auto_timestamp_resolution", "False", "--timestamp_resolution", "0.01",
                     "--dvs_aedat2", "ev.aedat"], device="cpu")
    assert (stats.staged_chunks, stats.fused_chunks) == (2, 0)
    for name in ("dvs-video.avi", "video_orig.avi", "video_slomo.avi", "ev.aedat"):
        assert os.path.getsize(out / name) > 0, name
    with open(out / "ev.aedat", "rb") as f:
        data = f.read()
    header = 0
    while data[header:header + 1] == b"#":  # the ASCII header's lines
        header = data.index(b"\r\n", header) + 2
    assert len(data) - header == 8 * stats.num_events and stats.num_events > 0


@pytest.mark.parametrize("flags", [
    ["--devices", "2"],
    ["--parallel_mode", "segment"],
], ids=lambda f: f[0].lstrip("-"))
def test_parallel_flags_write_the_single_device_events(frames_dir, tmp_path, flags):
    """The multi-device flags the port once turned away: each exits 0 on
    the CPU and writes the single-device run's events (two strips of the
    CPU; segment mode with one device is the single-device run)."""
    argv = ["-i", frames_dir, "--input_frame_rate", "30", "--disable_slomo", "--no_shuffle",
            "--dvs_text", "ev.txt", "--dvs_emulator_seed", "5", "--skip_video_output"]
    assert cli.main(argv + ["-o", str(tmp_path / "one")], device="cpu") == 0
    assert cli.main(argv + ["-o", str(tmp_path / "out")] + flags, device="cpu") == 0
    ev = [np.loadtxt(tmp_path / d / "ev.txt", comments="#") for d in ("one", "out")]
    assert len(ev[0]) > 100
    np.testing.assert_array_equal(ev[0], ev[1])


SLOMO = ["--slomo_model", GOLDEN, "--batch_size", "2", "--auto_timestamp_resolution", "False",
         "--timestamp_resolution", "0.01", "--skip_video_output"]


@pytest.mark.parametrize("flags,outputs", [
    (["--dvs_h5", "ev.h5", "--disable_slomo"], ["ev.h5"]),
    (["--dvs_aedat4", "ev.aedat4", "--disable_slomo"], ["ev.aedat4"]),
    (["--ddd_output", "--dvs_h5", "ev.h5", "--dvs_text", "ev.txt"] + SLOMO, ["ev.h5"]),
    (["--slomo_use_saved"] + SLOMO, ["../slomo-cache-*.h5"]),
    (["--slomo_stats_plot"] + SLOMO, ["slomo-stats.png"]),
], ids=["dvs_h5", "dvs_aedat4", "ddd_output", "slomo_use_saved", "slomo_stats_plot"])
def test_sink_and_slomo_flags_run(frames_dir, tmp_path, flags, outputs):
    """The flags the port once turned away: each exits 0 and writes its
    output (--ddd_output with the --dvs_h5 it needs: every interpolated
    frame and event in the HDF5 file, which keeps each window staged;
    --slomo_use_saved a cache beside the output folder)."""
    import glob

    import h5py

    out = tmp_path / "out"
    assert cli.main(["-i", frames_dir, "--input_frame_rate", "30", "-o", str(out)] + flags,
                    device="cpu") == 0
    for pattern in outputs:
        found = glob.glob(str(out / pattern))
        assert len(found) == 1 and os.path.getsize(found[0]) > 0, pattern
    if "--ddd_output" in flags:
        n_text = len(np.loadtxt(out / "ev.txt", comments="#"))
        with h5py.File(out / "ev.h5", "r") as f:
            # 3 pairs at U = 4, in windows of 2 pairs
            assert f["frame"].shape == (12, 260, 346)
            assert f["events"].shape[0] == n_text > 0


def ran_and_wrote(out, names):
    return all(os.path.getsize(out / n) > 0 for n in names)


@pytest.mark.parametrize("flags,outputs", [
    (["--scidvs"], ["ev.txt"]),
    (["--cs_lambda_pixels", "2"], ["ev.txt"]),
    (["--save_dvs_model_state", "--show_dvs_model_state", "diff_frame"],
     ["ev.txt", "diff_frame.avi"]),
    (["--checkpoint_state", "{tmp}/s.npz"], ["ev.txt", "{tmp}/s.npz"]),
    (["--resume_state", "{tmp}/first.npz"], ["ev.txt"]),
    (["--synthetic_input", "scripts.moving_dot", "--cycles", "0.01"], ["ev.txt"]),
], ids=["scidvs", "cs_lambda_pixels", "save_dvs_model_state", "checkpoint_state",
        "resume_state", "synthetic_input"])
def test_ported_variant_flags_run(frames_dir, tmp_path, flags, outputs):
    """The emulator-variant flags and the synthetic input the port runs:
    each exits 0 and writes its output (the events, the state video, the
    checkpoint; a synthetic input takes the place of the input folder).  A
    resume needs a checkpoint whose last frame time is 0, as the
    conversion's frame times start at 0: one of the first frame alone."""
    base = ["-i", frames_dir, "--input_frame_rate", "30", "--disable_slomo",
            "--skip_video_output", "--dvs_text", "ev.txt"]
    assert cli.main(base + ["-o", str(tmp_path / "first"), "--stop_time", "0.04",
                            "--checkpoint_state", str(tmp_path / "first.npz")],
                    device="cpu") == 0
    out = tmp_path / "out"
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    assert cli.main(base + ["-o", str(out)] + flags, device="cpu") == 0
    assert ran_and_wrote(out, [o.replace("{tmp}", str(tmp_path)) for o in outputs])
    assert len(np.loadtxt(out / "ev.txt", comments="#").reshape(-1, 4)) > 100


def test_tpu_layout_unet_forms_run_dense(frames_dir, tmp_path, caplog):
    """The log says what each --unet_conv form runs on the port: packed,
    packedup and blocked are TPU layouts of the dense UNet, the fold forms
    fold the named up levels, packedz sends the up tail to K5."""
    caplog.set_level(logging.INFO)
    said = {
        "packed": "runs the dense form",
        "packedup": "runs the dense form",
        "blocked": "runs the dense form",
        "packedfold45": "upsample and conv1 of up4, up5 run as one folded half-res conv",
        "fold": "upsample and conv1 of up1, up2, up3, up4, up5 run as one folded",
        "packedz": "run through the K5 conv kernel",
    }
    for form, text in said.items():
        caplog.clear()
        rc = cli.main(["-i", frames_dir, "--input_frame_rate", "30",
                       "-o", str(tmp_path / form), "--unet_conv", form, "--disable_slomo"],
                      device="cpu")
        assert rc == 0 and text in caplog.text, form
        assert ("dense form" in caplog.text) == (form in ("packed", "packedup", "blocked"))


def test_missing_input_exits_1(tmp_path):
    assert cli.main(["-o", str(tmp_path / "out")], device="cpu") == 1


def test_profile_writes_a_trace(frames_dir, tmp_path):
    out = tmp_path / "out"
    stats = cli.run(["-i", frames_dir, "--input_frame_rate", "30", "-o", str(out),
                     "--disable_slomo", "--skip_video_output", "--profile"], device="cpu")
    assert stats.n_frames == 4
    assert os.path.getsize(out / "torch-trace" / "trace.json") > 0
    # the port's spans and counters beside the trace (v2e_tpu_torch/tracing.py)
    with open(out / "torch-trace" / "spans.json") as f:
        spans = json.load(f)
    assert set(spans["clock"]) == {"perf_counter_ns", "time_ns"}
    names = [s["name"] for s in spans["spans"]]
    for root in ("submit", "collect.fetch", "collect.finalize"):
        assert root in names, root
    events = sum(s["counts"].get("events", 0) for s in spans["spans"]
                 if s["name"] == "collect.finalize")
    assert events == stats.num_events
    assert all(s["end_ns"] >= s["start_ns"] for s in spans["spans"])
    assert isinstance(spans["counters"], dict)


def test_profile_wraps_the_synthetic_run(tmp_path):
    out = tmp_path / "out"
    stats = cli.run(["--synthetic_input", "scripts.moving_dot", "--cycles", "0.005",
                     "--output_width", "96", "--output_height", "80", "--radius", "30",
                     "-o", str(out), "--skip_video_output", "--profile"], device="cpu")
    assert stats.n_frames == 10 and stats.num_events > 0
    assert os.path.getsize(out / "torch-trace" / "trace.json") > 0


def test_command_line_needs_a_card(frames_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-i", frames_dir, "--input_frame_rate", "30", "-o", str(tmp_path / "o")])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, v2e_tpu_torch.cli, v2e_tpu_torch.__main__, v2e_tpu_torch.synthetic,"
        " v2e_tpu_torch.synthetic.device, v2e_tpu_torch.analysis.thres_estimator,"
        " v2e_tpu_torch.native, v2e_tpu_torch.io.aedat4, v2e_tpu_torch.io.hdf5,"
        " v2e_tpu_torch.models.slomo_cache, v2e_tpu_torch.examples.library_embedding,"
        " v2e_tpu_torch.models.train, v2e_tpu_torch.io.ddd, v2e_tpu_torch.utils.roi,"
        " v2e_tpu_torch.parallel, v2e_tpu_torch.parallel.convert, v2e_tpu_torch.parallel.dryrun;"
        "from v2e_tpu_torch.dataset_tools import batch_convert, ddd_extract_data,"
        " ddd_find_thresholds, ddd_plot_event_counts, ddd_v2e, eval_slomo_ckpt,"
        " make_training_videos, train_slomo;"
        "from v2e_tpu_torch.synthetic import moving_dot, single_linearly_moving_dot, spots,"
        " barberpole, gradients, particles;"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'v2e_tpu'));"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
