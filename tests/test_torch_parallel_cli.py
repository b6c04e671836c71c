"""The port's CLI with --devices on the CPU, where every strip or segment
takes the CPU (as tests/test_cli_extra.py::TestMultiDevice runs the JAX
CLI on virtual CPU devices):

* --devices 4 --parallel_mode pixel and --devices 6 at H = 64 (two inert
  pad rows; the refractory filter on, so K1 on strips) write the
  single-device event stream;
* --devices 8 --parallel_mode segment --segment_warmup 2 runs, its event
  total within the JAX test's bound of the single-device run's;
* the mesh the flags make: pad rows to use every device, and for CSDVS the
  largest divisor of H instead;
* a SloMo conversion with a mesh takes the staged path, never the fused
  chunk (FusedConverter.usable).
"""
import argparse
import os

import cv2
import numpy as np
import pytest
import torch

from v2e_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "slomo_golden.npz")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """Ten 64x64 frames of a bright bar moving 4 px per frame."""
    path = str(tmp_path_factory.mktemp("video") / "in.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), 30, (64, 64))
    for i in range(10):
        fr = np.full((64, 64, 3), 70, np.uint8)
        fr[:, 4 * i: 4 * i + 8] = 190
        w.write(fr)
    w.release()
    return path


def events(tmp_path, name, argv):
    out = tmp_path / name
    cli.run(["-o", str(out), "--overwrite", "--skip_video_output", "--no_shuffle",
             "--dvs_text", "ev.txt", "--dvs_emulator_seed", "3"] + argv, device="cpu")
    return np.loadtxt(out / "ev.txt", comments="#")


@pytest.mark.parametrize("flags", [
    ["--dvs_params", "clean", "--devices", "4", "--parallel_mode", "pixel"],
    ["--devices", "6"],
], ids=["pixel4_clean", "pixel6_padded"])
def test_pixel_strips_write_the_single_device_stream(tmp_path, video, flags):
    base = ["-i", video, "--disable_slomo"] + flags[:2 if flags[0] == "--dvs_params" else 0]
    ev1 = events(tmp_path, "a", base)
    ev2 = events(tmp_path, "b", ["-i", video, "--disable_slomo"] + flags)
    assert len(ev1) > 100
    np.testing.assert_array_equal(ev1, ev2)


def test_segment_mode_runs_and_is_close(tmp_path, video):
    base = ["-i", video, "--disable_slomo", "--dvs_params", "clean"]
    ev1 = events(tmp_path, "a", base)
    ev2 = events(tmp_path, "b", base + ["--devices", "8", "--parallel_mode", "segment",
                                        "--segment_warmup", "2"])
    assert len(ev2) > 0
    assert abs(len(ev1) - len(ev2)) <= max(0.15 * len(ev1), 30)


@pytest.mark.parametrize("H,cs,strips,pad", [(260, None, 8, 4), (260, 2.0, 5, 0),
                                             (64, None, 6, 2), (31, 2.0, None, 0)],
                         ids=["pad", "csdvs_divisor", "pad64", "csdvs_prime"])
def test_mesh_from_flags(H, cs, strips, pad):
    args = argparse.Namespace(devices=8 if H != 64 else 6, parallel_mode="pixel",
                              cs_lambda_pixels=cs)
    mesh, mode, got_pad = cli._make_mesh_from_args(args, H, torch.device("cpu"))
    assert mode == "pixel" and got_pad == pad
    assert (mesh is None) if strips is None else mesh.shape == {"data": 1, "spatial": strips}


def test_slomo_with_a_mesh_takes_the_staged_path(tmp_path, video):
    argv = ["-i", video, "--slomo_model", GOLDEN, "--batch_size", "2",
            "--auto_timestamp_resolution", "False", "--timestamp_resolution", "0.01"]
    out = str(tmp_path / "out")
    one = cli.run(argv + ["-o", out + "1", "--skip_video_output"], device="cpu")
    two = cli.run(argv + ["-o", out + "2", "--skip_video_output", "--devices", "2"],
                  device="cpu")
    assert one.fused_chunks > 0
    assert two.fused_chunks == 0 and two.staged_chunks == one.staged_chunks + one.fused_chunks
    assert two.num_events > 0
