"""The port's CLI with every event sink on (--dvs_aedat2 --dvs_aedat4
--dvs_h5 --ddd_output), against itself and against v2e_tpu's CLI, on the
CPU.

Input: 12 PNG frames of 64x48 at 30 fps (a bright bar moving 4 px per
frame), converted with --disable_slomo to 240x180, the smallest sensor size
the AEDAT-2 sink lays out (its address layouts cover 346x260, 240x180 and
640x480), with the deterministic emulator flags of test_torch_cli.py.

* Within each CLI, the AEDAT-4 and HDF5 files hold that CLI's AEDAT-2
  stream event for event (t in us, x, y, p).  The AEDAT-2 sink drops
  leading events whose first byte would be '#', so the other streams are
  held from the first event it kept.
* Across the two CLIs, the AEDAT-2 streams agree as in
  test_torch_cli.py::test_disable_slomo_matches_jax: totals within
  RTOL_EVENTS and the same per-pixel ON and OFF counts.
* The DDD frame datasets have the same shapes, frames and frame times.
"""
import os

import cv2
import h5py
import numpy as np
import pytest

from v2e_tpu.cli import main as jax_main
from v2e_tpu_torch import cli
from v2e_tpu_torch.io.aedat4 import read_aedat4, read_aedat4_data_table

N_FRAMES, FPS = 12, 30.0
OUT_W, OUT_H = 240, 180
RTOL_EVENTS = 1e-3  # test_torch_cli.py's


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    yy = np.mgrid[0:48, 0:64][0]
    for i in range(N_FRAMES):
        f = 70 + 20 * np.sin(yy / 7.0) + np.zeros((48, 64))
        f[:, 6 + 4 * i: 12 + 4 * i] += 110
        cv2.imwrite(str(d / f"{i:04d}.png"), np.clip(f, 0, 255).astype(np.uint8))
    return str(d)


def argv(frames_dir, out):
    return [
        "-i", frames_dir, "--input_frame_rate", str(FPS), "-o", str(out),
        "--overwrite", "--unique_output_folder", "false", "--disable_slomo",
        "--output_width", str(OUT_W), "--output_height", str(OUT_H),
        "--skip_video_output", "--no_shuffle", "--chunk_size", "5",
        "--sigma_thres", "0", "--leak_rate_hz", "0", "--shot_noise_rate_hz", "0",
        "--refractory_period", "0", "--cutoff_hz", "0",
        "--dvs_aedat2", "ev.aedat", "--dvs_aedat4", "ev.aedat4",
        "--dvs_h5", "ev.h5", "--ddd_output",
    ]


def read_aedat2(path):
    """[N,4] int64 (t us, x, y, p 0/1) of a 240x180 AEDAT-2 file."""
    data = open(path, "rb").read()
    head = 0
    while data[head:head + 1] == b"#":
        head = data.index(b"\r\n", head) + 2
    words = np.frombuffer(data[head:], dtype=">i4").astype(np.int64).reshape(-1, 2)
    a = words[:, 0]
    x = OUT_W - 1 - ((a >> 12) & 0x3FF)
    y = OUT_H - 1 - ((a >> 22) & 0x1FF)
    return np.stack([words[:, 1], x, y, (a >> 11) & 1], axis=1)


def outputs(out):
    ev2 = read_aedat2(out / "ev.aedat")
    ev4 = read_aedat4(str(out / "ev.aedat4"))
    ev4 = np.stack([np.rint(ev4[:, 0] * 1e6), ev4[:, 1], ev4[:, 2], ev4[:, 3] > 0],
                   axis=1).astype(np.int64)
    with h5py.File(out / "ev.h5", "r") as f:
        h5 = {k: f[k][()] for k in f.keys()}
    return ev2, ev4, h5


@pytest.fixture(scope="module")
def runs(frames_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sinks")
    assert jax_main(argv(frames_dir, tmp / "jax")) == 0
    stats = cli.run(argv(frames_dir, tmp / "port"), device="cpu")
    assert stats.n_frames == N_FRAMES
    return {"jax": outputs(tmp / "jax"), "port": outputs(tmp / "port"),
            "table": read_aedat4_data_table(str(tmp / "port" / "ev.aedat4")),
            "num_events": stats.num_events}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_sinks_hold_the_aedat2_stream(runs, which):
    ev2, ev4, h5 = runs[which]
    dropped = len(ev4) - len(ev2)
    assert len(ev2) > 1000 and 0 <= dropped <= 4
    np.testing.assert_array_equal(ev4[dropped:], ev2)
    np.testing.assert_array_equal(h5["events"].astype(np.int64)[dropped:], ev2)
    if which == "port":
        assert len(ev4) == runs["num_events"]
        assert sum(e["num_elements"] for e in runs["table"]) == len(ev4)


def test_streams_agree_across_clis(runs):
    a, b = runs["jax"][0], runs["port"][0]
    assert abs(len(a) - len(b)) <= RTOL_EVENTS * len(a)

    def pixel_counts(ev):
        c = np.zeros((OUT_H, OUT_W, 2), np.int64)
        np.add.at(c, (ev[:, 2], ev[:, 1], ev[:, 3]), 1)
        return c

    np.testing.assert_array_equal(pixel_counts(a), pixel_counts(b))


def test_ddd_frames_agree_across_clis(runs):
    a, b = runs["jax"][2], runs["port"][2]
    assert a["frame"].shape == b["frame"].shape == (N_FRAMES, OUT_H, OUT_W)
    np.testing.assert_array_equal(a["frame_ts"], b["frame_ts"])
    np.testing.assert_array_equal(a["frame"], b["frame"])
    # each frame's index is the event count once its events are stored
    assert b["frame_idx"][-1] == len(b["events"])
    assert np.all(np.diff(b["frame_idx"].astype(np.int64)) >= 0)
