"""The port's CLI (v2e_tpu_torch.cli, on the CPU) against the JAX package's
(v2e_tpu.cli) on a tiny image folder (test_torch_cli_flags.py holds the
flags the port turns away, its video and AEDAT-2 outputs and its import
boundary).

Input: 12 PNG frames of 64x96 at --input_frame_rate 30, a bright bar moving
6 px per frame over a blurred random texture, converted with the golden
SuperSloMo fixture (the CLI's default bf16 compute on both sides) and
deterministic emulator flags: no threshold mismatch, no leak or shot
noise, no refractory period, and no photoreceptor lowpass (--cutoff_hz 0),
plus one run at the default --cutoff_hz 300.

Tolerance, from the CPU runs these tests make (6144 pixels, about 20k
events):
* cutoff 0: total events within 0.1 % (measured 4 of 19917 at U=7, 9 of
  20749 at U=96); the pixel-by-pixel ON and OFF counts differ by at most
  one event, at no more than 1 % of the pixels (measured 22 pixels in both);
* cutoff 300 at U=96: total events within 0.5 % (measured 67 of 20631),
  per-pixel counts by at most one event at no more than 3 % of the pixels
  (measured 97);
* the first and last event times within one interpolated frame.
What differs is rounding, in two places that test_torch_cli_rounding.py
isolates: the bf16 UNet convolutions, which flip an interpolated pixel by
one 8-bit level and so move events to a neighbouring interpolated frame
(with float32 compute on both sides the streams agree frame by frame), and
the photoreceptor lowpass, which the JAX package solves with an associative
scan and the port with a loop; every pixel where that changes the events
first diverges on a threshold tie (lp - base within an ulp of a multiple
of the threshold).
"""
import importlib
import os

import cv2
import numpy as np
import pytest

from v2e_tpu.cli import main as jax_main
from v2e_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "slomo_golden.npz")
# the module: v2e_tpu_torch.models exports the function `backwarp` under its name
backwarp = importlib.import_module("v2e_tpu_torch.models.backwarp")
H, W, N_FRAMES, FPS = 64, 96, 12, 30.0
RTOL_EVENTS = 1e-3


def pixel_counts(ev):
    """[H,W,2] event counts per pixel, OFF then ON."""
    c = np.zeros((H, W, 2), np.int64)
    np.add.at(c, (ev[:, 2].astype(int), ev[:, 1].astype(int), (ev[:, 3] > 0).astype(int)), 1)
    return c


def assert_pixel_counts_close(a, b, max_pixel_share):
    d = np.abs(pixel_counts(a) - pixel_counts(b))
    n_pixels = int((d.sum(axis=2) > 0).sum())
    assert d.max() <= 1, f"a pixel's ON or OFF count differs by {d.max()} events"
    assert n_pixels <= max_pixel_share * H * W, f"{n_pixels} pixels differ"


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    yy = np.mgrid[0:H, 0:W][0]
    tex = cv2.GaussianBlur(rng.uniform(0, 1, (H, W)).astype(np.float32), (0, 0), 1.5)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    for i in range(N_FRAMES):
        f = 70 + 90 * tex + 20 * np.sin(yy / 9.0)
        x0 = (10 + 6 * i) % W
        f[:, x0:x0 + 8] += 90
        cv2.imwrite(str(d / f"{i:04d}.png"), np.clip(f, 0, 255).astype(np.uint8))
    return str(d)


def common_args(frames_dir, out):
    return [
        "-i", frames_dir, "--input_frame_rate", str(FPS), "-o", str(out),
        "--overwrite", "--unique_output_folder", "false",
        "--slomo_model", GOLDEN, "--batch_size", "4", "--dvs_text", "ev.txt",
        "--skip_video_output", "--no_shuffle",
        "--sigma_thres", "0", "--leak_rate_hz", "0", "--shot_noise_rate_hz", "0",
        "--refractory_period", "0", "--cutoff_hz", "0",
    ]


def events(out):
    return np.loadtxt(os.path.join(out, "ev.txt"), comments="#").reshape(-1, 4)


FIXED_U7 = ["--auto_timestamp_resolution", "False", "--timestamp_resolution", "0.005"]
# auto-U with a floor of 67 -> bucket 96: the warp window widens past 32
AUTO_U96 = ["--auto_timestamp_resolution", "True", "--timestamp_resolution", "0.0005"]
DEFAULT_CUTOFF = ["--cutoff_hz", "300"]  # the flag's default; overrides common_args


@pytest.mark.parametrize("flags,U,rtol_events,max_pixel_share", [
    (FIXED_U7, 7, RTOL_EVENTS, 0.01),
    (AUTO_U96, 96, RTOL_EVENTS, 0.01),
    (AUTO_U96 + DEFAULT_CUTOFF, 96, 5e-3, 0.03),
], ids=["fixed_u7", "auto_u96", "auto_u96_cutoff300"])
def test_cli_matches_jax(frames_dir, tmp_path, monkeypatch, flags, U, rtol_events,
                         max_pixel_share):
    k4_calls = []
    tiled = backwarp.warp_tiled
    monkeypatch.setattr(backwarp, "warp_tiled",
                        lambda *a: k4_calls.append(a[3]) or tiled(*a))
    assert jax_main(common_args(frames_dir, tmp_path / "jax") + flags) == 0
    stats = cli.run(common_args(frames_dir, tmp_path / "port") + flags, device="cpu")

    # 11 pairs in windows of 4: the first window staged, the others fused
    assert stats.upsampling == [U, U, U]
    assert (stats.staged_chunks, stats.fused_chunks) == (1, 2)
    assert stats.n_frames == (N_FRAMES - 1) * U
    # U > 32 sends the staged window's warps, and the first fused window's
    # (its window comes from the staged one), through K4
    assert bool(k4_calls) == (U > 32) and set(k4_calls) <= {128}

    a, b = events(tmp_path / "jax"), events(tmp_path / "port")
    assert len(a) > 5000
    assert abs(len(a) - len(b)) <= rtol_events * len(a)
    assert stats.num_events == len(b)
    assert_pixel_counts_close(a, b, max_pixel_share)
    frame = 1.0 / (FPS * U)
    assert abs(a[0, 0] - b[0, 0]) <= frame and abs(a[-1, 0] - b[-1, 0]) <= frame


def test_disable_slomo_matches_jax(frames_dir, tmp_path):
    """--disable_slomo: source frames straight into the emulator
    (ChunkPipeline), in chunks of --chunk_size."""
    flags = ["--disable_slomo", "--chunk_size", "5"]
    assert jax_main(common_args(frames_dir, tmp_path / "jax") + flags) == 0
    stats = cli.run(common_args(frames_dir, tmp_path / "port") + flags, device="cpu")
    a, b = events(tmp_path / "jax"), events(tmp_path / "port")
    assert stats.n_frames == N_FRAMES and len(a) > 500
    assert abs(len(a) - len(b)) <= RTOL_EVENTS * len(a)
    assert_pixel_counts_close(a, b, 0.0)
