"""The rest of the port's SloMo against v2e_tpu, on the CPU with the
golden fixture (tests/fixtures/slomo_golden.npz, trained weights at base 8):

* the file API: `get_interpolated_timestamps` exactly, and `interpolate`
  (.npy frames in, numbered PNGs out) with the same PNG count and times and
  pixels within one 8-bit level (the bf16 UNets flip a pixel by one level,
  test_torch_cli_rounding.py);
* --slomo_use_saved: a second run replays the first run's cache and gives
  its events; the cache key is v2e_tpu's;
* --slomo_stats_plot writes slomo-stats.png;
* the trained model's interpolation beats the frame average by the margin
  of tests/test_golden_ckpt.py, on the same held-out clip.
"""
import logging
import os

import cv2
import numpy as np
import pytest

from dataset_tools.make_training_videos import render_clip
from v2e_tpu.models import slomo_cache as jax_cache
from v2e_tpu.models.slomo import SuperSloMo as JaxSloMo
from v2e_tpu_torch import cli
from v2e_tpu_torch.models import slomo_cache
from v2e_tpu_torch.models.slomo import SuperSloMo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "slomo_golden.npz")
U = 4


@pytest.fixture(scope="module")
def engines():
    kw = dict(auto_upsample=False, upsampling_factor=U, batch_size=2)
    return JaxSloMo(model=GOLDEN, **kw), SuperSloMo(GOLDEN, device="cpu", **kw)


def test_file_api_matches_v2e_tpu(engines, tmp_path):
    jax_s, port_s = engines
    src = tmp_path / "src"
    src.mkdir()
    clip = render_clip("texture", 5, 48, 64, np.random.default_rng(3))
    for i, frame in enumerate(clip):
        np.save(src / f"{i}.npy", frame)
    times_j, avg_j = jax_s.interpolate(str(src), str(tmp_path / "jax"), (64, 48))
    times_p, avg_p = port_s.interpolate(str(src), str(tmp_path / "port"), (64, 48))
    np.testing.assert_array_equal(times_p, times_j)
    assert avg_p == avg_j == U and len(times_p) == 4 * U
    names = sorted(os.listdir(tmp_path / "port"), key=lambda s: int(s[:-4]))
    assert names == sorted(os.listdir(tmp_path / "jax"), key=lambda s: int(s[:-4]))
    assert names == [f"{k}.png" for k in range(4 * U)]

    def gray(d, n):
        return cv2.imread(str(tmp_path / d / n), cv2.IMREAD_GRAYSCALE).astype(int)

    diffs = [np.abs(gray("port", n) - gray("jax", n)) for n in names]
    # one level at most, at a few percent of the pixels (measured 1.06 %)
    assert max(d.max() for d in diffs) <= 1
    assert np.mean([(d > 0).mean() for d in diffs]) < 0.03

    ts = np.array([0.0, 0.04, 0.07, 0.1333])
    np.testing.assert_array_equal(port_s.get_interpolated_timestamps(ts),
                                  jax_s.get_interpolated_timestamps(ts))


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def test_trained_interpolation_beats_average(engines):
    """tests/test_golden_ckpt.py's margin with the port's SloMo: mid-frame
    PSNR above the frame average's by more than 1 dB, and above 24 dB."""
    port_s = engines[1]
    H, W = 96, 128
    hi = render_clip("texture", 2 * U + 1, H, W, np.random.default_rng(77))
    interp, _ = port_s.interpolate_batch(hi[::U].astype(np.float32), H, W)
    interp = interp.numpy()
    assert interp.shape == (2 * U, H, W)
    model, avg = [], []
    for pair in range(2):
        for i in range(1, U):
            gt = hi[pair * U + i]
            model.append(_psnr(interp[pair * U + i], gt))
            mix = ((1 - i / U) * hi[pair * U].astype(np.float64)
                   + (i / U) * hi[(pair + 1) * U].astype(np.float64))
            avg.append(_psnr(mix, gt))
    m, a = np.mean(model), np.mean(avg)
    assert m > a + 1.0, f"trained PSNR {m:.2f} dB <= average baseline {a:.2f}"
    assert m > 24.0, f"trained PSNR {m:.2f} dB too low for smooth motion"


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for i, frame in enumerate(render_clip("texture", 7, 48, 64, np.random.default_rng(5))):
        cv2.imwrite(str(d / f"{i:04d}.png"), frame)
    return str(d)


def argv(frames_dir, out):
    return ["-i", frames_dir, "--input_frame_rate", "30", "-o", str(out),
            "--slomo_model", GOLDEN, "--batch_size", "2",
            "--auto_timestamp_resolution", "False", "--timestamp_resolution", "0.0084",
            "--skip_video_output", "--no_shuffle", "--dvs_text", "ev.txt",
            "--sigma_thres", "0", "--leak_rate_hz", "0", "--shot_noise_rate_hz", "0",
            "--cutoff_hz", "0"]


def test_slomo_use_saved_replays_and_stats_plot(frames_dir, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    first = cli.run(argv(frames_dir, tmp_path / "a") + ["--slomo_use_saved", "--slomo_stats_plot"],
                    device="cpu")
    caches = [f for f in os.listdir(tmp_path) if f.startswith("slomo-cache-")]
    assert len(caches) == 1 and caches[0].endswith(".h5")
    assert first.staged_chunks == 3 and first.fused_chunks == 0  # recording stages
    assert os.path.getsize(tmp_path / "a" / "slomo-stats.png") > 0
    # the replay runs no SloMo chunk, staged or fused
    second = cli.run(argv(frames_dir, tmp_path / "b") + ["--slomo_use_saved"], device="cpu")
    assert "replaying saved SloMo frames" in caplog.text
    assert second.staged_chunks == second.fused_chunks == 0
    assert second.n_frames == first.n_frames == 6 * U
    a = np.loadtxt(tmp_path / "a" / "ev.txt", comments="#")
    b = np.loadtxt(tmp_path / "b" / "ev.txt", comments="#")
    assert len(a) > 100
    np.testing.assert_array_equal(a, b)

    args, _ = cli.get_args(argv(frames_dir, tmp_path / "a") + ["--slomo_use_saved"])
    for shape in ((48, 64), (260, 346)):
        assert (slomo_cache.cache_key(args, 1 / 30, *shape)
                == jax_cache.cache_key(args, 1 / 30, *shape))
    assert os.path.basename(slomo_cache.cache_path_for(args, 1 / 30, 48, 64)) == caches[0]
