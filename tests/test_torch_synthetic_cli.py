"""The port's synthetic-input entry point (`v2e_tpu_torch.cli
--synthetic_input`, on the CPU) against the JAX package's CLI, its device
path against its host path, and its import boundary.

Input: the moving_dot generator at 96x80, 0.02 cycles of radius 30 (38
frames), with the deterministic emulator flags of test_torch_cli.py (no
threshold mismatch, leak or shot noise, and the events unshuffled), since
the presets draw a random mismatch from generators that differ between the
packages.  With no photoreceptor lowpass both CLIs give the same events,
under the default 0.5 ms refractory period (K1's path) and without one
(K2's).  At the default --cutoff_hz 300 they are held as test_torch_cli.py
holds them: the lowpass (JAX's associative scan against the port's loop)
differs by an ulp, which decides events where lp - base lands on a
threshold multiple, so the totals agree within 0.5 % and the per-pixel
counts by one event at no more than 3 % of the pixels (measured on this
input: all 471 events equal; 805 events with K1, 2090 with K2).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from v2e_tpu.cli import main as jax_main
from v2e_tpu_torch import cli
from v2e_tpu_torch.synthetic.moving_dot import moving_dot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 96, 80
DOT = ["--synthetic_input", "scripts.moving_dot", "--output_width", str(W),
       "--output_height", str(H), "--cycles", "0.02", "--radius", "30",
       "--dvs_text", "v2e.txt", "--skip_video_output"]
DETERMINISTIC = ["--sigma_thres", "0", "--leak_rate_hz", "0", "--shot_noise_rate_hz", "0",
                 "--cutoff_hz", "0", "--no_shuffle"]


def argv(out, flags):
    return ["-o", str(out), "--overwrite", "--unique_output_folder", "false"] + flags


def event_lines(out):
    """The text sink's event lines (its header carries a creation time)."""
    with open(os.path.join(out, "v2e.txt")) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("#")]


def pixel_counts(lines):
    ev = np.array([ln.split() for ln in lines], dtype=np.float64).reshape(-1, 4)
    c = np.zeros((H, W, 2), np.int64)
    np.add.at(c, (ev[:, 2].astype(int), ev[:, 1].astype(int), (ev[:, 3] > 0).astype(int)), 1)
    return c


@pytest.mark.parametrize("flags,exact", [
    ([], True),
    (["--refractory_period", "0"], True),
    (["--cutoff_hz", "300"], False),
], ids=["refractory_k1", "no_refractory_k2", "cutoff300"])
def test_synthetic_cli_matches_jax(tmp_path, flags, exact):
    extra = DOT + DETERMINISTIC + flags
    assert jax_main(argv(tmp_path / "jax", extra)) == 0
    stats = cli.run(argv(tmp_path / "port", extra), device="cpu")
    assert (stats.n_frames, stats.first_ts) == (38, 0.0)
    assert stats.last_ts == pytest.approx(0.0037)
    a, b = event_lines(tmp_path / "jax"), event_lines(tmp_path / "port")
    assert len(a) > 300 and stats.num_events == len(b)
    if exact:
        assert a == b
        return
    assert abs(len(a) - len(b)) <= 5e-3 * len(a)
    d = np.abs(pixel_counts(a) - pixel_counts(b))
    assert d.max() <= 1 and int((d.sum(axis=2) > 0).sum()) <= 0.03 * H * W


def test_device_path_matches_host_path(tmp_path, monkeypatch):
    """The CLI renders the frames with device_frames when it writes no
    input AVI; without that method it stacks next_frame's host frames.
    Both give the same events (as tests/test_cli.py holds it for JAX)."""
    calls = []
    render = moving_dot.device_frames
    monkeypatch.setattr(moving_dot, "device_frames",
                        lambda self, *a: calls.append(a[1]) or render(self, *a))
    extra = DOT[:1] + ["v2e_tpu.synthetic.moving_dot"] + DOT[2:] + [
        "--dvs_params", "clean", "--dvs_emulator_seed", "7"]
    assert cli.main(argv(tmp_path / "dev", extra), device="cpu") == 0
    assert [str(d) for d in calls] == ["cpu"]  # 38 frames: one chunk of 64
    monkeypatch.delattr(moving_dot, "device_frames")
    assert cli.main(argv(tmp_path / "host", extra), device="cpu") == 0
    dev, host = event_lines(tmp_path / "dev"), event_lines(tmp_path / "host")
    assert len(dev) > 100
    assert dev == host


def test_host_path_writes_the_input_video(tmp_path):
    """With the videos on (--vid_orig's default) the host path runs and
    writes the generator's frames to video_orig.avi, the events to the DVS
    video."""
    out = tmp_path / "out"
    stats = cli.run(argv(out, DOT[:-1] + ["--chunk_size", "16"]), device="cpu")
    assert stats.n_frames == 38 and stats.num_events > 100
    for name in ("video_orig.avi", "dvs-video.avi"):
        assert os.path.getsize(out / name) > 0, name


def test_synthetic_cli_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A fresh process running the port's CLI over the JAX package's module
    path of a generator imports neither jax nor v2e_tpu."""
    code = (
        "import sys; from v2e_tpu_torch import cli;"
        "rc = cli.main(sys.argv[1:], device='cpu');"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'v2e_tpu'));"
        "print(bad); sys.exit(rc or (1 if bad else 0))"
    )
    flags = DOT[:1] + ["v2e_tpu.synthetic.moving_dot"] + DOT[2:] + ["--cycles", "0.005"]
    r = subprocess.run([sys.executable, "-c", code] + argv(tmp_path / "o", flags), cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert os.path.getsize(tmp_path / "o" / "v2e.txt") > 0
