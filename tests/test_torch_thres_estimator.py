"""The port's threshold estimator (v2e_tpu_torch.analysis, on the CPU)
against the JAX package's (v2e_tpu.analysis).

Input: 120 moving-dot frames at 64x48 (dots of radius 15 px), the target
ON and OFF counts taken from a run at thresholds 0.25/0.25, with no
threshold mismatch, leak, shot noise or lowpass.  Each probe then counts
the same events in both packages (the sequential core equals its plain
version bit for bit), so the bisections take the same steps and return the
same thresholds.  With noise on the two would differ: each probe draws
from a fresh seed-42 generator, Philox in the port and threefry in JAX.
"""
import numpy as np
import pytest

from v2e_tpu.analysis import thres_estimator as jax_est
from v2e_tpu_torch.analysis import estimate_thresholds
from v2e_tpu_torch.analysis import thres_estimator as port_est
from v2e_tpu_torch.synthetic.device import moving_dot_frames

CLEAN = dict(sigma_thres=0.0, leak_rate_hz=0.0, shot_noise_rate_hz=0.0, cutoff_hz=0.0)


@pytest.fixture(scope="module")
def scene():
    times = np.arange(120) * 1e-4
    frames = moving_dot_frames(times, 64, 48, 5, 10.0, 5.0, 15.0, device="cpu").numpy()
    return frames, times


def test_counts_match_jax(scene):
    frames, times = scene
    for thr in (0.25, 0.51):
        want = jax_est._count_events(frames, times, thr, thr, **CLEAN)
        got = port_est._count_events(frames, times, thr, thr, device="cpu", **CLEAN)
        assert got == want and min(got) > 0


def test_estimate_thresholds_matches_jax(scene, monkeypatch):
    frames, times = scene
    on, off = jax_est._count_events(frames, times, 0.25, 0.25, **CLEAN)
    want = jax_est.estimate_thresholds(frames, times, on, off, **CLEAN)
    probes = []
    count = port_est._count_events
    monkeypatch.setattr(port_est, "_count_events",
                        lambda *a, **k: probes.append(a[2:4]) or count(*a, **k))
    got = estimate_thresholds(frames, times, on, off, device="cpu", **CLEAN)
    assert got == want
    assert len(probes) >= 2 and all(p == (p[0], p[0]) for p in probes)
    assert abs(got[0] - 0.25) < 0.05 and abs(got[1] - 0.25) < 0.05
