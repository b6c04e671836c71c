"""DVS threshold calibration by matching real event counts (port of
v2e_tpu/analysis/thres_estimator.py).

Binary-searches the ON/OFF thresholds so the emulator's event counts match a
real DVS recording of the same scene — the reference's
``thres_estimator.py:18-149`` idea, but run in-process against the emulator
library instead of re-launching the v2e CLI as a subprocess per probe
(reference evaluate_threshold spawns `python v2e.py` each iteration).

Each probe runs the port's EventEmulator on `device` (the CUDA device
unless the caller passes "cpu"); frames may already lie there, as
synthetic/device.py renders them.  Without threshold mismatch and noise
the counts, and so the thresholds, equal the JAX package's.
"""
from __future__ import annotations

import logging
from typing import Tuple

import numpy as np

from v2e_tpu_torch.emulator import EventEmulator

logger = logging.getLogger(__name__)


def _count_events(
    frames: np.ndarray,
    times: np.ndarray,
    pos_thres: float,
    neg_thres: float,
    seed: int = 42,
    device=None,
    **emulator_kwargs,
) -> Tuple[int, int]:
    """Run the emulator over frames and return (n_on, n_off)."""
    em = EventEmulator(
        pos_thres=pos_thres,
        neg_thres=neg_thres,
        seed=seed,
        device=device,
        **emulator_kwargs,
    )
    em.generate_events_batch(frames, times)
    return em.num_events_on, em.num_events_off


def estimate_thresholds(
    frames: np.ndarray,
    times: np.ndarray,
    target_on: int,
    target_off: int,
    thres_low: float = 0.02,
    thres_high: float = 1.0,
    max_iter: int = 12,
    rel_tol: float = 0.05,
    seed: int = 42,
    device=None,
    **emulator_kwargs,
) -> Tuple[float, float]:
    """Find (pos_thres, neg_thres) matching target ON/OFF event counts.

    Event count decreases monotonically with threshold, so each polarity is
    an independent bisection (the reference sweeps/bisects per polarity with
    seed pinned to 42, thres_estimator.py:28,82-149).

    Args:
      frames: [F,H,W] luma frames of the scene (e.g. DDD APS frames).
      times: [F] frame times in seconds.
      target_on/target_off: event counts from the real DVS over the window.
      device: where the emulator runs; None is the CUDA device.

    Returns the calibrated (pos_thres, neg_thres).
    """
    results = {}

    def counts(pos: float, neg: float) -> Tuple[int, int]:
        key = (round(pos, 6), round(neg, 6))
        if key not in results:
            results[key] = _count_events(
                frames, times, pos, neg, seed=seed, device=device, **emulator_kwargs
            )
        return results[key]

    def bisect(target: int, polarity: int) -> float:
        lo, hi = thres_low, thres_high
        best = (hi + lo) / 2
        for it in range(max_iter):
            mid = (lo + hi) / 2
            on, off = counts(mid, mid)
            got = on if polarity > 0 else off
            logger.info(
                f"threshold probe {'ON' if polarity > 0 else 'OFF'} "
                f"thres={mid:.4f}: {got} events (target {target})"
            )
            best = mid
            if target <= 0:
                return hi
            if abs(got - target) / target < rel_tol:
                return mid
            if got > target:
                lo = mid  # too many events -> raise threshold
            else:
                hi = mid
        return best

    pos = bisect(target_on, +1)
    neg = bisect(target_off, -1)
    logger.info(f"estimated thresholds: pos={pos:.4f} neg={neg:.4f}")
    return pos, neg
