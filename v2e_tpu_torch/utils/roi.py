"""Event-stream analysis helpers: ROI selection, time-binned histograms,
text event reading (a copy of v2e_tpu/utils/roi.py; the original v2e's
v2e_utils.py)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def read_aedat_txt_events(fname: str) -> np.ndarray:
    """Read an RPG-format text event file -> [N,4] (t, x, y, p(+-1))."""
    data = np.loadtxt(fname, comments="#")
    if data.ndim == 1:
        data = data[None, :]
    out = data[:, :4].astype(np.float64)
    out[:, 3] = out[:, 3] * 2 - 1  # 0/1 -> -1/+1
    return out


def select_events_in_roi(
    events: np.ndarray,
    x: Optional[Tuple[int, int]] = None,
    y: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Select events within inclusive x/y ranges (None = all)."""
    sel = np.ones(events.shape[0], dtype=bool)
    if x is not None:
        sel &= (events[:, 1] >= x[0]) & (events[:, 1] <= x[1])
    if y is not None:
        sel &= (events[:, 2] >= y[0]) & (events[:, 2] <= y[1])
    return events[sel]


def histogram_events_in_time_bins(
    events: np.ndarray,
    start: float = 0.0,
    stop: Optional[float] = None,
    time_bin_ms: float = 50.0,
    polarity: Optional[int] = None,
) -> np.ndarray:
    """Bin event counts over time. Returns [n_bins, 2] of (t_center, count)."""
    if stop is None:
        stop = float(events[:, 0].max()) if events.shape[0] else start
    dt = time_bin_ms * 1e-3
    edges = np.arange(start, stop + dt, dt)
    ev = events
    if polarity is not None:
        ev = ev[ev[:, 3] == polarity]
    counts, _ = np.histogram(ev[:, 0], bins=edges)
    centers = (edges[:-1] + edges[1:]) / 2
    return np.stack([centers, counts], axis=1)
