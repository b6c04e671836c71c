"""Synthetic source video for benchmarks and smoke runs (a copy of
bench.py's make_source_frames)."""
from __future__ import annotations

import numpy as np


def make_source_frames(n: int, H: int, W: int, seed: int = 0) -> np.ndarray:
    """Synthetic 30 fps source: drifting sinusoidal texture plus a moving
    bright blob, so flow and events are non-trivial everywhere.  u8[n,H,W]."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = np.empty((n, H, W), dtype=np.uint8)
    for i in range(n):
        shift = 2.0 * i  # ~2 px/frame drift
        fr = 100 + 40 * np.sin((xx + shift) / 17.0) * np.cos(yy / 13.0)
        cx = (W / 4 + 5 * i) % W
        cy = H / 2
        blob = 80 * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 15.0**2)))
        frames[i] = np.clip(fr + blob, 0, 255).astype(np.uint8)
    return frames
