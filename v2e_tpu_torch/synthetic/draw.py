"""Vectorized drawing primitives for the synthetic generators (a copy of
v2e_tpu/synthetic/draw.py).

Replaces the reference's Numba per-pixel loops (scripts/moving_dot.py:25-54,
particles.py:213-240) with numpy patch broadcasts of identical math.
"""
from __future__ import annotations

import numpy as np


def fill_gaussian_dot(
    pix_arr: np.ndarray,
    x: float,
    y: float,
    fg: float,
    bg: float,
    sigma: float,
    gain: float,
    d: int,
    clip_low: float = 0.0,
) -> None:
    """Draw a saturated-Gaussian 'dot' into pix_arr in place.

    Intensity profile ``v = min(gain * exp(-dist^2 / sigma^2), 1)`` (a disk
    with soft edges), optionally zeroed below ``clip_low``; pixel value is
    ``bg + (fg - bg) * v``.  The patch spans ``[round(c)-d, round(c)+d)``
    around the (float) center like the reference loops.
    """
    H, W = pix_arr.shape
    x0, y0 = round(x), round(y)
    xs = np.arange(x0 - d, x0 + d)
    ys = np.arange(y0 - d, y0 + d)
    ok_x = (xs >= 0) & (xs < W)
    ok_y = (ys >= 0) & (ys < H)
    xs, ys = xs[ok_x], ys[ok_y]
    if xs.size == 0 or ys.size == 0:
        return
    dx = xs[None, :] - x
    dy = ys[:, None] - y
    dist2 = dx * dx + dy * dy
    v = gain * np.exp(-dist2 / (sigma * sigma))
    v = np.minimum(v, 1.0)
    if clip_low > 0:
        v = np.where(v < clip_low, 0.0, v)
    vals = bg + (fg - bg) * v
    np.clip(vals, 0, 255, out=vals)
    patch = pix_arr[np.ix_(ys, xs)]
    pix_arr[np.ix_(ys, xs)] = vals.astype(pix_arr.dtype)
    del patch


def paint_gaussian_dots(
    centers: np.ndarray,
    width: int,
    height: int,
    fg: float,
    bg: float,
    sigma: float,
    gain: float,
    d: int,
) -> np.ndarray:
    """A float32 frame of `bg` with `fill_gaussian_dot` at each (x, y) row of
    `centers` in order, a later dot's patch overwriting an earlier one's
    (particles.next_frame's painter)."""
    pix = np.full((height, width), bg, dtype=np.float32)
    for x, y in centers:
        fill_gaussian_dot(pix, float(x), float(y), fg, bg, sigma, gain=gain, d=d)
    return pix


def fill_disk(frame: np.ndarray, color: float, radius: float, x: float, y: float) -> None:
    """Hard-edged filled disk (replaces skimage.draw.disk in spots.py)."""
    H, W = frame.shape
    r = int(np.ceil(radius))
    xs = np.arange(max(0, int(x) - r), min(W, int(x) + r + 1))
    ys = np.arange(max(0, int(y) - r), min(H, int(y) + r + 1))
    if xs.size == 0 or ys.size == 0:
        return
    dx = xs[None, :] - int(x)
    dy = ys[:, None] - int(y)
    mask = dx * dx + dy * dy <= radius * radius
    sub = frame[np.ix_(ys, xs)]
    sub[mask] = color
    frame[np.ix_(ys, xs)] = sub


def fill_rect(frame: np.ndarray, color: float, radius: float, x: float, y: float) -> None:
    """Axis-aligned filled square of half-width `radius`."""
    H, W = frame.shape
    x0 = max(0, int(x - radius))
    x1 = min(W, int(x + radius) + 1)
    y0 = max(0, int(y - radius))
    y1 = min(H, int(y + radius) + 1)
    frame[y0:y1, x0:x1] = color
