"""Synthetic frames rendered on the device, a whole chunk of timestamps at
a time (port of v2e_tpu/synthetic/device.py).

The host generators (moving_dot.py etc.) draw one frame at a time in numpy,
and every frame would then cross to the device.  These functions evaluate
the same analytic stimuli on the device for a chunk of timestamps, so only
the times (or, for particles, the walkers' centers) are copied there and the
frames feed the emulator where they are made.

Each function takes its timestamps as float64 seconds (numpy or a tensor),
rounds them to float32 on the host as the JAX package does, and computes in
float32 like it.  Divisions by a constant go through `device.scalar`: CUDA
turns a division by a Python scalar into a multiplication by its
reciprocal, which rounds differently.  The uint8-level stimuli equal their
host generators pixel for pixel at the small sizes
tests/test_torch_synthetic.py checks; at 346x260 a few pixels in 1e5 are
one level off, where a float32 time, angle or phase and its float64 value
fall on two sides of a `floor` or a comparison (the JAX renderers' too).
particles matches its host painter to float32 rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from v2e_tpu_torch.device import resolve_device, scalar

_F32 = torch.float32


def _f32(values, dev: torch.device) -> torch.Tensor:
    """`values` (numpy or a tensor) as float32 on `dev`, rounded on the
    host: the times cross to the device at 4 bytes each."""
    if isinstance(values, torch.Tensor):
        return values.to(device=dev, dtype=_F32)
    return torch.from_numpy(np.asarray(values, dtype=np.float32)).to(dev)


def _grid(width: int, height: int, dev: torch.device):
    xx = torch.arange(width, dtype=_F32, device=dev)[None, None, :]
    yy = torch.arange(height, dtype=_F32, device=dev)[None, :, None]
    return xx, yy


def _dot_profile(xx, yy, cx, cy, sigma: float, gain: float, d: int):
    """The saturated-Gaussian dot of draw.fill_gaussian_dot (values under
    0.01 cut to 0), zero outside its patch around round(c)."""
    dx = xx - cx
    dy = yy - cy
    dist2 = dx * dx + dy * dy
    v = torch.clamp(gain * torch.exp(-dist2 / scalar(sigma * sigma, dist2)), max=1.0)
    v = torch.where(v < 0.01, 0.0, v)
    in_patch = ((xx - torch.round(cx)).abs() <= d) & ((yy - torch.round(cy)).abs() <= d)
    return torch.where(in_patch, v, 0.0)


def moving_dot_frames(
    times,
    width: int = 346,
    height: int = 260,
    num_dots: int = 5,
    contrast: float = 10.0,
    bg: float = 5.0,
    radius: float = 100.0,
    speed_pps: float = 1000.0,
    dot_sigma: float = 1.0,
    device=None,
) -> torch.Tensor:
    """The moving_dot stimulus for a chunk of timestamps: f32[F,H,W] frames
    at uint8 levels (0-255), equal to `synthetic.moving_dot`'s frames."""
    dev = resolve_device(device)
    t = _f32(times, dev)[:, None, None]
    fg = float(int(bg * contrast))
    period = 2 * math.pi * radius / speed_pps
    d = int(dot_sigma * 3)
    xx, yy = _grid(width, height, dev)

    # constant angular speed; the radius shrinks ~2 dot diameters per cycle
    # so the path never overlaps itself
    theta0 = (speed_pps / radius) * t
    r_t = radius - (t / scalar(period, t)) * (d * 1.5)

    frames = torch.full((t.shape[0], height, width), bg, dtype=_F32, device=dev)
    for i in range(num_dots):
        theta = theta0 + (i / num_dots) * 2 * math.pi
        cx = width / 2 + r_t * torch.cos(theta)
        cy = height / 2 + r_t * torch.sin(theta)
        v = _dot_profile(xx, yy, cx, cy, dot_sigma, 10.0, d)
        frames = torch.maximum(frames, bg + (fg - bg) * v)
    # the host generator's uint8 assignment truncates
    return torch.floor(torch.clamp(frames, 0, 255))


def single_linearly_moving_dot_frames(
    times,
    width: int = 346,
    height: int = 260,
    contrast: float = 3.0,
    bg: float = 100.0,
    dot_sigma: float = 3.0,
    speed_pps: float = 100.0,
    gain: float = 10.0,
    device=None,
) -> torch.Tensor:
    """One Gaussian dot crossing the array at `speed_pps`: f32[F,H,W]."""
    dev = resolve_device(device)
    t = _f32(times, dev)[:, None, None]
    fg = float(int(bg * contrast))
    d = int(dot_sigma * 3)
    xx, yy = _grid(width, height, dev)
    cx = t * speed_pps
    cy = torch.full_like(cx, height / 2)
    v = _dot_profile(xx, yy, cx, cy, dot_sigma, gain, d)
    return torch.floor(torch.clamp(bg + (fg - bg) * v, 0, 255))


def spots_frames(
    times,
    width: int = 346,
    height: int = 260,
    contrast: float = 1.5,
    total_time: float = 1.0,
    freq_hz: float = 20.0,
    radius: float = 60.0,
    bg: float = 64.0,
    device=None,
) -> torch.Tensor:
    """Flashing, then moving, disks and squares of four sizes: f32[F,H,W]."""
    dev = resolve_device(device)
    tf = _f32(times, dev)
    t = tf[:, None, None]
    gray = bg
    bright = gray * contrast
    dark = gray / contrast
    half = total_time / 2
    xx, yy = _grid(width, height, dev)

    moving = (tf > half)[:, None, None]
    speed = radius / half
    dxs = torch.where(moving, -radius + (t - half) * speed, 0.0)
    sine = torch.sin(t * freq_hz * math.pi * 2)
    flash = torch.where(sine.abs() < 0.5, gray, torch.where(sine > 0.5, bright, dark))
    color = torch.where(moving, dark, flash)

    # the host truncates float64 coordinates with int(); in float32 an exact
    # 63.0 can land at 62.999996, so nudge before truncating (the
    # coordinates are rational with >= 1e-3 spacing)
    def itrunc(x):
        return torch.trunc(x + torch.sign(x) * 1e-3)

    def disk(cx, cy, r):
        dx = xx - itrunc(cx)
        dy = yy - itrunc(cy)
        return dx * dx + dy * dy <= r * r

    def rect(cx, cy, r):
        return ((xx >= itrunc(cx - r)) & (xx <= itrunc(cx + r))
                & (yy >= itrunc(cy - r)) & (yy <= itrunc(cy + r)))

    w, h, r = width, height, radius
    cx1 = w / 4 + dxs
    cx2 = 3 * w / 4 + dxs
    mask = (
        disk(cx1, torch.full_like(cx1, h / 4), r / 8)
        | rect(cx2, torch.full_like(cx2, h / 4), r / 4)
        | disk(cx1, torch.full_like(cx1, 3 * h / 4), r / 2)
        | rect(cx2, torch.full_like(cx2, 3 * h / 4), r)
    )
    return torch.floor(torch.clamp(torch.where(mask, color, gray), 0, 255))


def barberpole_frames(
    times,
    width: int = 346,
    height: int = 260,
    contrast: float = 1.5,
    speed_pps: float = 1000.0,
    num_stripes: int = 6,
    bb_width: float = 0.8,
    bb_height: float = 0.2,
    bb_angle: float = 30.0,
    bg: float = 127.0,
    device=None,
) -> torch.Tensor:
    """Drifting diagonal stripes masked to a central window: f32[F,H,W]."""
    dev = resolve_device(device)
    t = _f32(times, dev)[:, None, None]
    wavelength = (bb_width * width) / num_stripes
    low = (bg * 2) / (contrast + 1)
    diff = (contrast - 1) * low
    tan = math.tan((90 - bb_angle) * math.pi / 180)
    xx, yy = _grid(width, height, dev)

    arg = 2 * math.pi * (yy - tan * xx - t * speed_pps)
    phase = arg / scalar(wavelength, arg)
    stripes = torch.floor(low + diff * 0.5 * (1 + torch.tanh(10 * torch.sin(phase))))

    dx = (1 - bb_width) / 2
    dy = (1 - bb_height) / 2
    minx, maxx = round(width * dx), width - round(width * dx)
    miny, maxy = round(height * dy), height - round(height * dy)
    inside = (xx > minx) & (xx < maxx) & (yy > miny) & (yy < maxy)
    return torch.where(inside, stripes, bg)


def gradients_frames(
    times,
    width: int = 346,
    height: int = 260,
    contrast: float = 2.0,
    speed_pps: float = 300.0,
    bump_width: float = 0.5,
    bg: float = 127.0,
    device=None,
) -> torch.Tensor:
    """A triangular bump trailed by a 10 px edge, sweeping right:
    f32[F,H,W], contiguous (each row is the same)."""
    dev = resolve_device(device)
    t = _f32(times, dev)[:, None]
    low = (bg * 2) / (contrast + 1)
    high = contrast * low
    diff = high - low
    w2 = (bump_width * width) / 2

    x = torch.arange(width, dtype=_F32, device=dev)[None, :]
    p = w2 + t * speed_pps
    p2 = p + w2 * 2
    g = torch.full((t.shape[0], width), low, dtype=_F32, device=dev)
    g = torch.where((x > p - w2) & (x < p), high + (-diff / w2) * (p - x), g)
    g = torch.where((x <= p + w2) & (x >= p), high + (-diff / w2) * (x - p), g)
    g = torch.where((x > p2) & (x <= p2 + 10), high, g)
    g = torch.floor(torch.clamp(g, 0, 255))
    # a real [F,H,W] tensor, not a stride-0 view: the emulator's kernels
    # take dense frames
    return g[:, None, :].expand(-1, height, -1).contiguous()


def particles_frames(
    centers,
    width: int = 346,
    height: int = 260,
    fg: float = 6.25,
    bg: float = 5.0,
    sigma: float = 1.0,
    gain: float = 2.0,
    d: int = 3,
    device=None,
) -> torch.Tensor:
    """Particle dots for a chunk: f32[F,H,W] from centers [F,P,2] (x, y)
    per frame and particle, computed by the host's walker (a chunk of 64
    frames of 300 walkers is 150 KiB, under half of one 346x260 frame).

    Keeps the host painter's OVERWRITE order (draw.fill_gaussian_dot under
    particles.next_frame): a later particle's whole [round(c)-d,
    round(c)+d) patch replaces earlier dots where patches overlap, dim tail
    values included.  Two scatters: the first takes each pixel's largest
    particle index, the second writes each entry only where its particle
    owns the pixel, so the surviving writes have distinct destinations.
    Values match the host to float32 rounding (~1e-5; the host draws in
    float64 and stores float32).
    """
    dev = resolve_device(device)
    c = _f32(centers, dev)
    F, P, _ = c.shape
    cx, cy = c[..., 0], c[..., 1]  # [F,P]
    x0 = torch.round(cx)  # half to even, as Python's round()
    y0 = torch.round(cy)
    span = torch.arange(-d, d, dtype=_F32, device=dev)  # the patch [c-d, c+d)
    xs = x0[..., None, None] + span[None, None, None, :]  # [F,P,1,2d]
    ys = y0[..., None, None] + span[None, None, :, None]  # [F,P,2d,1]
    dx = xs - cx[..., None, None]
    dy = ys - cy[..., None, None]
    dist2 = dx * dx + dy * dy
    v = torch.clamp(gain * torch.exp(-dist2 / scalar(sigma * sigma, dist2)), max=1.0)
    vals = torch.clamp(bg + (fg - bg) * v, 0.0, 255.0)  # [F,P,2d,2d]

    xi = xs.to(torch.int64)
    yi = ys.to(torch.int64)
    valid = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    fidx = torch.arange(F, dtype=torch.int64, device=dev)[:, None, None, None]
    size = F * height * width
    # off-sensor entries go to one extra slot, `size`, sliced off at the
    # end (torch has no dropping scatter, and a negative index would wrap
    # to the last pixel)
    lin = torch.where(valid, (fidx * height + yi) * width + xi, size).reshape(-1)
    prio_val = torch.arange(1, P + 1, dtype=torch.int64, device=dev)[None, :, None, None]
    prio_val = prio_val.expand(vals.shape).reshape(-1)

    prio = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    prio.scatter_reduce_(0, lin, prio_val, "amax")
    win = valid.reshape(-1) & (prio[lin] == prio_val)
    frames = torch.full((size + 1,), bg, dtype=_F32, device=dev)
    frames.scatter_(0, torch.where(win, lin, size), vals.reshape(-1))
    return frames[:size].reshape(F, height, width)
