"""The benchmark's one traffic generator: every input a cell feeds the
program is made here from the cell's parameters and the run's seed.

A cell's file (cells/<name>.json) names a `source` with a `kind` and its
parameters; `make_source` returns a `Source`: a bounded loop of u8 frames
made on the host before the clock starts, and the time between frames.
The loop is replayed as long as the run needs frames; every loop is
seamless, so replaying it adds no jump to the motion.

Kinds:
* "texture_blob": the JAX package's bench scene (bench.py, also copied as
  v2e_tpu_torch/synthetic/source.py): a sinusoidal texture drifting
  `drift_px` px per frame plus a bright Gaussian blob moving `blob_px` px
  per frame, at `fps`.  The seed draws the texture's phases and the blob's
  start.  The loop runs `loop_frames` frames forward and back, so every
  pair keeps the same speed.
* "moving_dot": the reference's moving-dot stimulus (scripts/moving_dot.py,
  v2e_tpu_torch/synthetic/moving_dot.py): `num_dots` saturated Gaussian
  dots (sigma 1 px, gain 10) on a circle of `radius` px at `speed_pps`
  px/s, sampled every `dt` s.  One cycle at a fixed radius is the loop.
  The seed draws the dots' start angle and a static background pattern of
  `bg` to `bg + bg_spread` levels (static pixels make no events).

`training_clips` writes the training cell's clips: seeded drifting
textures (the sum-of-sinusoids law of make_training_videos.py), grayscale,
written as XVID AVIs as that tool writes them.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import List

import numpy as np


@dataclasses.dataclass
class Source:
    """A seamless loop of u8 frames [n, H, W] and the seconds between
    frames; frame i of the stream is frames[i % n]."""

    frames: np.ndarray
    frame_interval: float

    def frame(self, i: int) -> np.ndarray:
        return self.frames[i % self.frames.shape[0]]


def seed_rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one use of the run's seed (any whole number,
    also past 2**32), separate for each `stream` name."""
    tag = int.from_bytes(stream.encode(), "little") % (1 << 61)
    return np.random.default_rng([seed % (1 << 63), seed >> 63, tag])


def texture_blob(params: dict, H: int, W: int, seed: int) -> Source:
    rng = seed_rng(seed, "texture_blob")
    n = int(params["loop_frames"])
    drift = float(params.get("drift_px", 2.0))
    blob_px = float(params.get("blob_px", 5.0))
    phx = rng.uniform(0.0, 2 * math.pi * 17.0)
    phy = rng.uniform(0.0, 2 * math.pi * 13.0)
    cx0 = rng.uniform(0.0, W)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    fwd = np.empty((n, H, W), dtype=np.uint8)
    for i in range(n):
        fr = 100 + 40 * np.sin((xx + phx + drift * i) / 17.0) * np.cos((yy + phy) / 13.0)
        cx = (cx0 + blob_px * i) % W
        blob = 80 * np.exp(-(((xx - cx) ** 2 + (yy - H / 2) ** 2) / (2 * 15.0 ** 2)))
        fwd[i] = np.clip(fr + blob, 0, 255).astype(np.uint8)
    # forward then back (without repeating either end): a seamless loop
    frames = np.concatenate([fwd, fwd[-2:0:-1]])
    return Source(frames, 1.0 / float(params["fps"]))


def moving_dot(params: dict, H: int, W: int, seed: int) -> Source:
    rng = seed_rng(seed, "moving_dot")
    dt = float(params["dt"])
    radius = float(params["radius"])
    speed = float(params["speed_pps"])
    num = int(params["num_dots"])
    bg = float(params["bg"])
    fg = float(int(bg * float(params["contrast"])))
    sigma, gain, d = 1.0, 10.0, 3
    n = int(round(2 * math.pi * radius / speed / dt))  # one cycle
    theta0 = rng.uniform(0.0, 2 * math.pi)
    pattern = rng.integers(0, int(params.get("bg_spread", 0)) + 1, size=(H, W))
    frames = np.empty((n, H, W), dtype=np.uint8)
    frames[:] = np.clip(bg + pattern, 0, 255).astype(np.uint8)[None]
    theta = theta0 + 2 * math.pi * np.arange(n)[:, None] / n + 2 * math.pi * np.arange(num)[None] / num
    cx = W / 2 + radius * np.cos(theta)  # [n, num]
    cy = H / 2 + radius * np.sin(theta)
    offs = np.arange(-d, d)
    f_idx = np.arange(n)
    for j in range(num):
        x0 = np.round(cx[:, j]).astype(np.int64)
        y0 = np.round(cy[:, j]).astype(np.int64)
        xs = x0[:, None] + offs[None]  # [n, 2d]
        ys = y0[:, None] + offs[None]
        dx = xs - cx[:, j, None]
        dy = ys - cy[:, j, None]
        v = gain * np.exp(-(dy[:, :, None] ** 2 + dx[:, None, :] ** 2) / sigma ** 2)
        v = np.minimum(v, 1.0)
        v = np.where(v < 0.01, 0.0, v)
        vals = np.clip(bg + (fg - bg) * v, 0, 255).astype(np.uint8)  # [n, 2d, 2d]
        ok = ((ys >= 0) & (ys < H))[:, :, None] & ((xs >= 0) & (xs < W))[:, None, :]
        fi = np.broadcast_to(f_idx[:, None, None], ok.shape)[ok]
        yi = np.broadcast_to(ys[:, :, None], ok.shape)[ok]
        xi = np.broadcast_to(xs[:, None, :], ok.shape)[ok]
        frames[fi, yi, xi] = vals[ok]
    return Source(frames, dt)


KINDS = {"texture_blob": texture_blob, "moving_dot": moving_dot}


def make_source(params: dict, H: int, W: int, seed: int) -> Source:
    """The cell's source loop, from its `source` parameters and the seed."""
    return KINDS[params["kind"]](params, H, W, seed)


def render_texture_clip(n: int, H: int, W: int, rng: np.random.Generator) -> np.ndarray:
    """[n, H, W] u8: a drifting sum of three oriented sinusoids."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    k = rng.uniform(0.04, 0.25, size=(3, 2)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
    amp = rng.uniform(20, 45, size=3).astype(np.float32)
    v = rng.uniform(-3, 3, size=2).astype(np.float32)  # px/frame
    frames = np.empty((n, H, W), np.uint8)
    for i in range(n):
        img = np.full((H, W), 110.0, np.float32)
        for j in range(3):
            img += amp[j] * np.sin(k[j, 0] * (xx - v[0] * i) + k[j, 1] * (yy - v[1] * i) + ph[j])
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def training_clips(folder: str, params: dict, seed: int) -> List[str]:
    """Write the cell's training clips (`count` clips of `frames` frames of
    `size` = [H, W]) as XVID AVIs into `folder`; returns their paths in the
    order the program's tool lists them (sorted)."""
    import cv2

    os.makedirs(folder, exist_ok=True)
    rng = seed_rng(seed, "training_clips")
    H, W = params["size"]
    paths = []
    for i in range(int(params["count"])):
        frames = render_texture_clip(int(params["frames"]), H, W, rng)
        path = os.path.join(folder, f"clip_{i:02d}.avi")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), 30.0, (W, H))
        for fr in frames:
            vw.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
        vw.release()
        paths.append(path)
    return sorted(paths)
