"""Render synthetic motion videos for SuperSloMo training (a copy of
dataset_tools/make_training_videos.py; numpy, and cv2 to write the AVIs).

Grayscale clips with dense, smooth, ground-truth-interpolable motion —
translating textures, moving Gaussian blobs, rotating bars — so
`train_slomo` can train a real checkpoint from nothing else (the committed
golden fixture's data source).  `render_clip` draws exactly what the JAX
package's tool draws from the same generator.

Usage:
  python -m v2e_tpu_torch.dataset_tools.make_training_videos -o trainvids \\
      --n_videos 8 --frames 120 --size 160 192
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def render_clip(kind: str, n: int, H: int, W: int, rng) -> np.ndarray:
    """[n,H,W] u8 frames with smooth subpixel motion."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = np.empty((n, H, W), np.uint8)
    if kind == "texture":
        # drifting sum of oriented sinusoids: dense flow everywhere
        k = rng.uniform(0.04, 0.25, size=(3, 2)).astype(np.float32)
        ph = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
        amp = rng.uniform(20, 45, size=3).astype(np.float32)
        v = rng.uniform(-3, 3, size=2).astype(np.float32)  # px/frame
        for i in range(n):
            img = np.full((H, W), 110.0, np.float32)
            for j in range(3):
                img += amp[j] * np.sin(
                    k[j, 0] * (xx - v[0] * i) + k[j, 1] * (yy - v[1] * i)
                    + ph[j]
                )
            frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    elif kind == "blobs":
        m = rng.integers(3, 7)
        pos = rng.uniform([0, 0], [W, H], size=(m, 2)).astype(np.float32)
        vel = rng.uniform(-2.5, 2.5, size=(m, 2)).astype(np.float32)
        sig = rng.uniform(6, 18, size=m).astype(np.float32)
        bright = rng.uniform(60, 120, size=m).astype(np.float32)
        for i in range(n):
            img = np.full((H, W), 70.0, np.float32)
            p = pos + vel * i
            px = np.mod(p[:, 0], W)
            py = np.mod(p[:, 1], H)
            for j in range(m):
                img += bright[j] * np.exp(
                    -(((xx - px[j]) ** 2 + (yy - py[j]) ** 2)
                      / (2 * sig[j] ** 2))
                )
            frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    elif kind == "bar":
        # rotating bright bar: rotational flow field
        cx, cy = W / 2, H / 2
        w0 = rng.uniform(0.01, 0.04) * (1 if rng.random() < 0.5 else -1)
        width = rng.uniform(4, 10)
        for i in range(n):
            th = w0 * i
            d = np.abs(
                (xx - cx) * np.sin(th) - (yy - cy) * np.cos(th)
            )
            img = 70.0 + 140.0 * np.exp(-(d ** 2) / (2 * width ** 2))
            frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    else:
        raise ValueError(kind)
    return frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--n_videos", type=int, default=9)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--size", type=int, nargs=2, default=[160, 192],
                   help="H W (training crops must fit inside)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import cv2

    os.makedirs(args.output_dir, exist_ok=True)
    H, W = args.size
    rng = np.random.default_rng(args.seed)
    kinds = ["texture", "blobs", "bar"]
    for i in range(args.n_videos):
        kind = kinds[i % len(kinds)]
        frames = render_clip(kind, args.frames, H, W, rng)
        path = os.path.join(args.output_dir, f"{kind}_{i:02d}.avi")
        vw = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"XVID"), 30.0, (W, H)
        )
        for fr in frames:
            vw.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
        vw.release()
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
