"""Evaluate a trained SuperSloMo checkpoint: held-out PSNR vs the
no-motion frame-average baseline (port of scripts/eval_slomo_ckpt.py).

A held-out clip of smooth motion (`render_clip("texture", ...)` from its
own seed) is subsampled U-fold and interpolated back; a model that learned
motion compensation beats the frame-average baseline, random weights
cannot.  Runs on the card unless `device` names another.

Usage:
  python -m v2e_tpu_torch.dataset_tools.eval_slomo_ckpt <ckpt.npz|ckpt> [--res H W]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0**2 / mse)


def evaluate(ckpt: str, res=(128, 160), upsampling: int = 4, pairs: int = 4,
             seed: int = 77, device=None) -> Dict[str, float]:
    """{"model": mean PSNR of the interpolated frames, "average": the
    frame-average baseline's, "base": the checkpoint's UNet width}."""
    from v2e_tpu_torch.dataset_tools.make_training_videos import render_clip
    from v2e_tpu_torch.models.slomo import SuperSloMo

    H, W = res
    U = upsampling
    rng = np.random.default_rng(seed)
    hi = render_clip("texture", pairs * U + 1, H, W, rng)
    src = hi[::U].astype(np.float32)

    slomo = SuperSloMo(model=ckpt, auto_upsample=False, upsampling_factor=U,
                       batch_size=pairs, device=device)
    interp, _ = slomo.interpolate_batch(src, H, W)
    interp = interp.cpu().numpy()

    ps_model, ps_avg = [], []
    for pair in range(pairs):
        for i in range(1, U):
            gt = hi[pair * U + i]
            ps_model.append(psnr(interp[pair * U + i], gt))
            avg = ((1 - i / U) * hi[pair * U].astype(np.float64)
                   + (i / U) * hi[(pair + 1) * U].astype(np.float64))
            ps_avg.append(psnr(avg, gt))
    return {"model": float(np.mean(ps_model)), "average": float(np.mean(ps_avg)),
            "base": slomo.flow_net.base}


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ckpt")
    p.add_argument("--res", type=int, nargs=2, default=[128, 160],
                   help="held-out clip resolution (multiples of 32)")
    p.add_argument("--upsampling", type=int, default=4)
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--seed", type=int, default=77)
    args = p.parse_args(argv)

    r = evaluate(args.ckpt, tuple(args.res), args.upsampling, args.pairs, args.seed, device)
    m, a = r["model"], r["average"]
    H, W = args.res
    print(f"ckpt={args.ckpt} base={r['base']} res={H}x{W} U={args.upsampling} "
          f"pairs={args.pairs} seed={args.seed}")
    print(f"model PSNR {m:.2f} dB | frame-average baseline {a:.2f} dB | "
          f"margin {m - a:+.2f} dB")
    return 0 if m > a else 1


if __name__ == "__main__":
    sys.exit(main())
