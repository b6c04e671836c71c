"""Calibrate DVS thresholds against a real DDD recording (port of
dataset_tools/ddd_find_thresholds.py; the original v2e's
dataset_scripts/ddd/ddd_find_thresholds.py and thres_estimator.py): finds
the (pos, neg) thresholds that make the emulator's event counts over a
time window match the real DVS counts, by in-process bisection
(`v2e_tpu_torch.analysis.estimate_thresholds`, the emulator on the card
unless `device` names another).

Usage:
  python -m v2e_tpu_torch.dataset_tools.ddd_find_thresholds -i rec.hdf5 \\
      --start_time 70 --stop_time 75
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

logger = logging.getLogger(__name__)


def main(argv=None, device=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--start_time", type=float, default=None)
    p.add_argument("--stop_time", type=float, default=None)
    p.add_argument("--thres_low", type=float, default=0.02)
    p.add_argument("--thres_high", type=float, default=1.0)
    p.add_argument("--max_iter", type=int, default=12)
    p.add_argument("--rotate180", type=lambda s: s.lower() != "false", default=True)
    # emulator knobs forwarded to the probe runs (reference runs the full
    # v2e CLI per probe and inherits its noise defaults; exposing these
    # lets calibration run with noise disabled for a sharper match)
    p.add_argument("--cutoff_hz", type=float, default=None)
    p.add_argument("--leak_rate_hz", type=float, default=None)
    p.add_argument("--shot_noise_rate_hz", type=float, default=None)
    p.add_argument("--sigma_thres", type=float, default=None)
    args = p.parse_args(argv)

    em_kw = {
        k: getattr(args, k)
        for k in ("cutoff_hz", "leak_rate_hz", "shot_noise_rate_hz",
                  "sigma_thres")
        if getattr(args, k) is not None
    }

    from v2e_tpu_torch.analysis import estimate_thresholds
    from v2e_tpu_torch.io.ddd import DDD20SimpleReader

    reader = DDD20SimpleReader(args.input, rotate180=args.rotate180)
    frames, events = reader.readEntire(args.start_time, args.stop_time)
    reader.close()
    if not len(frames):
        logger.error("no frames in window")
        return 1

    target_on = int(np.sum(events[:, 3] > 0))
    target_off = int(np.sum(events[:, 3] < 0))
    logger.info(f"real DVS counts in window: {target_on:,} ON, {target_off:,} OFF")

    pos, neg = estimate_thresholds(
        frames["frame"].astype(np.float32),
        frames["ts"].astype(np.float64),
        target_on,
        target_off,
        thres_low=args.thres_low,
        thres_high=args.thres_high,
        max_iter=args.max_iter,
        device=device,
        **em_kw,
    )
    print(f"pos_thres={pos:.4f} neg_thres={neg:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
