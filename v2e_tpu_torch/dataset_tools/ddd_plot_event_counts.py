"""Plot binned ON/OFF event rates of real vs synthetic streams in an ROI
(port of dataset_tools/ddd_plot_event_counts.py).  Takes the .npy event
dumps of `v2e_tpu_torch.dataset_tools.ddd_v2e --numpy_output`.  Host only
(numpy, matplotlib).

Usage:
  python -m v2e_tpu_torch.dataset_tools.ddd_plot_event_counts \\
      --real out/events-real.npy --v2e out/events-v2e.npy \\
      --roi_x 100 200 --roi_y 80 160 --bin_ms 50 -o counts.png
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--real", required=True, help=".npy of real events [N,4]")
    p.add_argument("--v2e", required=True, help=".npy of synthetic events")
    p.add_argument("--roi_x", type=int, nargs=2, default=None)
    p.add_argument("--roi_y", type=int, nargs=2, default=None)
    p.add_argument("--bin_ms", type=float, default=50.0)
    p.add_argument("-o", "--output", default="event-counts.png")
    args = p.parse_args(argv)

    from v2e_tpu_torch.utils.roi import histogram_events_in_time_bins, select_events_in_roi

    real = np.load(args.real)
    syn = np.load(args.v2e)
    roi_x = tuple(args.roi_x) if args.roi_x else None
    roi_y = tuple(args.roi_y) if args.roi_y else None
    real = select_events_in_roi(real, roi_x, roi_y)
    syn = select_events_in_roi(syn, roi_x, roi_y)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    for ax, pol, name in ((axes[0], 1, "ON"), (axes[1], -1, "OFF")):
        for ev, label, style in ((real, "real DVS", "-"), (syn, "v2e", "--")):
            h = histogram_events_in_time_bins(
                ev, time_bin_ms=args.bin_ms, polarity=pol
            )
            ax.plot(h[:, 0], h[:, 1] / (args.bin_ms * 1e-3), style, label=label)
        ax.set_ylabel(f"{name} rate (Hz)")
        ax.legend()
    axes[1].set_xlabel("time (s)")
    fig.suptitle(f"event rates, ROI x={roi_x} y={roi_y}, bin {args.bin_ms} ms")
    fig.savefig(args.output, dpi=120)
    logger.info(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
