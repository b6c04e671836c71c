"""Extract APS video + real DVS events from a DDD recording (port of
dataset_tools/ddd_extract_data.py, the original v2e's
dataset_scripts/ddd/ddd_extract_data.py): writes the APS frames as an AVI
(+ frame times) and the DVS events as AEDAT-2.0.  Host only (h5py, cv2).

Usage:
  python -m v2e_tpu_torch.dataset_tools.ddd_extract_data -i rec.hdf5 -o out \\
      --start_time 10 --stop_time 20
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output_folder", default="ddd-extract-output")
    p.add_argument("--start_time", type=float, default=None)
    p.add_argument("--stop_time", type=float, default=None)
    p.add_argument("--rotate180", type=lambda s: s.lower() != "false", default=True)
    args = p.parse_args(argv)

    os.makedirs(args.output_folder, exist_ok=True)
    from v2e_tpu_torch.io.aedat2 import AEDat2Output
    from v2e_tpu_torch.io.ddd import DDD20SimpleReader
    from v2e_tpu_torch.utils.video import video_writer

    reader = DDD20SimpleReader(args.input, rotate180=args.rotate180)
    frames, events = reader.readEntire(args.start_time, args.stop_time)
    reader.close()
    if not len(frames):
        logger.error("no frames found in window")
        return 1
    H, W = frames["frame"][0].shape

    import cv2

    vw = video_writer(os.path.join(args.output_folder, "aps.avi"), H, W)
    with open(os.path.join(args.output_folder, "aps-frame_times.txt"), "w") as f:
        f.write("# frame# time(s)\n")
        for i, (ts, frame) in enumerate(zip(frames["ts"], frames["frame"])):
            vw.write(cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR))
            f.write(f"{i}\t{ts:10.6f}\n")
    vw.release()

    w = AEDat2Output(os.path.join(args.output_folder, "dvs.aedat"), W, H)
    w.appendEvents(events)
    w.close()
    logger.info(
        f"wrote {len(frames)} APS frames and {events.shape[0]:,} events to "
        f"{args.output_folder}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
