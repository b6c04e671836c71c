"""Batch-convert a video dataset (UCF-101 / ILSVRC style) to DVS events
with the port's CLI (a copy of dataset_tools/batch_convert.py).

Walks a directory tree of videos and converts each through the full
SloMo + emulator pipeline (`v2e_tpu_torch.cli.main`, one call per video, on
the card unless `device` names another), mirroring the directory structure
in the output.  Flags it does not know are passed on to every conversion.

Usage:
  python -m v2e_tpu_torch.dataset_tools.batch_convert -i /data/UCF-101 \\
      -o /data/UCF-101-dvs --timestamp_resolution 0.0001 --dvs_h5 events.h5 \\
      --extensions .avi .mp4
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

logger = logging.getLogger(__name__)


def find_videos(root: str, extensions) -> list:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in extensions:
                out.append(os.path.join(dirpath, f))
    return out


def main(argv=None, device=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input_dir", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--extensions", nargs="+", default=[".avi", ".mp4", ".mov"])
    p.add_argument("--timestamp_resolution", type=float, default=0.0001)
    p.add_argument("--auto_timestamp_resolution", default="true")
    p.add_argument("--dvs_h5", default="events.h5")
    p.add_argument("--dvs_aedat2", default=None)
    p.add_argument("--dvs_text", default=None)
    p.add_argument("--output_width", type=int, default=346)
    p.add_argument("--output_height", type=int, default=260)
    p.add_argument("--dvs_params", default=None)
    p.add_argument("--disable_slomo", action="store_true")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--limit", type=int, default=None, help="convert at most N videos")
    p.add_argument("--skip_existing", action="store_true")
    args, extra = p.parse_known_args(argv)

    from v2e_tpu_torch.cli import main as v2e_main

    videos = find_videos(args.input_dir, set(args.extensions))
    if args.limit:
        videos = videos[: args.limit]
    logger.info(f"batch-converting {len(videos)} videos from {args.input_dir}")

    failures = 0
    for i, vid in enumerate(videos):
        rel = os.path.relpath(vid, args.input_dir)
        out_folder = os.path.join(args.output_dir, os.path.splitext(rel)[0])
        if args.skip_existing and os.path.isdir(out_folder):
            logger.info(f"[{i+1}/{len(videos)}] skipping existing {out_folder}")
            continue
        logger.info(f"[{i+1}/{len(videos)}] {vid} -> {out_folder}")
        argv_one = [
            "-i", vid,
            "--output_folder", out_folder,
            "--unique_output_folder", "false",
            "--overwrite",
            "--output_width", str(args.output_width),
            "--output_height", str(args.output_height),
            "--timestamp_resolution", str(args.timestamp_resolution),
            "--auto_timestamp_resolution", args.auto_timestamp_resolution,
            "--batch_size", str(args.batch_size),
            "--skip_video_output",
        ] + extra
        if args.dvs_h5:
            argv_one += ["--dvs_h5", args.dvs_h5]
        if args.dvs_aedat2:
            argv_one += ["--dvs_aedat2", args.dvs_aedat2]
        if args.dvs_text:
            argv_one += ["--dvs_text", args.dvs_text]
        if args.dvs_params:
            argv_one += ["--dvs_params", args.dvs_params]
        if args.disable_slomo:
            argv_one += ["--disable_slomo"]
        try:
            rc = v2e_main(argv_one, device=device)
            if rc != 0:
                failures += 1
        except Exception as e:
            logger.error(f"conversion of {vid} failed: {e}")
            failures += 1
    logger.info(f"done; {failures} failures out of {len(videos)}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
