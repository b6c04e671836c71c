"""Side-by-side real-vs-synthetic DVS conversion of a DDD recording (port
of dataset_tools/ddd_v2e.py; the original v2e's
dataset_scripts/ddd/ddd-v2e.py).

Reads a DDD20 HDF5 recording and writes the REAL DVS events and, from the
APS frame stream (SloMo-interpolated), the SYNTHETIC v2e events: two
AEDAT-2 files and two DVS videos for visual and statistical comparison.
SuperSloMo and the emulator run on the card unless `device` names another.

Usage:
  python -m v2e_tpu_torch.dataset_tools.ddd_v2e -i rec1501350986.hdf5 -o out \\
      --start_time 70 --stop_time 90 --pos_thres 0.2 --neg_thres 0.2 \\
      --timestamp_resolution 0.001
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

logger = logging.getLogger(__name__)


def main(argv=None, device=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input", required=True, help="DDD .hdf5 recording")
    p.add_argument("-o", "--output_folder", default="ddd-v2e-output")
    p.add_argument("--start_time", type=float, default=None)
    p.add_argument("--stop_time", type=float, default=None)
    p.add_argument("--pos_thres", type=float, default=0.2)
    p.add_argument("--neg_thres", type=float, default=0.2)
    p.add_argument("--sigma_thres", type=float, default=0.03)
    p.add_argument("--cutoff_hz", type=float, default=300)
    p.add_argument("--leak_rate_hz", type=float, default=0.01)
    p.add_argument("--shot_noise_rate_hz", type=float, default=0.001)
    p.add_argument("--timestamp_resolution", type=float, default=0.001,
                   help="DVS timestamp resolution; sets SloMo upsampling")
    p.add_argument("--disable_slomo", action="store_true")
    p.add_argument("--slomo_model", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--dvs_exposure_s", type=float, default=0.01)
    p.add_argument("--numpy_output", action="store_true",
                   help="also dump real/synthetic event arrays as .npy")
    p.add_argument("--rotate180", type=lambda s: s.lower() != "false", default=True)
    args = p.parse_args(argv)

    os.makedirs(args.output_folder, exist_ok=True)

    from v2e_tpu_torch.emulator import EventEmulator
    from v2e_tpu_torch.io.ddd import DDD20SimpleReader
    from v2e_tpu_torch.render import EventRenderer, ExposureMode

    reader = DDD20SimpleReader(args.input, rotate180=args.rotate180)
    frames, real_events = reader.readEntire(args.start_time, args.stop_time)
    if not len(frames):
        logger.error("no APS frames in the selected window")
        return 1
    H, W = frames["frame"][0].shape
    logger.info(
        f"read {len(frames)} APS frames and {real_events.shape[0]:,} real "
        f"DVS events ({H}x{W})"
    )

    # --- real DVS stream: AEDAT + video ---
    from v2e_tpu_torch.io.aedat2 import AEDat2Output

    real_aedat = AEDat2Output(
        os.path.join(args.output_folder, "ddd-real.aedat"), W, H
    )
    real_aedat.appendEvents(real_events)
    real_aedat.close()
    real_renderer = EventRenderer(
        output_path=args.output_folder, dvs_vid="dvs-video-real.avi",
        exposure_mode=ExposureMode.DURATION, exposure_value=args.dvs_exposure_s,
    )
    real_renderer.render_events_to_frames(real_events, H, W)
    real_renderer.cleanup()

    # --- synthetic stream from APS frames ---
    emulator = EventEmulator(
        pos_thres=args.pos_thres, neg_thres=args.neg_thres,
        sigma_thres=args.sigma_thres, cutoff_hz=args.cutoff_hz,
        leak_rate_hz=args.leak_rate_hz,
        shot_noise_rate_hz=args.shot_noise_rate_hz,
        output_folder=args.output_folder, dvs_aedat2="ddd-v2e.aedat",
        output_width=W, output_height=H, seed=42, device=device,
    )
    fake_renderer = EventRenderer(
        output_path=args.output_folder, dvs_vid="dvs-video-fake.avi",
        exposure_mode=ExposureMode.DURATION, exposure_value=args.dvs_exposure_s,
    )

    ts = frames["ts"].astype(np.float64)
    aps = frames["frame"].astype(np.float32)
    synthetic = []
    if args.disable_slomo:
        ev = emulator.generate_events_batch(aps, ts)
        if ev is not None:
            synthetic.append(ev)
            fake_renderer.render_events_to_frames(ev, H, W)
    else:
        from v2e_tpu_torch.models.slomo import SuperSloMo

        src_interval = float(np.median(np.diff(ts))) if len(ts) > 1 else 0.04
        U = max(int(np.ceil(src_interval / args.timestamp_resolution)), 2)
        slomo = SuperSloMo(
            model=args.slomo_model, auto_upsample=False, upsampling_factor=U,
            batch_size=args.batch_size,
            allow_random=getattr(args, "allow_random_slomo", False),
            device=device,
        )
        B = args.batch_size
        for s in range(0, len(aps) - 1, B):
            chunk = aps[s : s + B + 1]
            tchunk = ts[s : s + B + 1]
            if chunk.shape[0] < 2:
                break
            interp, u = slomo.interpolate_batch(chunk, H, W)
            n_pairs = chunk.shape[0] - 1
            # per-pair linear times (APS intervals vary slightly)
            times = np.concatenate([
                tchunk[k] + np.arange(u) / u * (tchunk[k + 1] - tchunk[k])
                for k in range(n_pairs)
            ])
            ev = emulator.generate_events_batch(interp, times)
            if ev is not None:
                synthetic.append(ev)
                fake_renderer.render_events_to_frames(ev, H, W)

    fake_renderer.cleanup()
    emulator.cleanup()
    reader.close()

    syn = np.concatenate(synthetic) if synthetic else np.empty((0, 4))
    logger.info(
        f"real: {real_events.shape[0]:,} events, synthetic: {syn.shape[0]:,} events"
    )
    if args.numpy_output:
        np.save(os.path.join(args.output_folder, "events-real.npy"), real_events)
        np.save(os.path.join(args.output_folder, "events-v2e.npy"), syn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
