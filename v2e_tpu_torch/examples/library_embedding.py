"""Library embedding example: push frames, get events (the port's copy of
examples/library_embedding.py).

Construct an `EventEmulator`, feed luma frames with their times and
receive AER arrays [N,4] = [t, x, y, p]: first frame by frame, as the
original v2e's API does, then the rest as one chunk.

    python -m v2e_tpu_torch.examples.library_embedding [--device cpu] [video.avi]

Runs on the CUDA device unless --device says otherwise.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def read_frames(path: Optional[str], n: int = 100):
    """Up to `n` luma frames of a video and its frame rate, or without a
    path 60 frames of a drifting 160x120 gradient at 30 fps."""
    if path is None:
        xx = np.mgrid[0:120, 0:160][1].astype(np.float32)
        frames = np.stack(
            [np.clip(100 + 50 * np.sin((xx + 3 * i) / 19), 0, 255) for i in range(60)]
        ).astype(np.uint8)
        return frames, 30.0
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while len(frames) < n:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2GRAY))
    cap.release()
    return np.stack(frames), fps


def main(argv: Optional[List[str]] = None) -> int:
    from v2e_tpu_torch import EventEmulator

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("video", nargs="?", default=None, help="input video (default: synthetic)")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    a = p.parse_args(argv)

    emulator = EventEmulator(
        pos_thres=0.2,
        neg_thres=0.2,
        sigma_thres=0.03,
        cutoff_hz=200,
        leak_rate_hz=1,
        shot_noise_rate_hz=10,
        seed=42,
        device=a.device,
    )
    frames, fps = read_frames(a.video)
    dt = 1.0 / fps

    # frame at a time, as the original v2e
    for i in range(5):
        events = emulator.generate_events(frames[i].astype(np.float32), i * dt)
        n = 0 if events is None else events.shape[0]
        print(f"frame {i}: {n} events")

    # the rest as one chunk on the device
    rest = frames[5:]
    times = (5 + np.arange(len(rest))) * dt
    events = emulator.generate_events_batch(rest, times)
    n = 0 if events is None else events.shape[0]
    print(f"chunk of {len(rest)} frames: {n} events")
    print(
        f"totals: {emulator.num_events_total} events "
        f"({emulator.num_events_on} on / {emulator.num_events_off} off)"
    )
    emulator.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
