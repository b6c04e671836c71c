"""Spots synthetic input: flashing then moving disks/squares of 4 sizes (a
copy of v2e_tpu/synthetic/spots.py; `device_frames` renders on the port's
device).

Behavioral equivalent of reference scripts/spots.py: the first half of the
run the shapes flash at freq Hz (square-ish via thresholded sine); the
second half they translate by one radius.  skimage.draw is replaced by the
numpy disk/rect fills in draw.py.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Tuple

import numpy as np

from v2e_tpu_torch.synthetic.base import base_synthetic_input
from v2e_tpu_torch.synthetic.device import spots_frames
from v2e_tpu_torch.synthetic.draw import fill_disk, fill_rect

logger = logging.getLogger(__name__)


class spots(base_synthetic_input):
    CONTRAST = 1.5
    TOTAL_TIME_S = 1.0
    DT_S = 100e-6
    RADIUS_PIX = 60.0
    FREQ_HZ = 20.0

    def __init__(self, width=346, height=260, avi_path=None, preview=False,
                 arg_list=None, parent_args=None) -> None:
        super().__init__(width, height, avi_path, preview, arg_list, parent_args)
        parser = argparse.ArgumentParser("spots")
        parser.add_argument("--contrast", type=float, default=self.CONTRAST)
        parser.add_argument("--total_time", type=float, default=self.TOTAL_TIME_S)
        parser.add_argument("--dt", type=float, default=self.DT_S)
        parser.add_argument("--freq", type=float, default=self.FREQ_HZ)
        args, _ = parser.parse_known_args(arg_list)

        self.contrast = args.contrast
        self.dt = args.dt
        self.t_total = args.total_time
        self.freq = args.freq
        self.bg = 64
        self.radius = self.RADIUS_PIX
        self.times = np.arange(0, self.t_total, self.dt)
        self._last_video_t = -1.0

    def total_frames(self) -> int:
        return len(self.times)

    def device_frames(self, times: np.ndarray, device=None):
        """Render a chunk of frames on `device` (default the CUDA device)
        with synthetic/device.py; returns f32[F,H,W] there."""
        self.frame_number += len(times)
        return spots_frames(
            times, self.width, self.height,
            float(self.contrast), float(self.t_total), float(self.freq),
            float(self.radius), float(self.bg),
            device=device,
        )

    def _draw(self, t: float) -> np.ndarray:
        gray = self.bg
        bright = gray * self.contrast
        dark = gray / self.contrast
        frame = np.full((self.height, self.width), gray, dtype=np.uint8)
        half = self.t_total / 2
        w, h, r = self.width, self.height, self.radius
        if t > half:  # moving phase: shapes shift by one radius over half run
            speed = r / half
            dx = -r + (t - half) * speed
            color = dark
            fill_disk(frame, color, r / 8, w / 4 + dx, h / 4)
            fill_rect(frame, color, r / 4, 3 * w / 4 + dx, h / 4)
            fill_disk(frame, color, r / 2, w / 4 + dx, 3 * h / 4)
            fill_rect(frame, color, r, 3 * w / 4 + dx, 3 * h / 4)
        else:  # flashing phase
            sine = np.sin(t * self.freq * np.pi * 2)
            color = gray if abs(sine) < 0.5 else (bright if sine > 0.5 else dark)
            fill_disk(frame, color, r / 8, w / 4, h / 4)
            fill_rect(frame, color, r / 4, 3 * w / 4, h / 4)
            fill_disk(frame, color, r / 2, w / 4, 3 * h / 4)
            fill_rect(frame, color, r, 3 * w / 4, 3 * h / 4)
        return frame

    def next_frame(self) -> Tuple[Optional[np.ndarray], float]:
        if self.frame_number >= len(self.times):
            logger.info(f"finished after {self.frame_number} frames")
            return None, float(self.times[-1])
        t = float(self.times[self.frame_number])
        self.pix_arr = self._draw(t)
        if self.video_writer is not None and (
            t == 0 or t > self._last_video_t + 1e-3
        ):
            self.write_video_frame(self.pix_arr)
            self._last_video_t = t
        self.frame_number += 1
        return self.pix_arr, t
