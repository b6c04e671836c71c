"""Barberpole-illusion synthetic input: drifting diagonal stripes in a
window (a copy of v2e_tpu/synthetic/barberpole.py; `device_frames` renders
on the port's device).

Behavioral equivalent of reference scripts/barberpole.py: tanh-sharpened
sinusoidal stripes at angle bb_angle drifting at speed_pps, masked to a
central rectangle on gray background.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Tuple

import numpy as np

from v2e_tpu_torch.synthetic.base import base_synthetic_input
from v2e_tpu_torch.synthetic.device import barberpole_frames

logger = logging.getLogger(__name__)


class barberpole(base_synthetic_input):
    CONTRAST = 1.5
    TOTAL_TIME = 1.0
    DT = 100e-6
    SPEED_PPS = 1000.0
    NUM_STRIPES = 6
    BB_WIDTH = 0.8
    BB_HEIGHT = 0.2
    BB_ANGLE = 30.0

    def __init__(self, width=346, height=260, avi_path=None, preview=False,
                 arg_list=None, parent_args=None) -> None:
        super().__init__(width, height, avi_path, preview, arg_list, parent_args)
        parser = argparse.ArgumentParser("barberpole")
        parser.add_argument("--num_stripes", type=int, default=self.NUM_STRIPES)
        parser.add_argument("--contrast", type=float, default=self.CONTRAST)
        parser.add_argument("--total_time", type=float, default=self.TOTAL_TIME)
        parser.add_argument("--speed_pps", type=float, default=self.SPEED_PPS)
        parser.add_argument("--dt", type=float, default=self.DT)
        parser.add_argument("--bb_width", type=float, default=self.BB_WIDTH)
        parser.add_argument("--bb_height", type=float, default=self.BB_HEIGHT)
        parser.add_argument("--bb_angle", type=float, default=self.BB_ANGLE)
        args, _ = parser.parse_known_args(arg_list)

        self.contrast = args.contrast
        self.dt = args.dt
        self.t_total = args.total_time
        self.speed_pps = args.speed_pps
        self.num_stripes = args.num_stripes
        self.bb_width = args.bb_width
        self.bb_height = args.bb_height
        self.bb_angle = args.bb_angle
        self.times = np.arange(0, self.t_total, self.dt)

        yy = np.arange(self.height)[:, None]
        xx = np.arange(self.width)[None, :]
        self._y, self._x = yy, xx
        dx = (1 - self.bb_width) / 2
        dy = (1 - self.bb_height) / 2
        minx, maxx = round(self.width * dx), self.width - round(self.width * dx)
        miny, maxy = round(self.height * dy), self.height - round(self.height * dy)
        self._outside = ~(
            (xx > minx) & (xx < maxx) & (yy > miny) & (yy < maxy)
        )

    def total_frames(self) -> int:
        return len(self.times)

    def device_frames(self, times: np.ndarray, device=None):
        """Render a chunk of frames on `device` (default the CUDA device)
        with synthetic/device.py; returns f32[F,H,W] there."""
        self.frame_number += len(times)
        return barberpole_frames(
            times, self.width, self.height,
            float(self.contrast), float(self.speed_pps),
            int(self.num_stripes), float(self.bb_width),
            float(self.bb_height), float(self.bb_angle), float(self.bg),
            device=device,
        )

    def _stripes(self, t: float) -> np.ndarray:
        wavelength = (self.bb_width * self.width) / self.num_stripes
        low = (self.bg * 2) / (self.contrast + 1)
        diff = (self.contrast - 1) * low
        tan = np.tan((90 - self.bb_angle) * np.pi / 180)
        phase = 2 * np.pi * (self._y - tan * self._x - t * self.speed_pps) / wavelength
        s = np.floor(low + diff * 0.5 * (1 + np.tanh(10 * np.sin(phase))))
        return s.astype(np.uint8)

    def next_frame(self) -> Tuple[Optional[np.ndarray], float]:
        if self.frame_number >= len(self.times):
            logger.info(f"finished after {self.frame_number} frames")
            return None, float(self.times[-1])
        t = float(self.times[self.frame_number])
        pix = self._stripes(t)
        pix[self._outside] = self.bg
        self.pix_arr = pix
        self.write_video_frame(pix)
        self.frame_number += 1
        return pix, t
