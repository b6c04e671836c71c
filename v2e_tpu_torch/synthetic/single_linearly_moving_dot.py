"""Single dot translating linearly across the array (a copy of
v2e_tpu/synthetic/single_linearly_moving_dot.py; `device_frames` renders on
the port's device).

Behavioral equivalent of reference scripts/single_linearly_moving_dot.py:
one Gaussian dot (sigma 3, contrast 3 on bg 100) crossing the full width at
100 px/s with 100 us frames.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from v2e_tpu_torch.synthetic.base import base_synthetic_input
from v2e_tpu_torch.synthetic.device import single_linearly_moving_dot_frames
from v2e_tpu_torch.synthetic.draw import fill_gaussian_dot

logger = logging.getLogger(__name__)


class single_linearly_moving_dot(base_synthetic_input):
    def __init__(self, width=346, height=260, avi_path=None, preview=False,
                 arg_list=None, parent_args=None) -> None:
        super().__init__(width, height, avi_path, preview, arg_list, parent_args)
        self.contrast = 3.0
        self.bg = 100
        self.dt = 100e-6
        self.dot_sigma = 3.0
        self.speed_pps = 100.0
        self.t_total = width / self.speed_pps
        self.times = np.arange(0, self.t_total, self.dt)
        self.fg = int(self.bg * self.contrast)
        self.d = int(self.dot_sigma * 3)

    def total_frames(self) -> int:
        return len(self.times)

    def device_frames(self, times: np.ndarray, device=None):
        """Render a chunk of frames on `device` (default the CUDA device)
        with synthetic/device.py; returns f32[F,H,W] there."""
        self.frame_number += len(times)
        return single_linearly_moving_dot_frames(
            times, self.width, self.height,
            float(self.contrast), float(self.bg), float(self.dot_sigma),
            float(self.speed_pps),
            device=device,
        )

    def next_frame(self) -> Tuple[Optional[np.ndarray], float]:
        if self.frame_number >= len(self.times):
            logger.info(f"finished after {self.frame_number} frames")
            return None, float(self.times[-1])
        t = float(self.times[self.frame_number])
        pix = np.full((self.height, self.width), self.bg, dtype=np.uint8)
        x = t * self.speed_pps
        y = self.height / 2
        fill_gaussian_dot(pix, x, y, self.fg, self.bg, self.dot_sigma,
                          gain=10.0, d=self.d, clip_low=0.01)
        self.write_video_frame(pix)
        self.frame_number += 1
        self.pix_arr = pix
        return pix, t
