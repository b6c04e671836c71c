"""Gradients synthetic input: moving triangular intensity bump + sharp edge
(a copy of v2e_tpu/synthetic/gradients.py; `device_frames` renders on the
port's device).

Behavioral equivalent of reference scripts/gradients.py: a triangular bump
of configurable contrast sweeps rightward at speed_pps, trailed by a
10-pixel square step to probe high spatial frequencies.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Tuple

import numpy as np

from v2e_tpu_torch.synthetic.base import base_synthetic_input
from v2e_tpu_torch.synthetic.device import gradients_frames

logger = logging.getLogger(__name__)


class gradients(base_synthetic_input):
    CONTRAST = 2.0
    TOTAL_TIME = 1.0
    DT = 100e-6
    SPEED_PPS = 300.0
    BUMP_WIDTH = 0.5  # fraction of array width

    def __init__(self, width=346, height=260, avi_path=None, preview=False,
                 arg_list=None, parent_args=None) -> None:
        super().__init__(width, height, avi_path, preview, arg_list, parent_args)
        parser = argparse.ArgumentParser("gradients")
        parser.add_argument("--contrast", type=float, default=self.CONTRAST)
        parser.add_argument("--total_time", type=float, default=self.TOTAL_TIME)
        parser.add_argument("--speed_pps", type=float, default=self.SPEED_PPS)
        parser.add_argument("--dt", type=float, default=self.DT)
        parser.add_argument("--bump_width", type=float, default=self.BUMP_WIDTH)
        args, _ = parser.parse_known_args(arg_list)

        self.contrast = args.contrast
        self.dt = args.dt
        self.t_total = args.total_time
        self.speed_pps = args.speed_pps
        self.bump_width = args.bump_width
        self.times = np.arange(0, self.t_total, self.dt)
        self.x = np.arange(self.width)
        self._last_video_t = 0.0

    def total_frames(self) -> int:
        return len(self.times)

    def device_frames(self, times: np.ndarray, device=None):
        """Render a chunk of frames on `device` (default the CUDA device)
        with synthetic/device.py; returns f32[F,H,W] there."""
        self.frame_number += len(times)
        return gradients_frames(
            times, self.width, self.height,
            float(self.contrast), float(self.speed_pps),
            float(self.bump_width), float(self.bg),
            device=device,
        )

    def _image(self, t: float) -> np.ndarray:
        low = (self.bg * 2) / (self.contrast + 1)
        high = self.contrast * low
        diff = high - low
        w2 = (self.bump_width * self.width) / 2
        p = w2 + t * self.speed_pps  # bump center
        p2 = p + w2 * 2  # sharp edge position
        x = self.x
        g = np.full(self.width, low)
        left = (x > p - w2) & (x < p)
        g[left] = high + (-diff / w2) * (p - x[left])
        right = (x <= p + w2) & (x >= p)
        g[right] = high + (-diff / w2) * (x[right] - p)
        g[(x > p2) & (x <= p2 + 10)] = high
        return np.broadcast_to(
            g.astype(np.uint8)[None, :], (self.height, self.width)
        ).copy()

    def next_frame(self) -> Tuple[Optional[np.ndarray], float]:
        if self.frame_number >= len(self.times):
            logger.info(f"finished after {self.frame_number} frames")
            return None, float(self.times[-1])
        t = float(self.times[self.frame_number])
        self.pix_arr = self._image(t)
        if self.video_writer is not None and t > self._last_video_t + 1 / 30.0:
            self.write_video_frame(self.pix_arr)
            self._last_video_t = t
        self.frame_number += 1
        return self.pix_arr, t
