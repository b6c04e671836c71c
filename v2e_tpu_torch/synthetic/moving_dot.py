"""Moving-dot synthetic input: Gaussian dots on a shrinking circular path (a
copy of v2e_tpu/synthetic/moving_dot.py; `device_frames` renders on the
port's device).

Behavioral equivalent of reference scripts/moving_dot.py (constant angular
speed dots whose circle radius decays so the path never overlaps itself);
drawing is the vectorized saturated-Gaussian patch (draw.py) instead of the
Numba loop.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Tuple

import numpy as np

from v2e_tpu_torch.synthetic.base import base_synthetic_input
from v2e_tpu_torch.synthetic.device import moving_dot_frames
from v2e_tpu_torch.synthetic.draw import fill_gaussian_dot

logger = logging.getLogger(__name__)


class moving_dot(base_synthetic_input):
    def __init__(self, width=346, height=260, avi_path=None, preview=False,
                 arg_list=None, parent_args=None) -> None:
        super().__init__(width, height, avi_path, preview, arg_list, parent_args)
        parser = argparse.ArgumentParser("moving_dot")
        parser.add_argument("--num_particles", type=int, default=5)
        parser.add_argument("--contrast", type=float, default=10)
        parser.add_argument("--bg", type=float, default=5)
        parser.add_argument("--radius", type=float, default=100)
        parser.add_argument("--cycles", type=float, default=None,
                            help="number of cycles of moving dots")
        parser.add_argument("--dt", type=float, default=100e-6,
                            help="time step in seconds")
        parser.add_argument("--t_total", type=float, default=None,
                            help="total time in seconds (else use cycles)")
        args, _ = parser.parse_known_args(arg_list)

        if (args.cycles is None) == (args.t_total is None):
            # default to 1 cycle when neither/both given
            if args.cycles is None and args.t_total is None:
                args.cycles = 1.0
            else:
                raise ValueError("specify either --cycles or --t_total, not both")

        self.speed_pps = 1000.0
        self.dot_sigma = 1.0
        self.radius = args.radius
        self.dt = args.dt
        self.num_dots = args.num_particles
        self.contrast = args.contrast
        self.bg = args.bg
        self.circum = 2 * np.pi * self.radius
        self.period = self.circum / self.speed_pps

        if args.t_total is not None:
            self.t_total = args.t_total
            self.cycles = self.t_total / self.period
        else:
            self.cycles = args.cycles
            self.t_total = self.circum * self.cycles / self.speed_pps

        self.times = np.arange(0, self.t_total, self.dt)
        self.theta = 2 * np.pi * self.cycles * (self.times / self.t_total)
        self.fg = int(self.bg * self.contrast)
        self.d = int(self.dot_sigma * 3)
        logger.info(
            f"moving_dot: speed={self.speed_pps} px/s, contrast={self.contrast} "
            f"(log_e {np.log(self.contrast):.3f}), bg={self.bg}, fg={self.fg}, "
            f"duration={self.t_total}s, cycles={self.cycles}, dt={self.dt}s"
        )

    def total_frames(self) -> int:
        return len(self.times)

    def device_frames(self, times: np.ndarray, device=None):
        """Render a chunk of frames on `device` (default the CUDA device)
        with synthetic/device.py; returns f32[F,H,W] there."""
        self.frame_number += len(times)
        return moving_dot_frames(
            times, self.width, self.height, self.num_dots,
            float(self.contrast), float(self.bg), float(self.radius),
            float(self.speed_pps), float(self.dot_sigma),
            device=device,
        )

    def next_frame(self) -> Tuple[Optional[np.ndarray], float]:
        if self.frame_number >= len(self.times):
            logger.info(f"finished after {self.frame_number} frames")
            return None, float(self.times[-1])
        t = float(self.times[self.frame_number])
        pix = np.full((self.height, self.width), self.bg, dtype=np.uint8)
        if self.contrast != 1:
            # radius shrinks ~2 dot radii per cycle so the path never overlaps
            cycles = t / self.period
            radius = self.radius - cycles * self.d * 1.5
            for i in range(self.num_dots):
                theta = self.theta[self.frame_number] + (i / self.num_dots) * 2 * np.pi
                x = self.width / 2 + radius * np.cos(theta)
                y = self.height / 2 + radius * np.sin(theta)
                fill_gaussian_dot(
                    pix, x, y, self.fg, self.bg, self.dot_sigma,
                    gain=10.0, d=self.d, clip_low=0.01,
                )
        self.write_video_frame(pix)
        self.frame_number += 1
        self.pix_arr = pix
        return pix, t
