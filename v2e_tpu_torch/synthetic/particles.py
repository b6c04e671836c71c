"""Particles synthetic input: many linear random walkers with respawn (a
copy of v2e_tpu/synthetic/particles.py; `device_frames` renders on the
port's device).

Behavioral equivalent of reference scripts/particles.py: particles move on
straight lines at uniform-random speeds, respawn when leaving the array
(optionally spawning on edges), and are drawn as saturated-Gaussian dots at
the configured contrast.  Supports HDR (log intensity) backgrounds.
State is kept in vectorized arrays instead of per-particle objects.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Tuple

import numpy as np

from v2e_tpu_torch.synthetic.base import base_synthetic_input
from v2e_tpu_torch.synthetic.device import particles_frames
from v2e_tpu_torch.synthetic.draw import paint_gaussian_dots

logger = logging.getLogger(__name__)


class particles(base_synthetic_input):
    CONTRAST = 1.25
    TOTAL_TIME = 1.0
    NUM_PARTICLES = 300
    RADIUS = 1.0
    DT = 100e-6
    SPEED_MIN = 3.0
    SPEED_MAX = 100.0

    def __init__(self, width=346, height=260, avi_path=None, preview=False,
                 arg_list=None, parent_args=None) -> None:
        super().__init__(width, height, avi_path, preview, arg_list, parent_args)
        parser = argparse.ArgumentParser("particles")
        parser.add_argument("--num_particles", type=int, default=self.NUM_PARTICLES)
        parser.add_argument("--contrast", type=float, default=self.CONTRAST)
        parser.add_argument("--bg", type=float, default=self.BACKGROUND)
        parser.add_argument("--radius", type=float, default=self.RADIUS)
        parser.add_argument("--total_time", type=float, default=self.TOTAL_TIME)
        parser.add_argument("--speed_min", type=float, default=self.SPEED_MIN)
        parser.add_argument("--speed_max", type=float, default=self.SPEED_MAX)
        parser.add_argument("--dt", type=float, default=self.DT)
        parser.add_argument("--edge", action="store_true",
                            help="spawn particles on edges moving inward")
        args, _ = parser.parse_known_args(arg_list)

        self.contrast = args.contrast
        self.dt = args.dt
        self.radius = args.radius
        self.speed_min = args.speed_min
        self.speed_max = args.speed_max
        self.num_particles = args.num_particles
        self.t_total = args.total_time
        self.start_on_edge = args.edge
        self.particle_count = 0

        self.bg = float(args.bg)
        self.fg = self.bg * self.contrast
        hdr = bool(getattr(parent_args, "hdr", False)) if parent_args else False
        if hdr:
            self.bg = float(np.log(self.bg))
            self.fg = float(np.log(self.fg))

        self._rng = np.random.default_rng()
        self.pos = np.empty((self.num_particles, 2))
        self.vel = np.empty((self.num_particles, 2))
        for i in range(self.num_particles):
            self._spawn(i)

        self.times = np.arange(0, self.t_total, self.dt)
        self.time = 0.0
        logger.info(
            f"particles: {self.num_particles} walkers, speed "
            f"{self.speed_min}-{self.speed_max} px/s, contrast {self.contrast} "
            f"(log_e {np.log(self.contrast):.3f}), duration {self.t_total}s"
        )

    def _spawn(self, i: int) -> None:
        rng = self._rng
        if self.start_on_edge:
            edge = rng.integers(0, 4)
            if edge in (0, 1):  # north / south edges
                x = rng.integers(0, self.width)
                y = 0 if edge == 0 else self.height
            else:  # east / west
                y = rng.integers(0, self.height)
                x = 0 if edge == 3 else self.width
        else:
            x = rng.uniform(0, self.width)
            y = rng.uniform(0, self.height)
        angle = rng.uniform(0, 2 * np.pi)
        speed = rng.uniform(self.speed_min, self.speed_max)
        self.pos[i] = (x, y)
        self.vel[i] = (speed * np.cos(angle), speed * np.sin(angle))
        self.particle_count += 1

    def total_frames(self) -> int:
        return len(self.times)

    def _advance_to(self, t: float) -> None:
        """Step walker dynamics to time t (move, respawn out-of-bounds)."""
        dt = t - self.time
        self.time = t
        self.pos += dt * self.vel
        oob = (
            (self.pos[:, 0] < 0)
            | (self.pos[:, 0] > self.width)
            | (self.pos[:, 1] < 0)
            | (self.pos[:, 1] > self.height)
        )
        for i in np.flatnonzero(oob):
            self._spawn(i)

    def trajectory(self, times: np.ndarray) -> np.ndarray:
        """Advance the dynamics over `times`, returning the per-frame
        particle centers [F, P, 2] — the host half of the device-rendered
        path (see synthetic/device.py::particles_frames)."""
        out = np.empty((len(times), self.num_particles, 2), dtype=np.float32)
        for k, t in enumerate(times):
            self._advance_to(float(t))
            out[k] = self.pos
        return out

    def device_frames(self, times: np.ndarray, device=None):
        """Render a chunk of frames on `device` (default the CUDA device)
        from the host walker's centers with synthetic/device.py; returns
        f32[F,H,W] there."""
        centers = self.trajectory(times)
        self.frame_number += len(times)
        return particles_frames(
            centers, self.width, self.height,
            float(self.fg), float(self.bg), float(self.radius), 2.0,
            int(self.radius * 2) + 1,
            device=device,
        )

    def next_frame(self) -> Tuple[Optional[np.ndarray], float]:
        if self.frame_number >= len(self.times):
            logger.info(
                f"finished after {self.frame_number} frames, "
                f"{self.particle_count:,} particles made"
            )
            return None, float(self.times[-1])
        t = float(self.times[self.frame_number])
        self._advance_to(t)

        pix = paint_gaussian_dots(self.pos, self.width, self.height, self.fg, self.bg,
                                  self.radius, 2.0, int(self.radius * 2) + 1)
        self.write_video_frame(np.clip(pix, 0, 255))
        self.frame_number += 1
        self.pix_arr = pix
        return pix, t

    def cleanup(self) -> None:
        logger.info(
            f"particles generated {self.particle_count:,} particles in {self.time:.3f}s"
        )
        super().cleanup()
