"""The v2e DVS pixel model in plain PyTorch, frame by frame, in float64
(Hu, Liu and Delbruck, "v2e: From Video Frames to Realistic DVS Events",
CVPRW 2021, and the public v2e emulator).

Per pixel and frame at time t, dt after the previous frame:
* log intensity: linear below 20 DN (x ln 20 / 20), ln x above;
* photoreceptor lowpass: lp += eps (log - lp), eps = min(1, (x + 20)/275
  dt 2 pi f_c) (brighter pixels are faster);
* leak: the memorized base falls by dt leak_rate rate_fpn (1 - jitter n)
  theta_on, n a standard normal drawn per pixel and frame;
* events: floor(max(+-(lp - base), 0) / theta) ON or OFF crossings, placed
  on the frame's grid t_prev + (i+1) dt/K (K the frame's largest count);
  with a refractory period R > dt/K a crossing passes only if more than R
  after the pixel's last event; the base moves by each passed crossing's
  threshold;
* shot noise: ON where u > 1 - f theta_nom/theta_on, OFF where u < f
  theta_nom/theta_off, f = rate/2 dt ((0.25 - 1)(x + 20)/275 + 1), u a
  uniform drawn per pixel and frame; a shot event resets the base to lp;
* per pixel, once: thresholds theta ~ N(0.2, sigma) clamped at 0.01, and a
  lognormal noise-rate FPN of `noise_rate_cov_decades`.

The random numbers are the port's: `NoiseSchedule` draws them from a
torch.Generator on the run's device, seeded with the emulator seed, in the
order and shapes the port's emulator draws them (a frozen copy of that
schedule: at the first frame the two threshold normals and the rate
normal, then per chunk of F frames the leak normals [F,H,W] and the shot
uniforms [F,H,W]).  So the reference and the port see the same noise and
their events can be compared one pixel at a time.

`dtype` chooses the pixel planes' arithmetic (times stay float64):
float64 is the reference, bfloat16 the control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch

LIN_LOG_DN = 20.0


@dataclass
class PixelConfig:
    pos_thres: float = 0.2
    neg_thres: float = 0.2
    sigma_thres: float = 0.03
    cutoff_hz: float = 300.0
    leak_rate_hz: float = 0.01
    leak_jitter_fraction: float = 0.1
    noise_rate_cov_decades: float = 0.1
    refractory_period_s: float = 0.0005
    shot_noise_rate_hz: float = 0.001
    shot_noise_inten_factor: float = 0.25

    @classmethod
    def from_dict(cls, d: dict) -> "PixelConfig":
        return cls(**{k: float(v) for k, v in d.items() if k in cls.__dataclass_fields__})


class NoiseSchedule:
    """The port's draws, in its order (see the module note)."""

    def __init__(self, cfg: PixelConfig, seed: int, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.g = torch.Generator(device=self.device).manual_seed(seed)

    def init(self, shape):
        def normal():
            return torch.randn(shape, generator=self.g, dtype=torch.float32, device=self.device)
        pos = normal() if self.cfg.sigma_thres > 0 else None
        neg = normal() if self.cfg.sigma_thres > 0 else None
        rate = normal() if self.cfg.leak_rate_hz > 0 else None
        return pos, neg, rate

    def chunk(self, n_frames: int, shape):
        full = (n_frames, *shape)
        leak = (torch.randn(full, generator=self.g, device=self.device)
                if self.cfg.leak_rate_hz > 0 else None)
        shot = (torch.rand(full, generator=self.g, device=self.device)
                if self.cfg.shot_noise_rate_hz > 0 else None)
        return leak, shot


class PixelArray:
    """The emulator on a plane of pixels, driven chunk by chunk."""

    def __init__(self, cfg: PixelConfig, seed: int, device, dtype=torch.float64):
        self.cfg = cfg
        self.noise = NoiseSchedule(cfg, seed, device)
        self.device = torch.device(device)
        self.dtype = dtype
        self.t_prev: Optional[float] = None

    def _lin_log(self, x):
        return torch.where(x <= LIN_LOG_DN, x * (math.log(LIN_LOG_DN) / LIN_LOG_DN),
                           torch.log(torch.clamp(x, min=1e-20)))

    def start(self, frame: torch.Tensor, t: float) -> None:
        """The first frame: draw the per-pixel constants, set the state."""
        c, dt = self.cfg, self.dtype
        shape = tuple(frame.shape)
        pos_n, neg_n, rate_n = self.noise.init(shape)
        if pos_n is not None:
            self.pos = torch.clamp(c.pos_thres + c.sigma_thres * pos_n.double(), min=0.01)
            self.neg = torch.clamp(c.neg_thres + c.sigma_thres * neg_n.double(), min=0.01)
        else:
            self.pos = torch.full(shape, c.pos_thres, dtype=torch.float64, device=self.device)
            self.neg = torch.full(shape, c.neg_thres, dtype=torch.float64, device=self.device)
        self.rate = (torch.exp(math.log(10.0) * c.noise_rate_cov_decades * rate_n.double())
                     if rate_n is not None else torch.ones(shape, dtype=torch.float64, device=self.device))
        self.pos_pre = (c.pos_thres / self.pos).to(dt)
        self.neg_pre = (c.neg_thres / self.neg).to(dt)
        self.pos, self.neg, self.rate = self.pos.to(dt), self.neg.to(dt), self.rate.to(dt)
        x = frame.to(torch.float64)
        self.lp = self._lin_log(x).to(dt)
        self.base = self.lp.clone()
        self.mem = torch.full(shape, t - c.refractory_period_s, dtype=torch.float64, device=self.device)
        self.t_prev = float(t)

    def load(self, base, lp, mem_rel, t_origin: float, t_prev: float) -> None:
        """Take a pixel state (base, lowpass, last spike times relative to
        `t_origin`) and the previous frame's absolute time."""
        self.base = base.to(torch.float64).to(self.dtype)
        self.lp = lp.to(torch.float64).to(self.dtype)
        self.mem = t_origin + mem_rel.to(torch.float64)
        self.t_prev = float(t_prev)

    def run_chunk(self, frames: torch.Tensor, times: List[float]):
        """Frames [F,H,W] (0-255) at absolute times -> (ON counts, OFF
        counts) [H,W] int32 summed over the chunk."""
        c, dt_ = self.cfg, self.dtype
        F_, H, W = frames.shape
        leak_n, shot_u = self.noise.chunk(F_, (H, W))
        on = torch.zeros((H, W), dtype=torch.int32, device=self.device)
        off = torch.zeros_like(on)
        R = c.refractory_period_s
        tau = 1.0 / (2 * math.pi * c.cutoff_hz) if c.cutoff_hz > 0 else None
        for f in range(F_):
            t = float(times[f])
            dt = t - self.t_prev
            x = frames[f].to(torch.float64)
            inten01 = ((x + 20.0) / 275.0).to(dt_)
            log_new = self._lin_log(x).to(dt_)
            if tau is not None:
                eps = torch.clamp(inten01 * (dt / tau), max=1.0)
                self.lp = (1.0 - eps) * self.lp + eps * log_new
            else:
                self.lp = log_new
            if c.leak_rate_hz > 0:
                jitter = 1.0 - c.leak_jitter_fraction * leak_n[f].to(dt_)
                self.base = self.base - (dt * c.leak_rate_hz) * self.rate * jitter * self.pos
            diff = self.lp - self.base
            n_pos = torch.floor(torch.clamp(diff, min=0) / self.pos).to(torch.int32)
            n_neg = torch.floor(torch.clamp(-diff, min=0) / self.neg).to(torch.int32)
            count = n_pos + n_neg
            n = count
            if R > 0:
                # the frame's grid step, kept on the device (no host sync)
                step = max(dt, 1e-12) / torch.clamp(count.max(), min=1).to(torch.float64)
                q = (self.mem + R - self.t_prev) / step
                i0 = torch.clamp(torch.floor(q), min=0)
                m = torch.floor(R / step) + 1
                has = (count > 0) & (i0 <= count - 1)
                n_r = torch.where(has, torch.floor((count - 1 - i0) / m) + 1, 0.0)
                t_last = self.t_prev + (i0 + (n_r - 1) * m + 1) * step
                active = R > step
                self.mem = torch.where(active & (n_r > 0), t_last, self.mem)
                n = torch.where(active, n_r.to(torch.int32), count)
            pos_e = torch.where(n_pos > 0, n, 0)
            neg_e = torch.where(n_neg > 0, n, 0)
            self.base = self.base + pos_e.to(dt_) * self.pos - neg_e.to(dt_) * self.neg
            on += pos_e
            off += neg_e
            if c.shot_noise_rate_hz > 0:
                fac = (c.shot_noise_rate_hz / 2.0 * dt) * ((c.shot_noise_inten_factor - 1.0) * inten01 + 1.0)
                u = shot_u[f].to(dt_)
                s_on = u > 1.0 - fac * self.pos_pre
                s_off = u < fac * self.neg_pre
                self.base = torch.where(s_on | s_off, self.lp, self.base)
                on += s_on.to(torch.int32)
                off += s_off.to(torch.int32)
            self.t_prev = t
        return on, off
