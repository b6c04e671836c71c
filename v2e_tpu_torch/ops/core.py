"""Core DVS pixel-model math on tensors (port of v2e_tpu/ops/core.py).

Float32 throughout, with the reference's operation order.  The random
draws the JAX functions take a PRNG key for (leak jitter, shot noise) are
passed in here as tensors, so a test can hand both packages the same
numbers.

The reference's XLA programs contract a multiply feeding an add into one
fused multiply-add.  Where that decides the result bit for bit (the
memorized base update and the refractory spike time), the port evaluates
``a*b + c`` once in float64 and rounds to float32 (`fma_f32`): the product
of two float32 values is exact in float64, so this equals the float32 FMA
except at double-rounding ties (about 2^-29 of updates).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from v2e_tpu_torch.device import scalar

LIN_LOG_THRESHOLD = 20.0

# largest float32 below 2^31: float -> int32 casts clamp here first, so the
# conversion saturates on every backend instead of being undefined
I32_MAX_F = 2147483520.0


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` rounded once to float32 (see the module note)."""
    return (a.double() * b.double() + c.double()).float()


@functools.lru_cache(maxsize=None)
def _serial_first_vml_calls() -> None:
    """Make the process's first call of MKL's vector log and exp serial.

    On the CPU torch.log and torch.exp call MKL's VML (vsLn, vdExp, ...)
    on each thread's chunk of the tensor.  VML picks its implementation of
    a function on the function's first call, and when several threads make
    that first call at once, one of them may run a different one: in about
    one process in ten, one thread's chunk of the first parallel torch.log
    came back up to 80 ulp off (3.7e-5 at 5.0), every later call exact.
    A first call on a few elements runs on the calling thread alone.
    """
    for dtype in (torch.float32, torch.float64):
        x = torch.ones(8, dtype=dtype)
        torch.log(x)
        torch.exp(x)


def lin_log(x: torch.Tensor, threshold: float = LIN_LOG_THRESHOLD) -> torch.Tensor:
    """Linear-to-log intensity map of 0-255 frames: linear below
    `threshold` DN, natural log above (v2e_tpu ops/core.py:23).

    torch.log is correctly rounded; XLA's CPU log is not, and differs from
    it by one ulp at 47, 49 and 179 DN.
    """
    f = (1.0 / threshold) * math.log(threshold)
    xf = x.to(torch.float32)
    if xf.device.type == "cpu":
        _serial_first_vml_calls()
    safe = torch.clamp(xf, min=1e-20)
    return torch.where(xf <= threshold, xf * scalar(f, xf), torch.log(safe))


def rescale_intensity_frame(new_frame: torch.Tensor) -> torch.Tensor:
    """0-255 intensity to the (0,1] filter-time-constant scale."""
    return (new_frame + 20.0) / scalar(275.0, new_frame)


def low_pass_filter(
    log_new_frame: torch.Tensor,
    lp_log_frame: torch.Tensor,
    inten01: Optional[torch.Tensor],
    delta_time: torch.Tensor,
    cutoff_hz: float = 0.0,
) -> torch.Tensor:
    """One frame of the intensity-dependent first-order IIR lowpass of the
    log intensity: ``eps = inten01 * dt / tau`` clamped to 1 (brighter
    pixels are faster); a passthrough when ``cutoff_hz <= 0``."""
    if cutoff_hz <= 0:
        return log_new_frame
    tau = scalar(1.0 / (math.pi * 2 * cutoff_hz), log_new_frame)
    if inten01 is not None:
        eps = torch.clamp(inten01 * (delta_time / tau), max=1.0)
    else:
        eps = delta_time / tau
    return (1.0 - eps) * lp_log_frame + eps * log_new_frame


def subtract_leak_current(
    base_log_frame: torch.Tensor,
    leak_rate_hz: float,
    delta_time: torch.Tensor,
    pos_thres: torch.Tensor,
    leak_jitter_fraction: float,
    noise_rate_array: torch.Tensor,
    rand: torch.Tensor,
) -> torch.Tensor:
    """Leak the memorized value downward; `rand` is the standard-normal
    per-pixel jitter draw."""
    curr_leak_rate = (
        leak_rate_hz * noise_rate_array * (1.0 - leak_jitter_fraction * rand)
    )
    delta_leak = delta_time * curr_leak_rate * pos_thres
    return base_log_frame - delta_leak


def compute_event_map(
    diff_frame: torch.Tensor, pos_thres: torch.Tensor, neg_thres: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``floor(relu(±diff) / thres)`` as int32 ON and OFF count maps."""
    pos_frame = torch.clamp(diff_frame, min=0.0)
    neg_frame = torch.clamp(-diff_frame, min=0.0)
    pos_evts = torch.floor(pos_frame / pos_thres).to(torch.int32)
    neg_evts = torch.floor(neg_frame / neg_thres).to(torch.int32)
    return pos_evts, neg_evts


def generate_shot_noise(
    rand01: torch.Tensor,
    shot_noise_rate_hz: float,
    delta_time: torch.Tensor,
    shot_noise_inten_factor: float,
    inten01: torch.Tensor,
    pos_thres_pre_prob: torch.Tensor,
    neg_thres_pre_prob: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bernoulli shot-noise ON/OFF maps from one uniform draw per pixel."""
    shot_noise_factor = ((shot_noise_rate_hz / 2.0) * delta_time) * (
        (shot_noise_inten_factor - 1.0) * inten01 + 1.0
    )
    one_minus_on_prob = 1.0 - shot_noise_factor * pos_thres_pre_prob
    off_prob = shot_noise_factor * neg_thres_pre_prob
    return rand01 > one_minus_on_prob, rand01 < off_prob


def refractory_filter(
    count: torch.Tensor,
    timestamp_mem: torch.Tensor,
    t_prev: torch.Tensor,
    ts_step: torch.Tensor,
    refractory_period_s: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form refractory filter (v2e_tpu ops/core.py:179).

    The candidate timestamps of a pixel are the grid ``t_prev + (i+1)*s``,
    so the events that survive form an arithmetic progression: first index
    ``i0``, stride ``m``, count ``n``.  The filter engages only when
    ``R > s``.  Returns (n_emit, i0, stride, new_timestamp_mem).
    """
    R = scalar(refractory_period_s, count)
    active = R > ts_step

    q = (timestamp_mem + R - t_prev) / ts_step
    i0 = torch.clamp(torch.floor(q), 0.0, I32_MAX_F).to(torch.int32)
    m = torch.clamp(torch.floor(R / ts_step) + 1.0, max=I32_MAX_F).to(torch.int32)

    has = (count > 0) & (i0 <= count - 1)
    step = torch.clamp(m, min=1)
    n_emit = torch.where(
        has, torch.div(count - 1 - i0, step, rounding_mode="floor") + 1, 0
    )
    i_last = i0 + (n_emit - 1) * m
    t_last = fma_f32(i_last.to(torch.float32) + 1.0, ts_step, t_prev)
    new_mem = torch.where(n_emit > 0, t_last, timestamp_mem)

    n_emit = torch.where(active, n_emit, count)
    i0 = torch.where(active & has, i0, 0)
    m = torch.where(active, m, 1)
    new_mem = torch.where(active, new_mem, timestamp_mem)
    return n_emit, i0, m, new_mem
