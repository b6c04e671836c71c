"""Emulator parameters and state (port of v2e_tpu/emulator/state.py).

`EmulatorParams` holds the per-pixel run constants (threshold mismatch,
noise-rate FPN), `EmulatorState` the per-pixel state carried from frame to
frame.  Times in the state are float32 and relative to a chunk origin that
the host tracks in float64 (`rebase_state`).

The mismatch draws come from a `torch.Generator`, so they differ from the
JAX package's threefry draws; `from_jax_emulator` carries the JAX package's
parameters and state across so both packages can be held to the same ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from v2e_tpu_torch.device import resolve_device, scalar
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.ops.core import lin_log


@dataclasses.dataclass
class EmulatorParams:
    """Per-pixel run constants (the model's 'weights')."""

    pos_thres: torch.Tensor  # f32[H,W] ON threshold map (clamped >= 0.01)
    neg_thres: torch.Tensor  # f32[H,W] OFF threshold map
    pos_thres_pre_prob: torch.Tensor  # f32[H,W] nominal/actual
    neg_thres_pre_prob: torch.Tensor
    noise_rate_array: torch.Tensor  # f32[H,W] lognormal leak/shot FPN rates
    photoreceptor_noise_vrms: torch.Tensor  # f32 scalar, host-calibrated


@dataclasses.dataclass
class EmulatorState:
    """Per-pixel dynamic state carried across frames."""

    base_log_frame: torch.Tensor  # f32[H,W] memorized log intensity
    lp_log_frame: torch.Tensor  # f32[H,W] lowpass filter state
    photoreceptor_noise_arr: torch.Tensor  # f32[H,W] filtered injected noise
    timestamp_mem: torch.Tensor  # f32[H,W] last spike time (chunk-relative)
    t_prev: torch.Tensor  # f32 scalar, chunk-relative time of previous frame


def init_state(
    cfg: EmulatorConfig,
    first_frame: torch.Tensor,
    t0: float,
    generator: torch.Generator,
) -> Tuple[EmulatorParams, EmulatorState]:
    """Parameters and state from the first frame (linear 0-255 or HDR log):
    Gaussian threshold mismatch clamped at 0.01, lognormal noise-rate FPN,
    refractory memory primed to ``t0 - R`` so the first events pass, and
    the memorized base set to the first log frame."""
    dev = first_frame.device
    shape = tuple(first_frame.shape)
    f32 = torch.float32
    first_frame = first_frame.to(f32)
    lp = first_frame if cfg.hdr else lin_log(first_frame)

    def normal():
        return torch.randn(shape, generator=generator, dtype=f32, device=dev)

    if cfg.sigma_thres > 0:
        pos = torch.clamp(cfg.pos_thres + cfg.sigma_thres * normal(), min=0.01)
        neg = torch.clamp(cfg.neg_thres + cfg.sigma_thres * normal(), min=0.01)
    else:
        pos = torch.full(shape, cfg.pos_thres, dtype=f32, device=dev)
        neg = torch.full(shape, cfg.neg_thres, dtype=f32, device=dev)

    if cfg.leak_rate_hz > 0:
        ln10 = torch.tensor(math.log(10.0), dtype=f32, device=dev)
        rate = torch.exp(ln10 * cfg.noise_rate_cov_decades * normal())
    else:
        rate = torch.ones(shape, dtype=f32, device=dev)

    params = EmulatorParams(
        pos_thres=pos,
        neg_thres=neg,
        pos_thres_pre_prob=scalar(cfg.pos_thres, pos) / pos,
        neg_thres_pre_prob=scalar(cfg.neg_thres, neg) / neg,
        noise_rate_array=rate,
        photoreceptor_noise_vrms=torch.zeros((), dtype=f32, device=dev),
    )
    t0_t = torch.tensor(t0, dtype=f32, device=dev)
    state = EmulatorState(
        base_log_frame=lp,
        lp_log_frame=lp,
        photoreceptor_noise_arr=torch.zeros(shape, dtype=f32, device=dev),
        timestamp_mem=torch.full(
            shape, -cfg.refractory_period_s, dtype=f32, device=dev
        ) + t0_t,
        t_prev=t0_t,
    )
    return params, state


def rebase_state(state: EmulatorState, shift: float) -> EmulatorState:
    """Shift all chunk-relative times by ``-shift``."""
    s = torch.tensor(shift, dtype=torch.float32, device=state.t_prev.device)
    return dataclasses.replace(
        state, timestamp_mem=state.timestamp_mem - s, t_prev=state.t_prev - s
    )


def from_jax_emulator(
    params_np: Dict[str, np.ndarray],
    state_np: Dict[str, np.ndarray],
    device: Optional[str] = None,
) -> Tuple[EmulatorParams, EmulatorState]:
    """Carry the JAX package's `EmulatorParams`/`EmulatorState` across.

    Takes each as a dict of field name -> numpy array (fields the port does
    not have, such as the PRNG key, are ignored).
    """
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    params = EmulatorParams(
        **{f.name: t(params_np[f.name]) for f in dataclasses.fields(EmulatorParams)}
    )
    state = EmulatorState(
        **{f.name: t(state_np[f.name]) for f in dataclasses.fields(EmulatorState)}
    )
    return params, state
