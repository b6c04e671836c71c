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
    scidvs_tau_arr: Optional[torch.Tensor] = None  # f32[H,W] (SciDVS only)


@dataclasses.dataclass
class EmulatorState:
    """Per-pixel dynamic state carried across frames."""

    base_log_frame: torch.Tensor  # f32[H,W] memorized log intensity
    lp_log_frame: torch.Tensor  # f32[H,W] lowpass filter state
    photoreceptor_noise_arr: torch.Tensor  # f32[H,W] filtered injected noise
    timestamp_mem: torch.Tensor  # f32[H,W] last spike time (chunk-relative)
    t_prev: torch.Tensor  # f32 scalar, chunk-relative time of previous frame
    scidvs_highpass: Optional[torch.Tensor] = None  # f32[H,W] (SciDVS only)
    scidvs_previous_photo: Optional[torch.Tensor] = None  # f32[H,W] (SciDVS only)
    cs_surround_frame: Optional[torch.Tensor] = None  # f32[H,W] (CSDVS only)


def init_state(
    cfg: EmulatorConfig,
    first_frame: torch.Tensor,
    t0: float,
    generator: torch.Generator,
) -> Tuple[EmulatorParams, EmulatorState]:
    """Parameters and state from the first frame (linear 0-255 or HDR log):
    Gaussian threshold mismatch clamped at 0.01, lognormal noise-rate FPN,
    the SciDVS lognormal tau map, refractory memory primed to ``t0 - R`` so
    the first events pass, and the memorized base set to the first log
    frame; for CSDVS the surround starts equal to the photoreceptor, so the
    center-minus-surround base starts at zero.  With `cfg.pad_rows` the
    plane gains that many inert rows below the first frame's."""
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

    scidvs_tau = None
    if cfg.scidvs and cfg.scidvs_tau_cov > 0:
        scidvs_tau = cfg.scidvs_tau_s * torch.exp(cfg.scidvs_tau_cov * normal())
    elif cfg.scidvs:
        scidvs_tau = torch.full(shape, cfg.scidvs_tau_s, dtype=f32, device=dev)

    if cfg.pad_rows:
        # inert pad rows (EmulatorConfig.pad_rows): the draws above were made
        # at the logical shape; pad pixels never emit
        def pad(x, value=0.0):
            return torch.nn.functional.pad(x, (0, 0, 0, cfg.pad_rows), value=value)

        pos, neg = pad(pos, 1e9), pad(neg, 1e9)
        rate = pad(rate)
        lp = pad(lp)
        if scidvs_tau is not None:
            scidvs_tau = pad(scidvs_tau, 1.0)
        shape = (shape[0] + cfg.pad_rows, shape[1])

    params = EmulatorParams(
        pos_thres=pos,
        neg_thres=neg,
        pos_thres_pre_prob=scalar(cfg.pos_thres, pos) / pos,
        neg_thres_pre_prob=scalar(cfg.neg_thres, neg) / neg,
        noise_rate_array=rate,
        photoreceptor_noise_vrms=torch.zeros((), dtype=f32, device=dev),
        scidvs_tau_arr=scidvs_tau,
    )
    cs_surround = lp if cfg.csdvs_enabled else None
    t0_t = torch.tensor(t0, dtype=f32, device=dev)
    state = EmulatorState(
        base_log_frame=(lp - cs_surround) if cfg.csdvs_enabled else lp,
        lp_log_frame=lp,
        photoreceptor_noise_arr=torch.zeros(shape, dtype=f32, device=dev),
        timestamp_mem=torch.full(
            shape, -cfg.refractory_period_s, dtype=f32, device=dev
        ) + t0_t,
        t_prev=t0_t,
        scidvs_highpass=torch.zeros(shape, dtype=f32, device=dev) if cfg.scidvs else None,
        scidvs_previous_photo=lp if cfg.scidvs else None,
        cs_surround_frame=cs_surround,
    )
    return params, state


def rebase_state(state: EmulatorState, shift: float) -> EmulatorState:
    """Shift all chunk-relative times by ``-shift``, rounded to float32
    first.  A Python scalar, not a tensor made on the device: that would
    copy from the host and wait for the stream."""
    s = float(np.float32(shift))
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
    not have, such as the PRNG key and the step counter, are ignored; the
    variant fields that are absent or None stay None).
    """
    dev = resolve_device(device)

    def fields(cls, arrays):
        return cls(**{
            f.name: torch.from_numpy(np.array(arrays[f.name], dtype=np.float32)).to(dev)
            for f in dataclasses.fields(cls) if arrays.get(f.name) is not None
        })

    return fields(EmulatorParams, params_np), fields(EmulatorState, state_np)
