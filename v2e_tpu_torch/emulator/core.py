"""The emulator's chunk evaluation and sparse compaction (port of the fast
path of v2e_tpu/emulator/core.py).

A chunk is split in two steps:

* `draw_chunk_noise`: every random draw of the chunk (leak jitter normals,
  shot-noise uniforms, injected photoreceptor-noise normals) from a
  `torch.Generator`;
* `emulate_chunk_apply`: the deterministic model given those draws —
  lin-log, the photoreceptor IIR lowpass, leak deltas, shot-noise maps,
  then the sequential core (kernel K1, `refractory_scan`).

Tests hand the apply step the draws the JAX package made, so both packages
can be compared event for event.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from v2e_tpu_torch.device import scalar
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.state import EmulatorParams, EmulatorState
from v2e_tpu_torch.ops.core import (
    generate_shot_noise,
    lin_log,
    rescale_intensity_frame,
)
from v2e_tpu_torch.ops.kernels.emulator_scan import refractory_scan

Draws = Dict[str, Optional[torch.Tensor]]


def draw_chunk_noise(
    cfg: EmulatorConfig, n_frames: int, shape, generator: torch.Generator,
    device: torch.device,
) -> Draws:
    """All random numbers one chunk of `n_frames` frames consumes."""
    full = (n_frames, *shape)

    def normal():
        return torch.randn(full, generator=generator, device=device)

    return {
        "leak": normal() if cfg.leak_rate_hz > 0 else None,
        "shot": torch.rand(full, generator=generator, device=device)
        if cfg.simple_shot_noise else None,
        "photoreceptor": normal() if cfg.photoreceptor_noise else None,
    }


def linear_iir(init: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[f] = a[f] * y[f-1] + b[f] over the leading axis, y[-1] = init.

    The JAX package solves this recurrence with an associative scan; the
    sequential form here rounds differently by a few ulp."""
    out = torch.empty_like(b)
    y = init
    for f in range(b.shape[0]):
        y = a[f] * y + b[f]
        out[f] = y
    return out


def emulate_chunk_apply(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    draws: Draws,
) -> Tuple[EmulatorState, Dict[str, torch.Tensor]]:
    """Evaluate F frames given the chunk's draws.

    frames: [F,H,W] linear 0-255 intensity (HDR log if cfg.hdr); times:
    f32[F] chunk-relative, strictly increasing, times[0] > state.t_prev.
    Returns (new state, per-frame outputs stacked on a leading F axis).
    """
    frames = frames.to(torch.float32)
    times = times.to(torch.float32)
    dts = torch.diff(times, prepend=state.t_prev.reshape(1))
    t_prevs = times - dts
    dts3 = dts[:, None, None]

    log_new = frames if cfg.hdr else lin_log(frames)
    inten01 = rescale_intensity_frame(frames) if cfg.needs_inten01 else None

    if cfg.cutoff_hz > 0:
        tau = scalar(1.0 / (math.pi * 2 * cfg.cutoff_hz), frames)
        eps = torch.clamp(inten01 * (dts3 / tau), max=1.0)
        lp = linear_iir(state.lp_log_frame, 1.0 - eps, eps * log_new)
    else:
        lp = log_new

    pr_last = state.photoreceptor_noise_arr
    lp_eff = lp
    if cfg.photoreceptor_noise:
        tau = scalar(1.0 / (math.pi * 2 * cfg.cutoff_hz), frames)
        noise = params.photoreceptor_noise_vrms * draws["photoreceptor"]
        eps_n = (dts / tau)[:, None, None] * torch.ones_like(frames[0])
        pr_noise = linear_iir(pr_last, 1.0 - eps_n, eps_n * noise)
        pr_last = pr_noise[-1]
        lp_eff = lp + pr_noise

    leak_delta = None
    if cfg.leak_rate_hz > 0:
        leak_delta = (
            dts3
            * (cfg.leak_rate_hz * params.noise_rate_array)
            * (1.0 - cfg.leak_jitter_fraction * draws["leak"])
            * params.pos_thres
        )

    shot_on = shot_off = shot_any = None
    if cfg.simple_shot_noise:
        shot_on, shot_off = generate_shot_noise(
            draws["shot"], cfg.shot_noise_rate_hz, dts3,
            cfg.shot_noise_inten_factor, inten01,
            params.pos_thres_pre_prob, params.neg_thres_pre_prob,
        )
        shot_any = (shot_on | shot_off).to(torch.uint8)

    new_base, new_mem, signed16, i0_16, K = refractory_scan(
        lp_eff.contiguous(), leak_delta, shot_any,
        params.pos_thres.contiguous(), params.neg_thres.contiguous(),
        state.base_log_frame.contiguous(), state.timestamp_mem.contiguous(),
        dts.contiguous(), t_prevs.contiguous(), float(cfg.refractory_period_s),
    )
    # per-frame stride from K, the formula of the refractory filter
    R = scalar(cfg.refractory_period_s, frames)
    ts_step = torch.maximum(dts, scalar(1e-12, dts)) / torch.clamp(K, min=1).to(torch.float32)
    m = (torch.floor(R / ts_step) + 1.0).to(torch.int32)
    signed = signed16.to(torch.int32)
    num_on = torch.clamp(signed, min=0).sum(dim=(1, 2))
    num_off = torch.clamp(-signed, min=0).sum(dim=(1, 2))
    outs = {
        "ev_count": signed16,
        "i0": i0_16,
        "stride": torch.where(R > ts_step, m, 1),
        "K": K,
    }
    if shot_on is not None:
        num_on = num_on + shot_on.sum(dim=(1, 2))
        num_off = num_off + shot_off.sum(dim=(1, 2))
        outs["shot_on"] = shot_on
        outs["shot_off"] = shot_off
    outs.update(t_prev=t_prevs, t_frame=times, num_on=num_on, num_off=num_off)
    new_state = dataclasses.replace(
        state,
        base_log_frame=new_base,
        lp_log_frame=lp[-1],
        photoreceptor_noise_arr=pr_last,
        timestamp_mem=new_mem,
        t_prev=times[-1],
    )
    return new_state, outs


def count_occupied(cfg: EmulatorConfig, outs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Number of (frame, pixel) cells carrying any event."""
    return _occupancy(cfg, outs).sum(dtype=torch.int32)


def _occupancy(cfg: EmulatorConfig, outs: Dict[str, torch.Tensor]) -> torch.Tensor:
    occ = outs["ev_count"].reshape(-1) != 0
    if cfg.simple_shot_noise:
        occ = occ | outs["shot_on"].reshape(-1) | outs["shot_off"].reshape(-1)
    return occ


def compact_chunk(
    cfg: EmulatorConfig, outs: Dict[str, torch.Tensor], capacity: int
) -> Dict[str, torch.Tensor]:
    """Gather the occupied cells of the dense per-frame maps:

      idx   i32[C]  flat cell index (frame*H*W + row*W + col), ascending
      count i16[C]  signed post-refractory event count
      i0    i16[C]  first emitted sub-frame iteration
      shot  u8[C]   bit0 = shot ON, bit1 = shot OFF

    The first `capacity` occupied cells in index order; entries beyond the
    occupancy are zero with idx == F*H*W (the JAX package's top-k select
    gives the same, overflow included).
    """
    cnt = outs["ev_count"].reshape(-1)
    total = cnt.shape[0]
    occ = _occupancy(cfg, outs)
    found = torch.nonzero(occ).reshape(-1)[:capacity].to(torch.int32)
    idx = torch.full((capacity,), total, dtype=torch.int32, device=cnt.device)
    idx[: found.shape[0]] = found
    valid = idx < total
    safe = torch.clamp(idx, max=total - 1).to(torch.int64)
    out = {
        "idx": idx,
        "count": torch.where(valid, cnt[safe], 0).to(torch.int16),
        "i0": torch.where(valid, outs["i0"].reshape(-1)[safe], 0).to(torch.int16),
    }
    if cfg.simple_shot_noise:
        on = outs["shot_on"].reshape(-1)[safe].to(torch.uint8)
        off = outs["shot_off"].reshape(-1)[safe].to(torch.uint8)
        out["shot"] = torch.where(valid, on | (off << 1), 0).to(torch.uint8)
    return out


def emulate_and_compact_impl(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    capacity: int,
    draws: Draws,
):
    """One chunk: apply + compaction.  Returns (state, outs, packed) with
    packed = {"scalars": i32 buffer of every per-frame scalar and the
    occupancy (`unpack_scalars`), "sparse": `compact_chunk`'s arrays}."""
    state, outs = emulate_chunk_apply(cfg, params, state, frames, times, draws)
    sparse = compact_chunk(cfg, outs, capacity)
    n_occ = count_occupied(cfg, outs)
    scalars = torch.cat(
        [
            outs["stride"].to(torch.int32),
            outs["K"].to(torch.int32),
            outs["num_on"].to(torch.int32),
            outs["num_off"].to(torch.int32),
            outs["t_prev"].to(torch.float32).view(torch.int32),
            outs["t_frame"].to(torch.float32).view(torch.int32),
            n_occ.reshape(1).to(torch.int32),
        ]
    )
    return state, outs, {"scalars": scalars, "sparse": sparse}


def unpack_scalars(scalars) -> Dict:
    """Host-side inverse of the scalar packing."""
    scalars = np.asarray(scalars)
    F = (scalars.shape[0] - 1) // 6
    return {
        "stride": scalars[0:F],
        "K": scalars[F: 2 * F],
        "num_on": scalars[2 * F: 3 * F],
        "num_off": scalars[3 * F: 4 * F],
        "t_prev": scalars[4 * F: 5 * F].view(np.float32),
        "t_frame": scalars[5 * F: 6 * F].view(np.float32),
        "n_occ": int(scalars[-1]),
    }
