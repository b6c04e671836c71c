"""One conversion chunk: SloMo interpolation + DVS emulation + sparse
compaction (port of v2e_tpu/fused.py).

`fused_chunk` runs the whole chunk on the device: preprocess, flow UNet,
`interpolate_pairs` (K3 warps), postprocess to 8-bit levels, then
`emulate_and_compact_impl` (K1).  It also returns the chunk's max flow in
the packed scalars, so the host can pick the next chunk's warp window
without a mid-chunk sync.  `FusedConverter` drives it with fixed
upsampling; the first chunk goes the staged way, because the emulator's
state starts from the first interpolated frame.
"""
from __future__ import annotations

import logging
import math
from typing import Optional, Tuple

import numpy as np
import torch

from v2e_tpu_torch.emulator.core import draw_chunk_noise, emulate_and_compact_impl
from v2e_tpu_torch.models.slomo import (
    SuperSloMo,
    interpolate_pairs,
    max_flow_speed,
    postprocess_frames,
    preprocess_frames,
    snap32,
)
from v2e_tpu_torch.models.unet import unet_apply

logger = logging.getLogger(__name__)


def fused_chunk(
    cfg,
    statics: Tuple,
    emu_params,
    emu_state,
    flow_net,
    interp_net,
    capacity: int,
    frames: torch.Tensor,
    rel_times: torch.Tensor,
    generator: torch.Generator,
    draws=None,
):
    """frames u8/f32[B+1,H,W] + rel_times f32[B*U] -> (state, outs, packed).

    statics = (H, W, U, max_group, warp_max_disp, quantize).  `draws`
    overrides the emulator's random draws (tests); by default they come
    from `generator`.  packed["scalars"] ends with the chunk's max flow
    magnitude (float32 bits).
    """
    H, W, U, max_group, warp_max_disp, quantize = statics
    x = preprocess_frames(frames, snap32(H), snap32(W))
    I0, I1 = x[:-1], x[1:]
    flow_out = unet_apply(flow_net, torch.cat([I0, I1], dim=1))
    interp = interpolate_pairs(
        flow_net, interp_net, I0, I1, U, max_group, warp_max_disp,
        flow_out=flow_out,
    )
    dvs = postprocess_frames(interp, H, W, quantize)
    if draws is None:
        draws = draw_chunk_noise(cfg, dvs.shape[0], (H, W), generator, dvs.device)
    state, outs, packed = emulate_and_compact_impl(
        cfg, emu_params, emu_state, dvs, rel_times, capacity, draws
    )
    mf = max_flow_speed(flow_out).to(torch.float32).reshape(1).view(torch.int32)
    packed["scalars"] = torch.cat([packed["scalars"], mf])
    outs["dvs_frames"] = dvs
    return state, outs, packed


class FusedConverter:
    """Drives conversion through `fused_chunk`, one chunk at a time.

    Wraps a `SuperSloMo` engine and an `EventEmulator`: the first chunk
    runs the staged path (interpolate, then `submit_batch`, which
    initializes the emulator from the first interpolated frame); later
    chunks run `fused_chunk`.  Each collected chunk's max flow sets the next
    chunk's warp window (`note_collected`).
    """

    def __init__(self, slomo: SuperSloMo, emulator):
        self.slomo = slomo
        self.emulator = emulator
        self._disp: Optional[int] = None  # lookahead warp window

    def submit(self, src_frames, times: np.ndarray):
        """Submit source frames [B+1,H,W] with interpolated absolute times
        [B*U] (f64).  Returns a collect handle, or None (pure-init chunk)."""
        slomo, em = self.slomo, self.emulator
        U = slomo.upsampling_factor
        n_out = (src_frames.shape[0] - 1) * U
        if times.shape[0] != n_out:
            raise ValueError(f"times {times.shape} != (B)*U = {n_out}")
        H, W = em.output_height, em.output_width
        if H is None:
            H, W = src_frames.shape[1:]
        if em.state is None:
            interp, _ = slomo.interpolate_batch(src_frames, H, W)
            self._disp = slomo.last_disp
            return em.submit_batch(interp, times)
        disp = self._disp if (slomo.adaptive_disp and self._disp) else slomo.warp_max_disp
        statics = (H, W, U, slomo.max_group, disp, True)
        return em.submit_batch_fused(
            fused_chunk, statics, slomo.flow_net, slomo.interp_net,
            src_frames, times,
        )

    def note_collected(self, handle) -> None:
        """Feed the collected chunk's max flow into the next warp window
        (call after emulator.collect(handle))."""
        mf = handle.get("max_flow")
        if mf is None or not math.isfinite(mf):
            return
        need = mf * 1.25 + 2.0
        for b in SuperSloMo.DISP_BUCKETS:
            if need <= b <= self.slomo.warp_max_disp:
                self._disp = b
                return
        self._disp = self.slomo.warp_max_disp
