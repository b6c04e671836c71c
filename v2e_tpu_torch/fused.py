"""One conversion chunk: SloMo interpolation + DVS emulation + sparse
compaction (port of v2e_tpu/fused.py).

`fused_chunk` runs the whole chunk on the device: preprocess, flow UNet,
`interpolate_pairs` (K3 or K4 warps), postprocess to 8-bit levels, then
`emulate_and_compact_impl` (K1 or K2).  It also returns the chunk's max flow in
the packed scalars, so the host can pick the next chunk's warp window and
(auto mode) its U without a mid-chunk sync.  `FusedConverter` drives it;
the first chunk goes the staged way, because the emulator's state starts
from the first interpolated frame.
"""
from __future__ import annotations

import logging
import math
from typing import Optional, Tuple

import numpy as np
import torch

from v2e_tpu_torch import tracing
from v2e_tpu_torch.emulator.core import draw_chunk_noise, emulate_and_compact_impl
from v2e_tpu_torch.models.backwarp import K3_MAX_DISP
from v2e_tpu_torch.models.slomo import (
    MAX_GROUP,
    MAX_OUT_FRAMES,
    SuperSloMo,
    bucket_upsampling_factor,
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

    statics = (H, W, U, max_group, window, form): the warp window
    (models/backwarp.py::warp_planar) and the UNets' conv form
    (models/unet.py).  `draws` overrides the emulator's random draws
    (tests); by default they come from `generator`.  packed["scalars"] ends
    with the chunk's max flow magnitude (float32 bits).
    """
    H, W, U, max_group, window, form = statics
    x = preprocess_frames(frames, snap32(H), snap32(W))
    I0, I1 = x[:-1], x[1:]
    with tracing.span("slomo.flow_unet", tracing.DEVICE, x.device):
        flow_out = unet_apply(flow_net, torch.cat([I0, I1], dim=1), form)
    interp = interpolate_pairs(
        flow_net, interp_net, I0, I1, U, max_group, window,
        flow_out=flow_out, form=form,
    )
    dvs = postprocess_frames(interp, H, W)
    if draws is None:
        with tracing.span("emulator.precore", tracing.DEVICE, dvs.device):
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
    chunks run `fused_chunk`.  It serves the configurations in which nothing
    on the host consumes the interpolated frames (the CLI without its slomo
    video).

    Auto-upsampling is fused with a one-chunk lookahead: each fused chunk
    returns its max flow in the packed scalars, and the next chunk's U is
    the bucketed ceil of it (`note_collected`), the formula the staged path
    applies to the current chunk's flow (SuperSloMo.choose_upsampling).
    The warp window of fused chunks (`window`) is K3_MAX_DISP, so they run
    K3, except between the first staged chunk and the first collected
    fused chunk: there they take the staged chunk's window, which is U (K4)
    when auto-upsampling chose U > 32, as in the JAX package.
    """

    def __init__(self, slomo: SuperSloMo, emulator):
        self.slomo = slomo
        self.emulator = emulator
        self.window = K3_MAX_DISP  # fused chunks' warp window
        self._next_u: Optional[int] = None  # lookahead auto-U bucket
        self.n_staged = 0  # chunks submitted the staged way

    @staticmethod
    def usable(slomo: SuperSloMo, emulator, writes_slomo_video: bool) -> bool:
        """Whether fused chunks can serve this conversion: one device (no
        mesh, no pad rows; a fused chunk runs the emulator on one plane),
        and nothing on the host that needs the interpolated frames (the
        slomo video, the HDF5 sink's frames)."""
        return (emulator.mesh is None and not emulator.cfg.pad_rows
                and emulator.dvs_h5 is None and not writes_slomo_video)

    def submit_window(self, src_frames, pair_index: int, src_frame_interval: float):
        """Submit one window of source frames [B+1,H,W] whose first pair is
        global pair `pair_index`; the interpolated times follow from the
        chosen U.  Fixed and auto upsampling.

        Returns (collect handle or None, U, times f64[B*U])."""
        slomo = self.slomo
        n_pairs = src_frames.shape[0] - 1
        U = self._next_u if slomo.auto_upsample else slomo.upsampling_factor

        def make_times(u: int) -> np.ndarray:
            rel = np.arange(n_pairs * u, dtype=np.float64) / u
            return (pair_index + rel) * src_frame_interval

        if (self.emulator.state is None or U is None
                or n_pairs * U > MAX_OUT_FRAMES):
            handle, U = self._submit_staged(src_frames, make_times)
            return handle, U, make_times(U)
        times = make_times(U)
        slomo.last_upsampling_factor = U
        slomo.upsampling_sum += U
        slomo.upsampling_samples += 1
        return self._submit_fused(src_frames, times, U), U, times

    def _submit_staged(self, src_frames, make_times):
        """The staged path: the first chunk (the emulator's state starts
        from its first interpolated frame; auto-U needs the chunk's own
        flow) or a chunk above MAX_OUT_FRAMES (pair slices).  Returns
        (handle, U)."""
        em, slomo = self.emulator, self.slomo
        H, W = em.output_height, em.output_width
        if H is None:
            H, W = src_frames.shape[1:]
        interp, U = slomo.interpolate_batch(src_frames, H, W)
        if self.n_staged == 0:
            self.window = slomo.warp_window(U)
        self.n_staged += 1
        if slomo.auto_upsample:
            # staged handles carry no max-flow scalar: refresh the lookahead
            # from this chunk's own choice
            self._next_u = U
        return em.submit_batch(interp, make_times(U)), U

    def _submit_fused(self, src_frames, times: np.ndarray, U: int):
        em, slomo = self.emulator, self.slomo
        H, W = em.output_height, em.output_width
        statics = (H, W, U, MAX_GROUP, self.window, slomo.form)
        return em.submit_batch_fused(
            fused_chunk, statics, slomo.flow_net, slomo.interp_net,
            src_frames, times,
        )

    def note_collected(self, handle) -> None:
        """Feed the collected chunk's max flow into the next chunk's U
        bucket (auto mode); a finite one also returns the warp window to
        K3_MAX_DISP.  Call after the emulator's collect (or collect_fetch)
        of `handle`."""
        mf = handle.get("max_flow")
        if mf is None or not math.isfinite(mf):
            return
        slomo = self.slomo
        if slomo.auto_upsample:
            u = int(math.ceil(mf))
            if slomo.upsampling_factor is not None:
                u = max(u, slomo.upsampling_factor)
            self._next_u = bucket_upsampling_factor(max(u, 2))
        self.window = K3_MAX_DISP
