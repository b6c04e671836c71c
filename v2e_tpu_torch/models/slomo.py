"""SuperSloMo frame interpolation (port of v2e_tpu/models/slomo.py).

* the flow UNet on normalised frame pairs gives the bidirectional flows
  F_0_1 and F_1_0;
* for each intermediate time t = (i + 0.5) / U the flows are blended, both
  frames are backwarped (K3, or K4 for windows above 32 px), the
  refinement UNet returns flow residuals and a visibility map, and the two
  warped frames are blended.

Intermediate times are folded into the batch in groups (`_group_split`) so
the refinement UNet sees large batches; each group makes two warp calls of
2*g*B planes.

Auto-upsampling picks U = ceil(max flow) per chunk so motion stays within
about 1 px per interpolated frame, rounded up into the bucket ladder
`UPSAMPLE_BUCKETS` (finer timestamps than asked, never coarser), and
floored by an explicit --timestamp_resolution.  When that U exceeds the
32 px warp cap, the chunk's warp window widens to U and the warps go to
K4 (`SuperSloMo.warp_window`, decided from U alone).  The original v2e's
file API rides on `interpolate_batch`: `interpolate` reads .npy frames
from a folder and writes numbered PNGs, and `get_interpolated_timestamps`
spreads real timestamps U-fold.
"""
from __future__ import annotations

import logging
import math
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from v2e_tpu_torch import tracing
from v2e_tpu_torch.device import resolve_device, scalar, upload
from v2e_tpu_torch.models.backwarp import K3_MAX_DISP, warp_planar
from v2e_tpu_torch.models.convert_ckpt import (
    from_jax_params,
    init_random_slomo_params,
    load_slomo_params,
)
from v2e_tpu_torch.models.resize import resize
from v2e_tpu_torch.models.unet import DENSE, UNet, UNetForm, unet_apply, unet_form
from v2e_tpu_torch.ops.kernels import build

logger = logging.getLogger(__name__)

# dataset normalization mean of the original SuperSloMo
MEAN = 0.428

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

# the most UNet batch rows an interpolation group fills (`_group_split`)
MAX_GROUP = 96
# the most interpolated frames per device call: at very high U a whole
# chunk would take GBs, so pairs are emitted in slices
MAX_OUT_FRAMES = 4096

# Bucket ladder of the data-dependent auto-upsampling factor: ~1.5x steps,
# never more than 50 % extra interpolated frames.
UPSAMPLE_BUCKETS = (
    2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
)


def bucket_upsampling_factor(u: int) -> int:
    """The smallest bucket >= u (the largest bucket above the ladder)."""
    for b in UPSAMPLE_BUCKETS:
        if b >= u:
            return b
    return UPSAMPLE_BUCKETS[-1]


def snap32(x: int) -> int:
    """Snap a dimension down to a multiple of 32."""
    return max(32, int(x / 32) * 32)


def max_flow_speed(flow_out: torch.Tensor) -> torch.Tensor:
    """Max flow magnitude over both directions and the batch (pixels per
    source frame interval), as a 0-d tensor."""
    u01, v01 = flow_out[:, 0], flow_out[:, 1]
    u10, v10 = flow_out[:, 2], flow_out[:, 3]
    sp = torch.maximum(u01 * u01 + v01 * v01, u10 * u10 + v10 * v10)
    return torch.sqrt(sp.max())


def _group_split(U: int, B: int, max_group: int):
    """Split U intermediate times into n groups of g, minimizing padded
    UNet forwards while keeping the batch g*B near max_group."""
    best = None
    for n in range(1, U + 1):
        g_cand = -(-U // n)
        if g_cand * B > max(max_group, B):
            continue
        key = (n * g_cand - U, n)
        if best is None or key < best[0]:
            best = (key, n, g_cand)
    _, n_groups, g = best
    return n_groups, g


def interpolate_pairs(
    flow_net: UNet,
    interp_net: UNet,
    I0: torch.Tensor,
    I1: torch.Tensor,
    upsampling_factor: int,
    max_group: int = MAX_GROUP,
    window: int = K3_MAX_DISP,
    flow_out: Optional[torch.Tensor] = None,
    form: Union[str, UNetForm] = DENSE,
) -> torch.Tensor:
    """Interpolate U frames between each pair.

    I0, I1: [B,1,h,w] normalized (0-1 minus MEAN) frame pairs.  Returns
    [B, U, 1, h, w] normalized frames at t = (i + 0.5) / U.  The warps run
    the kernel that `window` selects (models/backwarp.py::warp_planar), and
    both UNets the conv `form` (models/unet.py).
    """
    U = upsampling_factor
    form = unet_form(form)
    if flow_out is None:
        with tracing.span("slomo.flow_unet", tracing.DEVICE, I0.device):
            flow_out = unet_apply(flow_net, torch.cat([I0, I1], dim=1), form)
    B = I0.shape[0]
    P0, P1 = I0[:, 0], I1[:, 0]
    u01, v01 = flow_out[:, 0], flow_out[:, 1]
    u10, v10 = flow_out[:, 2], flow_out[:, 3]

    ts = (torch.arange(U, dtype=torch.float32, device=I0.device) + 0.5) / scalar(U, I0)
    n_groups, g = _group_split(U, B, max_group)
    pad = n_groups * g - U
    ts_groups = torch.cat(
        [ts, torch.full((pad,), 0.5, dtype=torch.float32, device=I0.device)]
    ).reshape(n_groups, g)

    def tile(p):
        return p.repeat(g, 1, 1)  # [g*B,h,w]

    P0g, P1g = tile(P0), tile(P1)
    u01g, v01g = tile(u01), tile(v01)
    u10g, v10g = tile(u10), tile(v10)
    P01 = torch.cat([P0g, P1g])
    n = g * B

    groups = []
    for ts_g in ts_groups:
        t = ts_g.repeat_interleave(B)[:, None, None]  # [g*B,1,1]
        tmp = -t * (1.0 - t)
        a, b = tmp, t * t
        c, d = (1.0 - t) * (1.0 - t), tmp
        ut0 = a * u01g + b * u10g
        vt0 = a * v01g + b * v10g
        ut1 = c * u01g + d * u10g
        vt1 = c * v01g + d * v10g
        g01 = warp_planar(
            P01, torch.cat([ut0, ut1]), torch.cat([vt0, vt1]), window
        )
        g0, g1 = g01[:n], g01[n:]
        # channel order of the original model's torch.cat, for its weights
        stack = torch.stack(
            [P0g, P1g, u01g, v01g, u10g, v10g, ut1, vt1, ut0, vt0, g1, g0], dim=1
        )
        dtype = next(interp_net.parameters()).dtype
        with tracing.span("slomo.refine_unet", tracing.DEVICE, I0.device):
            # cast and laid out channels_last in one copy (a stack on the
            # last axis writes 4-byte elements 48 bytes apart: 13x slower)
            stack = stack.to(dtype, memory_format=torch.channels_last)
            intrp = interp_net(stack, form).to(torch.float32)
        ut0f = intrp[:, 0] + ut0
        vt0f = intrp[:, 1] + vt0
        ut1f = intrp[:, 2] + ut1
        vt1f = intrp[:, 3] + vt1
        V0 = torch.sigmoid(intrp[:, 4])
        V1 = 1.0 - V0
        g01f = warp_planar(
            P01, torch.cat([ut0f, ut1f]), torch.cat([vt0f, vt1f]), window
        )
        g0f, g1f = g01f[:n], g01f[n:]
        w0 = (1.0 - t) * V0
        w1 = t * V1
        Ft_p = (w0 * g0f + w1 * g1f) / (w0 + w1)
        groups.append(Ft_p.reshape(g, B, *Ft_p.shape[1:]))
    frames = torch.cat(groups)[:U]  # [U,B,h,w]
    return frames.transpose(0, 1)[:, :, None]  # [B,U,1,h,w]


def preprocess_frames(frames: torch.Tensor, h32: int, w32: int) -> torch.Tensor:
    """0-255 [N,H,W] -> normalized [N,1,h32,w32] (lanczos3 resize, scale,
    demean)."""
    x = frames.to(torch.float32) / scalar(255.0, frames) - MEAN
    return resize(x, (h32, w32), "lanczos3")[:, None]


def _levels(interp: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B,U,1,h,w] normalized -> [B*U,H,W] 0-255 float32, time-ordered:
    bilinear resize back to the output size, unrounded."""
    B, U = interp.shape[:2]
    x = interp.reshape(B * U, interp.shape[3], interp.shape[4])
    x = resize(x, (H, W), "bilinear")
    return torch.clamp((x + MEAN) * 255.0, 0.0, 255.0)


def postprocess_frames(interp: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """`_levels` rounded to 8-bit levels, like the original's PNG round
    trip."""
    return torch.round(_levels(interp, H, W))


class SuperSloMo:
    """Batched frame-pair interpolation engine, fixed or auto upsampling.

    `model`: a checkpoint (the reference's torch .ckpt or a converted .npz),
    or None for seeded random weights (`base` sets their width; 32 is the
    original SuperSloMo).  A `model` path that does not exist raises
    FileNotFoundError unless `allow_random` is set; then random weights are
    used with a warning.

    `conv_impl` is a --unet_conv name, resolved once to the UNets' conv
    form (`self.form`, models/unet.py's UNET_CONV); "auto" runs dense, as
    the JAX package's auto does off its TPU.  No faster default is chosen
    without a benchmark cell.
    """

    def __init__(
        self,
        model: Optional[str],
        auto_upsample: bool = False,
        upsampling_factor: Optional[int] = None,
        batch_size: int = 8,
        compute_dtype: str = "bfloat16",
        allow_random: bool = False,
        device: Optional[str] = None,
        seed: int = 0,
        base: int = 32,
        conv_impl: str = "auto",
    ):
        if not auto_upsample and (
            not isinstance(upsampling_factor, int) or upsampling_factor < 2
        ):
            raise ValueError(
                f"upsampling_factor={upsampling_factor} must be an int > 1 "
                "when auto_upsample=False"
            )
        self.device = resolve_device(device)
        self.form = unet_form(conv_impl)
        self.auto_upsample = auto_upsample
        self.upsampling_factor = upsampling_factor
        self.batch_size = batch_size
        self.compute_dtype = _DTYPES[compute_dtype]
        self.last_upsampling_factor: Optional[int] = None
        self.upsampling_sum = 0
        self.upsampling_samples = 0

        if model is not None and os.path.isfile(model):
            flow_np, interp_np = load_slomo_params(model)
            logger.info(f"loaded SuperSloMo weights from {model}")
        elif model is not None and not allow_random:
            raise FileNotFoundError(
                f"SuperSloMo model checkpoint {model} does not exist or is not "
                "readable; pass --allow_random_slomo (allow_random=True) to "
                "proceed with random weights (benchmarking only)"
            )
        else:
            if model is not None:
                logger.warning(
                    f"SuperSloMo checkpoint {model} not found; using random "
                    "weights (interpolated frames are meaningless)"
                )
            flow_np, interp_np = init_random_slomo_params(seed=seed, base=base)
        self.flow_net, self.interp_net = from_jax_params(
            flow_np, interp_np, self.device, self.compute_dtype
        )
        if self.device.type == "cuda":
            # the sources its forwards load, in one round of nvcc in
            # parallel: the warps (K3, K4), K6, K8 and, in the lane forms, K5
            build.build(("warp", "warp_tiled", "upsample", "conv_epilogue")
                        + (("conv3x3",) if self.form.lane else ()))

    def choose_upsampling(self, flow_out: torch.Tensor) -> int:
        """U for this chunk: fixed, or in auto mode ceil(max flow) floored
        by `upsampling_factor` and bucketed (one host sync)."""
        if not self.auto_upsample:
            u = self.upsampling_factor
        else:
            u = int(math.ceil(float(max_flow_speed(flow_out))))
            if self.upsampling_factor is not None and self.upsampling_factor > u:
                u = self.upsampling_factor
            u = bucket_upsampling_factor(max(u, 2))
        u = max(u, 2)
        self.last_upsampling_factor = u
        self.upsampling_sum += u
        self.upsampling_samples += 1
        return u

    @property
    def avg_upsampling_factor(self) -> float:
        if self.upsampling_samples == 0:
            return float(self.upsampling_factor or 0)
        return self.upsampling_sum / self.upsampling_samples

    def warp_window(self, U: int) -> int:
        """The warp window of a chunk at U: U when auto-upsampling chose
        U > K3_MAX_DISP, which sends the warps to K4, else K3_MAX_DISP
        (K3, which does not clamp the flow to it)."""
        return U if self.auto_upsample and U > K3_MAX_DISP else K3_MAX_DISP

    def _flow(self, frames, H: int, W: int):
        frames = upload(frames, self.device)
        x = preprocess_frames(frames, snap32(H), snap32(W))
        I0, I1 = x[:-1], x[1:]
        flow_out = unet_apply(self.flow_net, torch.cat([I0, I1], dim=1), self.form)
        return I0, I1, flow_out

    def interpolate_batch(self, frames, H: int, W: int) -> Tuple[torch.Tensor, int]:
        """Interpolate a chunk of source frames [N,H,W] (0-255).

        Returns (interp [(N-1)*U, H, W] 0-255 float32 on the device, U).
        Output frame k*U+i sits at source time k + i/U; the last source
        frame is not included (it seeds the next chunk).
        """
        U, slices = self.interpolate_batch_slices(frames, H, W)
        parts = [s for s, _ in slices]
        return (parts[0] if len(parts) == 1 else torch.cat(parts)), U

    def interpolate_batch_slices(self, frames, H: int, W: int):
        """Like `interpolate_batch`, but returns (U, generator of
        (frames [n*U,H,W], pair offset)) in slices of at most
        MAX_OUT_FRAMES frames, so device memory stays flat at very high
        U."""
        I0, I1, flow_out = self._flow(frames, H, W)
        U = self.choose_upsampling(flow_out)
        return U, self._emit_slices(I0, I1, flow_out, U, H, W)

    def _emit_slices(self, I0, I1, flow_out, U, H, W):
        B = I0.shape[0]
        pair_slice = max(1, MAX_OUT_FRAMES // U)
        for s in range(0, B, pair_slice):
            interp = interpolate_pairs(
                self.flow_net, self.interp_net, I0[s: s + pair_slice],
                I1[s: s + pair_slice], U, MAX_GROUP, self.warp_window(U),
                flow_out=flow_out[s: s + pair_slice], form=self.form,
            )
            yield postprocess_frames(interp, H, W), s

    # ------------------------------------------------------------------
    def interpolate(
        self, source_frame_path: str, output_folder: str, frame_size
    ) -> Tuple[np.ndarray, float]:
        """The original v2e's file API, for the dataset tools: read the
        .npy frames of a folder (in numeric order), interpolate them in
        chunks of `batch_size` pairs, write the frames to `output_folder`
        as 0.png, 1.png, ..., and return (their times in source-frame units,
        the average upsampling factor).  `frame_size` is (W, H)."""
        import cv2

        files = sorted(
            (f for f in os.listdir(source_frame_path) if f.endswith(".npy")),
            key=lambda s: int(os.path.splitext(s)[0]) if os.path.splitext(s)[0].isdigit() else 0,
        )
        if len(files) < 2:
            raise ValueError(f"need at least 2 source frames in {source_frame_path}")
        frames = np.stack(
            [np.load(os.path.join(source_frame_path, f)) for f in files]
        ).astype(np.float32)
        W, H = frame_size
        os.makedirs(output_folder, exist_ok=True)
        interp_times = []
        out_idx = 0
        input_counter = 0
        for s in range(0, len(frames) - 1, self.batch_size):
            chunk = frames[s: s + self.batch_size + 1]
            out, U = self.interpolate_batch(chunk, H, W)
            for k, frame in enumerate(out.cpu().numpy().astype(np.uint8)):
                cv2.imwrite(os.path.join(output_folder, f"{out_idx}.png"), frame)
                interp_times.append(input_counter + (k % U) / U + (k // U))
                out_idx += 1
            input_counter += chunk.shape[0] - 1
        return np.array(interp_times), self.avg_upsampling_factor

    def get_interpolated_timestamps(self, ts: np.ndarray) -> np.ndarray:
        """Spread real timestamps U-fold, each interval's U times offset by
        half a step.  In auto mode U is the last chunk's factor."""
        U = self.last_upsampling_factor or self.upsampling_factor or 2
        out = []
        for i in range(ts.shape[0] - 1):
            start, end = ts[i], ts[i + 1]
            out.append(np.linspace(start, end, U, endpoint=False)
                       + 0.5 * (end - start) / U)
        return np.hstack(out)
