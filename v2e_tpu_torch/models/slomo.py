"""SuperSloMo frame interpolation (port of v2e_tpu/models/slomo.py).

* the flow UNet on normalised frame pairs gives the bidirectional flows
  F_0_1 and F_1_0;
* for each intermediate time t = (i + 0.5) / U the flows are blended, both
  frames are backwarped (K3), the refinement UNet returns flow residuals
  and a visibility map, and the two warped frames are blended.

Intermediate times are folded into the batch in groups (`_group_split`) so
the refinement UNet sees large batches; each group makes two warp calls of
2*g*B planes.  Only fixed upsampling is ported: the auto-upsampling mode
and the file API wait for a later slice.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

from v2e_tpu_torch.device import resolve_device, scalar
from v2e_tpu_torch.models.backwarp import warp_planar
from v2e_tpu_torch.models.convert_ckpt import (
    from_jax_params,
    init_random_slomo_params,
    load_slomo_params,
)
from v2e_tpu_torch.models.resize import resize
from v2e_tpu_torch.models.unet import UNet, unet_apply

logger = logging.getLogger(__name__)

# dataset normalization mean of the original SuperSloMo
MEAN = 0.428

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


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
    max_group: int = 96,
    warp_max_disp: int = 32,
    flow_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Interpolate U frames between each pair.

    I0, I1: [B,1,h,w] normalized (0-1 minus MEAN) frame pairs.  Returns
    [B, U, 1, h, w] normalized frames at t = (i + 0.5) / U.
    """
    U = upsampling_factor
    if flow_out is None:
        flow_out = unet_apply(flow_net, torch.cat([I0, I1], dim=1))
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
            P01, torch.cat([ut0, ut1]), torch.cat([vt0, vt1]), warp_max_disp
        )
        g0, g1 = g01[:n], g01[n:]
        # channel order of the original model's torch.cat, for its weights
        stack = torch.stack(
            [P0g, P1g, u01g, v01g, u10g, v10g, ut1, vt1, ut0, vt0, g1, g0], dim=1
        )
        dtype = next(interp_net.parameters()).dtype
        intrp = interp_net(stack.to(dtype)).to(torch.float32)
        ut0f = intrp[:, 0] + ut0
        vt0f = intrp[:, 1] + vt0
        ut1f = intrp[:, 2] + ut1
        vt1f = intrp[:, 3] + vt1
        V0 = torch.sigmoid(intrp[:, 4])
        V1 = 1.0 - V0
        g01f = warp_planar(
            P01, torch.cat([ut0f, ut1f]), torch.cat([vt0f, vt1f]), warp_max_disp
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


def postprocess_frames(
    interp: torch.Tensor, H: int, W: int, quantize: bool = True
) -> torch.Tensor:
    """[B,U,1,h,w] normalized -> [B*U,H,W] 0-255 float32, time-ordered:
    bilinear resize back to the output size, then (optionally) rounding to
    8-bit levels like the original's PNG round trip."""
    B, U = interp.shape[:2]
    x = interp.reshape(B * U, interp.shape[3], interp.shape[4])
    x = resize(x, (H, W), "bilinear")
    x = torch.clamp((x + MEAN) * 255.0, 0.0, 255.0)
    return torch.round(x) if quantize else x


class SuperSloMo:
    """Batched frame-pair interpolation engine with fixed upsampling.

    `model`: a converted .npz checkpoint, or None for seeded random weights
    (`base` sets their width; 32 is the original SuperSloMo).
    """

    DISP_BUCKETS = (8, 16, 32)

    def __init__(
        self,
        model: Optional[str],
        auto_upsample: bool = False,
        upsampling_factor: Optional[int] = None,
        batch_size: int = 8,
        compute_dtype: str = "bfloat16",
        max_group: int = 96,
        warp_max_disp: int = 32,
        adaptive_disp: bool = True,
        allow_random: bool = False,
        device: Optional[str] = None,
        seed: int = 0,
        base: int = 32,
    ):
        if auto_upsample:
            raise NotImplementedError("auto-upsampling is not ported yet")
        if not isinstance(upsampling_factor, int) or upsampling_factor < 2:
            raise ValueError(
                f"upsampling_factor={upsampling_factor} must be an int > 1"
            )
        self.device = resolve_device(device)
        self.upsampling_factor = upsampling_factor
        self.batch_size = batch_size
        self.compute_dtype = _DTYPES[compute_dtype]
        self.max_group = max_group
        self.warp_max_disp = warp_max_disp
        self.adaptive_disp = adaptive_disp
        self.last_disp: Optional[int] = None

        if model is not None and os.path.isfile(model):
            flow_np, interp_np = load_slomo_params(model)
            logger.info(f"loaded SuperSloMo weights from {model}")
        elif model is not None and not allow_random:
            raise FileNotFoundError(
                f"SuperSloMo model checkpoint {model} does not exist; pass "
                "allow_random=True to proceed with random weights"
            )
        else:
            flow_np, interp_np = init_random_slomo_params(seed=seed, base=base)
        self.flow_net, self.interp_net = from_jax_params(
            flow_np, interp_np, self.device, self.compute_dtype
        )

    def _choose_disp(self, flow_out: torch.Tensor) -> int:
        """The warp window for this chunk: the chunk's max flow with 1.25x +
        2 px headroom, bucketed.  The port's warp does not clamp to it
        (ops/kernels/warp.py); it is recorded and passed on."""
        max_disp = self.warp_max_disp
        if self.adaptive_disp:
            need = float(max_flow_speed(flow_out)) * 1.25 + 2.0
            for b in self.DISP_BUCKETS:
                if need <= b <= max_disp:
                    self.last_disp = b
                    return b
        self.last_disp = max_disp
        return max_disp

    def interpolate_batch(
        self, frames, H: int, W: int, quantize: bool = True
    ) -> Tuple[torch.Tensor, int]:
        """Interpolate a chunk of source frames [N,H,W] (0-255).

        Returns (interp [(N-1)*U, H, W] 0-255 float32 on the device, U).
        Output frame k*U+i sits at source time k + i/U; the last source
        frame is not included (it seeds the next chunk).
        """
        frames = torch.as_tensor(frames).to(self.device)
        x = preprocess_frames(frames, snap32(H), snap32(W))
        I0, I1 = x[:-1], x[1:]
        flow_out = unet_apply(self.flow_net, torch.cat([I0, I1], dim=1))
        U = self.upsampling_factor
        max_disp = self._choose_disp(flow_out)
        interp = interpolate_pairs(
            self.flow_net, self.interp_net, I0, I1, U, self.max_group,
            max_disp, flow_out=flow_out,
        )
        return postprocess_frames(interp, H, W, quantize), U
