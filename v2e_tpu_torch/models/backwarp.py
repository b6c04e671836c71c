"""Bilinear backwarping (port of v2e_tpu/models/backwarp.py).

Matches torch ``grid_sample(img, grid)`` with ``align_corners=False`` and
zero padding, as the original SuperSloMo's backWarp builds its grid: the
sample lands on ``p + flow - 0.5``.  Every call goes through the K3 wrapper
(ops/kernels/warp.py): the CUDA kernel on the card, its plain version on
the CPU.  Unlike the JAX package there is no second kernel for large
displacements: the gather has no window, so one kernel serves any flow.
"""
from __future__ import annotations

import torch

from v2e_tpu_torch.ops.kernels.warp import bilinear_warp, warp_plain


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K3's plain version on [N,C,H,W] images and [N,2,H,W] flow
    (channel 0 = x displacement u, 1 = v)."""
    n, c, H, W = img.shape
    u = flow[:, 0].repeat_interleave(c, dim=0)
    v = flow[:, 1].repeat_interleave(c, dim=0)
    return warp_plain(img.reshape(n * c, H, W), u, v).reshape(n, c, H, W)


def warp(img: torch.Tensor, flow: torch.Tensor, max_disp: int = 32) -> torch.Tensor:
    """Backwarp [N,C,H,W] images by [N,2,H,W] flow through the K3 wrapper.
    `max_disp` is recorded, not applied (ops/kernels/warp.py)."""
    n, c, H, W = img.shape
    flow = flow.contiguous()
    if c > 1:
        flow = flow.repeat_interleave(c, dim=0)
    out = bilinear_warp(
        img.reshape(n * c, H, W).contiguous(), flow[:, 0], flow[:, 1], max_disp
    )
    return out.reshape(n, c, H, W)


def warp_planar(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, max_disp: int = 32
) -> torch.Tensor:
    """`warp` for single-plane images [N,H,W] with separate flow planes."""
    return bilinear_warp(img.contiguous(), u.contiguous(), v.contiguous(), max_disp)
