"""Bilinear backwarping (port of v2e_tpu/models/backwarp.py).

Matches torch ``grid_sample(img, grid)`` with ``align_corners=False`` and
zero padding, as the original SuperSloMo's backWarp builds its grid: the
sample lands on ``p + flow - 0.5``.  The warp window `max_disp` of a
chunk (SuperSloMo.warp_window, FusedConverter.window) selects the kernel,
here and nowhere else, as in the JAX package:

* ``max_disp <= 32``: K3 (ops/kernels/warp.py), a 4-tap gather that equals
  `backwarp` for any flow;
* ``max_disp > 32`` (auto-upsampling chose U > 32): K4
  (ops/kernels/warp_tiled.py) with ``max_base`` = max_disp rounded up to a
  multiple of 128, which reproduces the TPU kernel's per-tile base and
  residual envelope.

On the card each wrapper launches its CUDA kernel; on the CPU it runs its
plain version.  Training differentiates the warp with respect to the flow
through `backwarp_grad`: K3 forward and its VJP kernel backward
(`BilinearWarpFn`), exact for any flow, as the training flows from random
weights are unbounded.
"""
from __future__ import annotations

import torch

from v2e_tpu_torch.ops.kernels.warp import BilinearWarpFn, bilinear_warp, warp_plain
from v2e_tpu_torch.ops.kernels.warp_tiled import max_base_for, warp_tiled

# the largest window K3 serves (the JAX package's static warp cap)
K3_MAX_DISP = 32


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K3's plain version on [N,C,H,W] images and [N,2,H,W] flow
    (channel 0 = x displacement u, 1 = v)."""
    n, c, H, W = img.shape
    u = flow[:, 0].repeat_interleave(c, dim=0)
    v = flow[:, 1].repeat_interleave(c, dim=0)
    return warp_plain(img.reshape(n * c, H, W), u, v).reshape(n, c, H, W)


def backwarp_grad(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """`backwarp` with a gradient: [N,C,H,W] images by [N,2,H,W] flow
    through `BilinearWarpFn` (the kernels on CUDA tensors, the plain
    forward and VJP on CPU tensors)."""
    n, c, H, W = img.shape
    if c > 1:
        flow = flow.repeat_interleave(c, dim=0)
    out = BilinearWarpFn.apply(img.reshape(n * c, H, W).contiguous(), flow)
    return out.reshape(n, c, H, W)


def warp(img: torch.Tensor, flow: torch.Tensor, max_disp: int = K3_MAX_DISP) -> torch.Tensor:
    """Backwarp [N,C,H,W] images by [N,2,H,W] flow through the kernel that
    `max_disp` selects."""
    n, c, H, W = img.shape
    flow = flow.contiguous()
    if c > 1:
        flow = flow.repeat_interleave(c, dim=0)
    out = warp_planar(img.reshape(n * c, H, W), flow[:, 0], flow[:, 1], max_disp)
    return out.reshape(n, c, H, W)


def warp_planar(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, max_disp: int = K3_MAX_DISP
) -> torch.Tensor:
    """`warp` for single-plane images [N,H,W] with separate flow planes."""
    img, u, v = img.contiguous(), u.contiguous(), v.contiguous()
    if int(max_disp) <= K3_MAX_DISP:
        return bilinear_warp(img, u, v)
    return warp_tiled(img, u, v, max_base_for(max_disp))
