"""K4: bilinear backwarp for large flow, with the TPU kernel's per-tile
base displacement and clamped residual window.

Replaces v2e_tpu/ops/pallas/warp_v2.py::bilinear_warp_tiled, which the
JAX package runs whenever the warp window exceeds 32 px (auto-upsampling
picked U > 32, SuperSloMo.warp_window).  `warp_tiled` launches the CUDA
kernel (csrc/warp_tiled.cu) for CUDA tensors and runs `warp_tiled_plain`,
the same float32 operations in PyTorch, for CPU tensors.

The function, per 8x128 output tile: an integer base displacement, the
tile mean of the edge-replicated flow rounded half to even to a multiple
of 128 (columns) and 8 (rows) and clamped to +-max_base; then each pixel
samples bilinearly at its residual coordinates relative to the displaced
tile, clamped to rows [-12, 19] and columns [-72, 199], with zero outside
the image.  Inside that envelope it equals backwarp.

Design (see the source's note): one block per output tile sums the tile's
flow in float64 (so the mean does not depend on the order of the sum) and
gathers the four taps of each pixel directly.  Bound by memory bytes: 16 B
per pixel (image, two flow planes, output).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from v2e_tpu_torch.ops.kernels import build
from v2e_tpu_torch.ops.kernels.warp import check_planes

BH, BW = 8, 128  # output tile (rows, columns)
M_ROW, M_COL = 12, 72  # residual window around the displaced tile


def max_base_for(max_disp: int) -> int:
    """The tile-base clamp for a warp window: max_disp rounded up to a
    multiple of 128 (models/backwarp.py:86 of the JAX package)."""
    return -(-int(max_disp) // 128) * 128


def tile_bases(u: torch.Tensor, v: torch.Tensor, max_base: int):
    """Per-tile base displacements (bu, bv), float32 [N, ceil(H/8),
    ceil(W/128)] holding integers: the tile means of the edge-replicated
    flow (summed in float64, then rounded once to float32), rounded half to
    even to multiples of 128 and 8, clamped to +-max_base."""
    n, H, W = u.shape
    nty, ntx = -(-H // BH), -(-W // BW)

    def mean(p):
        p = F.pad(p[:, None], (0, ntx * BW - W, 0, nty * BH - H), mode="replicate")[:, 0]
        s = p.double().reshape(n, nty, BH, ntx, BW).sum(dim=(2, 4))
        return (s / float(BH * BW)).float()

    def quantize(m, q):
        return torch.clamp(q * torch.round(m / q), -float(max_base), float(max_base))

    return quantize(mean(u), 128.0), quantize(mean(v), 8.0)


def warp_tiled_plain(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, max_base: int
) -> torch.Tensor:
    """The kernel's function in PyTorch.  img, u, v: [N,H,W] float32."""
    n, H, W = img.shape
    bu, bv = tile_bases(u, v, max_base)
    # each pixel's tile base, and its row/column inside the tile
    bu = bu.repeat_interleave(BH, dim=1).repeat_interleave(BW, dim=2)[:, :H, :W]
    bv = bv.repeat_interleave(BH, dim=1).repeat_interleave(BW, dim=2)[:, :H, :W]
    rows = torch.arange(H, device=img.device)
    cols = torch.arange(W, device=img.device)
    i = (rows % BH).to(torch.float32)[None, :, None]
    j = (cols % BW).to(torch.float32)[None, None, :]
    r0 = (rows - rows % BH)[None, :, None]
    c0 = (cols - cols % BW)[None, None, :]

    ly = torch.clamp((i + (v - bv)) - 0.5, -float(M_ROW), float(BH - 1 + M_ROW)) + float(M_ROW + 1)
    lx = torch.clamp((j + (u - bu)) - 0.5, -float(M_COL), float(BW - 1 + M_COL)) + float(M_COL + 1)
    y0 = torch.floor(ly)
    x0 = torch.floor(lx)
    wy = ly - y0
    wx = lx - x0
    ry = r0 + bv.to(torch.int64) - (M_ROW + 1) + y0.to(torch.int64)
    cx = c0 + bu.to(torch.int64) - (M_COL + 1) + x0.to(torch.int64)
    flat = img.reshape(n, H * W)

    def px(y, x):
        inb = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        idx = (torch.clamp(y, 0, H - 1) * W + torch.clamp(x, 0, W - 1)).reshape(n, H * W)
        vals = torch.gather(flat, 1, idx).reshape(n, H, W)
        return torch.where(inb, vals, torch.zeros((), dtype=img.dtype))

    t0 = px(ry, cx) * (1.0 - wx) + px(ry, cx + 1) * wx
    t1 = px(ry + 1, cx) * (1.0 - wx) + px(ry + 1, cx + 1) * wx
    return (1.0 - wy) * t0 + wy * t1


def warp_tiled(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, max_base: int
) -> torch.Tensor:
    """K4 wrapper: the kernel for CUDA tensors, the plain version for CPU.

    img [N,H,W] f32 contiguous; u, v [N,H,W] f32, each plane contiguous
    and u, v with the same stride between images (the two channels of a
    contiguous [N,2,H,W] flow qualify).  max_base: a positive multiple of
    128 (`max_base_for`).
    """
    if int(max_base) <= 0 or int(max_base) % 128:
        raise ValueError(f"max_base {max_base} must be a positive multiple of 128")
    if not img.is_cuda:
        return warp_tiled_plain(img, u, v, int(max_base))
    N, H, W = img.shape
    check_planes(img, u, v)
    out = torch.empty_like(img)
    build.call("v2e_warp_tiled", img.device, img, u, v, out, N, H, W, u.stride(0),
               int(max_base), counter="launch.k4")
    return out
