"""K3: bilinear backwarp of single-plane images (torch grid_sample with
align_corners=False and zero padding, sampling at x+u-0.5, y+v-0.5).

Replaces v2e_tpu/ops/pallas/warp.py::bilinear_warp_pallas.  `bilinear_warp`
launches the CUDA kernel (csrc/warp.cu) for CUDA tensors and runs
`warp_plain`, the 4-tap gather of v2e_tpu/models/backwarp.py::backwarp, for
CPU tensors.

Design (see the source's note): one thread per output pixel gathers its
four taps in f32.  Bound by memory bytes: 16 B per pixel (image, two flow
planes, output).  Decision: the port computes the exact warp with no
+-max_disp clamp of the flow, so it equals backwarp for any flow; the
TPU kernel clamped to the window, which on the main path already covers the
chunk's flow (SuperSloMo._choose_disp), so the two agree there.  The TPU's
default bf16 ("1pass") weights were a matrix-unit artifact; the port
computes in f32.
"""
from __future__ import annotations

import ctypes

import torch

from v2e_tpu_torch.ops.kernels import build


def warp_plain(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample img [N,H,W] at (x + u - 0.5, y + v - 0.5) bilinearly; taps
    outside the image contribute zero.  u, v: [N,H,W]."""
    n, H, W = img.shape
    gx = torch.arange(W, dtype=img.dtype, device=img.device)[None, None, :]
    gy = torch.arange(H, dtype=img.dtype, device=img.device)[None, :, None]
    x = gx + u - 0.5
    y = gy + v - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    flat = img.reshape(n, H * W)

    def tap(xi, yi, w):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        vals = torch.gather(flat, 1, (yc * W + xc).reshape(n, H * W))
        return vals.reshape(n, H, W) * (w * inb.to(img.dtype))

    return (
        tap(x0, y0, (1 - wx) * (1 - wy))
        + tap(x0 + 1, y0, wx * (1 - wy))
        + tap(x0, y0 + 1, (1 - wx) * wy)
        + tap(x0 + 1, y0 + 1, wx * wy)
    )


def bilinear_warp(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, max_disp: int = 32
) -> torch.Tensor:
    """K3 wrapper: the kernel for CUDA tensors, the plain version for CPU.

    img [N,H,W] f32 contiguous; u, v [N,H,W] f32, each plane contiguous
    and u, v with the same stride between images (the two channels of a
    contiguous [N,2,H,W] flow qualify).  `max_disp` is the displacement
    window the caller chose; it is recorded in `bilinear_warp.last_max_disp`
    and does not clamp the flow (see the module note).
    """
    if int(max_disp) <= 0:
        raise ValueError(f"max_disp {max_disp} must be positive")
    bilinear_warp.last_max_disp = int(max_disp)
    if not img.is_cuda:
        return warp_plain(img, u, v)
    N, H, W = img.shape
    for name, t in (("img", img), ("u", u), ("v", v)):
        if t.dtype != torch.float32 or tuple(t.shape) != (N, H, W) or t.device != img.device:
            raise ValueError(
                f"{name}: expected float32 {(N, H, W)} on {img.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    for name, t in (("u", u), ("v", v)):
        if t.stride()[1:] != (W, 1):
            raise ValueError(f"{name}: each [H,W] plane must be contiguous")
    if u.stride(0) != v.stride(0):
        raise ValueError("u and v must have the same stride between images")
    out = torch.empty_like(img)
    fn = build.load("warp").v2e_bilinear_warp
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            ctypes.c_void_p(img.data_ptr()), ctypes.c_void_p(u.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            N, H, W, u.stride(0), ctypes.c_void_p(stream),
        )
    build.check(err, "bilinear_warp")
    bilinear_warp.launches += 1
    return out


# kernel launches made by `bilinear_warp`
bilinear_warp.launches = 0
bilinear_warp.last_max_disp = None
