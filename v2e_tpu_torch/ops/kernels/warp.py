"""K3: bilinear backwarp of single-plane images (torch grid_sample with
align_corners=False and zero padding, sampling at x+u-0.5, y+v-0.5).

Replaces v2e_tpu/ops/pallas/warp.py::bilinear_warp_pallas.  `bilinear_warp`
launches the CUDA kernel (csrc/warp.cu) for CUDA tensors and runs
`warp_plain`, the 4-tap gather of v2e_tpu/models/backwarp.py::backwarp, for
CPU tensors.  Its gradient for SuperSloMo training is `BilinearWarpFn`:
the forward is K3, the backward `bilinear_warp_vjp`, a second kernel in the
same source (its plain version `warp_plain_vjp` writes out the autodiff of
backwarp that the JAX package leaves to XLA).

Design (see the source's note): one thread per output pixel gathers its
four taps in f32.  Bound by memory bytes: 16 B per pixel (image, two flow
planes, output).  Decision: the port computes the exact warp with no
+-max_disp clamp of the flow, so it equals backwarp for any flow and takes
no window; the TPU kernel clamped to a window bucketed from the chunk's
max flow, which covered that flow, so the two agree on the main path.
The TPU's default bf16 ("1pass") weights were a matrix-unit artifact; the
port computes in f32.
"""
from __future__ import annotations

import torch

from v2e_tpu_torch.ops.kernels import build


def _taps(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The four taps (00, 10, 01, 11) of every output pixel, sampled at
    (x + u - 0.5, y + v - 0.5): the bilinear fractions (wx, wy) and for each
    tap its flat clamped index [N,H*W], its in-bounds mask and its weight."""
    n, H, W = img.shape
    gx = torch.arange(W, dtype=img.dtype, device=img.device)[None, None, :]
    gy = torch.arange(H, dtype=img.dtype, device=img.device)[None, :, None]
    x = gx + u - 0.5
    y = gy + v - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    taps = []
    for xi, yi, w in ((x0, y0, (1 - wx) * (1 - wy)), (x0 + 1, y0, wx * (1 - wy)),
                      (x0, y0 + 1, (1 - wx) * wy), (x0 + 1, y0 + 1, wx * wy)):
        inb = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).to(img.dtype)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        taps.append(((yc * W + xc).reshape(n, H * W), inb, w))
    return wx, wy, taps


def _gather(img: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    n, H, W = img.shape
    return torch.gather(img.reshape(n, H * W), 1, at).reshape(n, H, W)


def warp_plain(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample img [N,H,W] at (x + u - 0.5, y + v - 0.5) bilinearly; taps
    outside the image contribute zero.  u, v: [N,H,W]."""
    _, _, taps = _taps(img, u, v)
    out = None
    for at, inb, w in taps:
        term = _gather(img, at) * (w * inb)
        out = term if out is None else out + term
    return out


def warp_plain_vjp(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, gout: torch.Tensor,
    need_img: bool = False,
):
    """The VJP of `warp_plain` at (img, u, v) for the output gradient gout
    [N,H,W]: (grad_flow [N,2,H,W] with grad_u in channel 0 and grad_v in 1,
    grad_img [N,H,W] or None unless `need_img`).  The floor and the clamped
    tap indices have zero gradient, as in JAX's autodiff of backwarp.  The
    formulas and their order of operations are the VJP kernel's."""
    wx, wy, taps = _taps(img, u, v)
    v00, v10, v01, v11 = (_gather(img, at) * inb for at, inb, _ in taps)
    omx = 1 - wx
    omy = 1 - wy
    du = (((-omy) * v00 + omy * v10) - wy * v01) + wy * v11
    dv = (((-omx) * v00 - wx * v10) + omx * v01) + wx * v11
    grad_flow = torch.stack([gout * du, gout * dv], dim=1)
    if not need_img:
        return grad_flow, None
    n, H, W = img.shape
    grad_img = torch.zeros((n, H * W), dtype=img.dtype, device=img.device)
    for at, inb, w in taps:
        grad_img.scatter_add_(1, at, (gout * w * inb).reshape(n, H * W))
    return grad_flow, grad_img.reshape(n, H, W)


def check_planes(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless img, u and v are the planes K3 and K4 take (see
    `bilinear_warp`)."""
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


def bilinear_warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: the kernel for CUDA tensors, the plain version for CPU.

    img [N,H,W] f32 contiguous; u, v [N,H,W] f32, each plane contiguous
    and u, v with the same stride between images (the two channels of a
    contiguous [N,2,H,W] flow qualify).  The flow is not clamped (see the
    module note).
    """
    if not img.is_cuda:
        return warp_plain(img, u, v)
    N, H, W = img.shape
    check_planes(img, u, v)
    out = torch.empty_like(img)
    build.call("v2e_bilinear_warp", img.device, img, u, v, out, N, H, W, u.stride(0),
               counter="launch.k3")
    return out


def bilinear_warp_vjp(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, gout: torch.Tensor,
    need_img: bool = False,
):
    """K3's VJP wrapper: the kernel for CUDA tensors, `warp_plain_vjp` for
    CPU tensors.  Inputs as for `bilinear_warp`, and gout [N,H,W] f32.
    Returns (grad_flow [N,2,H,W], grad_img [N,H,W] or None unless
    `need_img`)."""
    if not img.is_cuda:
        return warp_plain_vjp(img, u, v, gout, need_img)
    N, H, W = img.shape
    check_planes(img, u, v)
    if gout.dtype != torch.float32 or tuple(gout.shape) != (N, H, W) or gout.device != img.device:
        raise ValueError(f"gout: expected float32 {(N, H, W)} on {img.device}, got "
                         f"{gout.dtype} {tuple(gout.shape)} on {gout.device}")
    gout = gout.contiguous()
    grad_flow = torch.empty((N, 2, H, W), dtype=torch.float32, device=img.device)
    grad_img = torch.zeros_like(img) if need_img else None
    build.call("v2e_bilinear_warp_bwd", img.device, img, u, v, gout, grad_flow,
               grad_flow[:, 1], grad_img, N, H, W, u.stride(0), grad_flow.stride(0),
               counter="launch.k3_vjp")
    return grad_flow, grad_img


class BilinearWarpFn(torch.autograd.Function):
    """K3 with its gradient: `apply(img [N,H,W], flow [N,2,H,W])` warps as
    `bilinear_warp` (flow channel 0 = u, 1 = v; each [H,W] plane
    contiguous), and its backward runs `bilinear_warp_vjp`, asking for the
    image gradient only when img needs one.  The wrappers pick the kernels
    for CUDA tensors and the plain versions for CPU tensors.  The backward
    is not differentiable on either device: a double backward raises."""

    @staticmethod
    def forward(ctx, img, flow):
        ctx.save_for_backward(img, flow)
        return bilinear_warp(img, flow[:, 0], flow[:, 1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        img, flow = ctx.saved_tensors
        grad_flow, grad_img = bilinear_warp_vjp(
            img, flow[:, 0], flow[:, 1], gout, ctx.needs_input_grad[0]
        )
        return grad_img, (grad_flow if ctx.needs_input_grad[1] else None)
