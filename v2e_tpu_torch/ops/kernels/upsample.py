"""K6: bilinear x2 upsample of [N,C,H,W] images, F.interpolate(x,
scale_factor=2, mode="bilinear", align_corners=False), and its VJP.

Replaces no Pallas kernel: the JAX package leaves the UNets' upsample to
jax.image.resize (v2e_tpu/models/unet.py::_upsample2_nhwc).  `upsample2x`
launches the CUDA kernel (csrc/upsample.cu) for CUDA tensors and runs
`upsample2x_plain` for CPU tensors; `upsample2x_vjp` likewise launches the
VJP kernel or runs `upsample2x_plain_vjp`.  `Upsample2xFn` joins the two
for autograd (the UNets' up path, models/unet.py::_upsample2).

The plain versions write out the kernels' formulas over the whole tensor,
one axis at a time (`_up_along`, `_vjp_along`): F.interpolate's taps and
weights along W and then H, which is its expression h0 (w0 a + w1 b) +
h1 (w0 c + w1 d), in float32 and rounded once; the VJP gathers each
input's four outputs per axis, along W and then H in a fixed order.  On
the card the kernels equal them bit for bit (built with --fmad=false) and
F.interpolate to one ulp of the output type.

Design (see the source's note): bound by memory bytes; one thread per V
input pixels of a row (NCHW) or V channels of a pixel (channels_last), so
no thread loops over the N*C planes as F.interpolate's NCHW kernel does.
The forward takes bfloat16, float16 and float32, contiguous NCHW or
channels_last, and returns the input's layout; any other strides are made
contiguous once.  The VJP kernel is built for float32 NCHW, training's type
and layout; its wrapper converts any other gradient once.
"""
from __future__ import annotations

import torch

from v2e_tpu_torch.ops.kernels import build

# the kernels' dtype codes (csrc/upsample.cu)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _channels_last(x: torch.Tensor) -> bool:
    """Whether x is laid out channels_last (and not also contiguous NCHW,
    as a tensor with one channel or one pixel is)."""
    return not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def _format(channels_last: bool) -> torch.memory_format:
    return torch.channels_last if channels_last else torch.contiguous_format


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 input (which only the CPU takes)."""
    return torch.promote_types(dtype, torch.float32)


def _up_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bilinear x2 of x along `dim` (2 or 3), in x's type: output 2i is
    0.25 x[i-1] + 0.75 x[i], output 0 is 1 x[0] + 0 x[min(1, n-1)], output
    2i+1 is 0.75 x[i] + 0.25 x[min(i+1, n-1)] (F.interpolate's taps and
    weights), each product and sum rounded once."""
    n = x.shape[dim]
    q, t = 0.25 * x, 0.75 * x
    out = torch.empty(x.shape[:dim + 1] + (2,) + x.shape[dim + 1:], dtype=x.dtype,
                      device=x.device)
    even, odd = out.select(dim + 1, 0), out.select(dim + 1, 1)
    if n > 1:
        torch.add(q.narrow(dim, 0, n - 1), t.narrow(dim, 1, n - 1),
                  out=even.narrow(dim, 1, n - 1))
        torch.add(t.narrow(dim, 0, n - 1), q.narrow(dim, 1, n - 1),
                  out=odd.narrow(dim, 0, n - 1))
    first = 1.0 * x.narrow(dim, 0, 1) + 0.0 * x.narrow(dim, min(1, n - 1), 1)
    even.narrow(dim, 0, 1).copy_(first)
    odd.narrow(dim, n - 1, 1).copy_(t.narrow(dim, n - 1, 1) + q.narrow(dim, n - 1, 1))
    return out.flatten(dim, dim + 1)


def upsample2x_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bilinear x2 of x along the one axis `dim` (2 or 3) with K6's taps
    and weights, in float32 (float64 for float64 input), rounded once to
    x's type.  For the fold's one-pixel border lines (models/unet.py::
    upconv_fold), a few hundred pixels each."""
    return _up_along(x.to(_acc(x.dtype)), dim).to(x.dtype)


def _vjp_along(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of `_up_along` on g (2n samples along `dim`): input i
    collects w0 g[2i-1] + w1 g[2i] + w2 g[2i+1] + w3 g[2i+2], summed left to
    right, with (w0, w1) = (0.25, 0.75) or (0, 1) at i = 0, (w2, w3) =
    (0.75, 0.25) or (1, 0) at i = n-1, and the outputs out of range clamped
    into 0 .. 2n-1 (their weight is 0)."""
    n = g.shape[dim] // 2
    pairs = g.unflatten(dim, (n, 2))
    even, odd = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)
    prev = torch.cat([even.narrow(dim, 0, 1), odd.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([even.narrow(dim, 1, n - 1), odd.narrow(dim, n - 1, 1)], dim)
    i = torch.arange(n, device=g.device).reshape((n,) + (1,) * (g.dim() - 1 - dim))

    def w(cond, yes, no):
        return torch.where(cond, yes, no).to(g.dtype)

    inner, outer = i >= 1, i <= n - 2
    u = w(inner, 0.25, 0.0) * prev + w(inner, 0.75, 1.0) * even
    u = u + w(outer, 0.75, 1.0) * odd
    return u + w(outer, 0.25, 0.0) * nxt


def _check(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what}: expected [N,C,H,W], got shape {tuple(x.shape)}")
    if what.endswith("vjp") and (x.shape[2] % 2 or x.shape[3] % 2):
        raise ValueError(f"{what}: odd output size {x.shape[2]}x{x.shape[3]}")


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """What K6 computes, in plain PyTorch: x [N,C,H,W] -> [N,C,2H,2W] in
    x's type and layout (channels_last stays channels_last), along W and
    then H in float32 (float64 for float64 input), rounded once."""
    _check(x, "upsample2x")
    out = _up_along(_up_along(x.to(_acc(x.dtype)), 3), 2)
    return out.to(x.dtype).contiguous(memory_format=_format(_channels_last(x)))


def upsample2x_plain_vjp(gout: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
    """The VJP of `upsample2x_plain` for the output gradient gout
    [N,C,2H,2W]: the input gradient [N,C,H,W] in gout's type, laid out
    channels_last when `channels_last`; summed along W and then H in
    float32 (float64 for float64), rounded once."""
    _check(gout, "upsample2x_vjp")
    gx = _vjp_along(_vjp_along(gout.to(_acc(gout.dtype)), 3), 2)
    return gx.to(gout.dtype).contiguous(memory_format=_format(channels_last))


def _check_cuda(x: torch.Tensor, what: str) -> None:
    _check(x, what)
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: K6 takes {sorted(map(str, _DTYPES))}, got {x.dtype}")


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """K6 wrapper: bilinear x2 of x [N,C,H,W] -> [N,C,2H,2W] in x's type
    and layout; the kernel for CUDA tensors (bfloat16, float16, float32,
    any other type raises), `upsample2x_plain` for CPU tensors."""
    if not x.is_cuda:
        return upsample2x_plain(x)
    _check_cuda(x, "upsample2x")
    nhwc = _channels_last(x)
    x = x.contiguous(memory_format=_format(nhwc))
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                      memory_format=_format(nhwc))
    if out.numel():
        build.call("v2e_upsample_bilinear2x", x.device, x, out, n, c, h, w,
                   _DTYPES[x.dtype], int(nhwc), counter="launch.k6")
    return out


def upsample2x_vjp(gout: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
    """K6's VJP wrapper: the input gradient [N,C,H,W] of the output
    gradient gout [N,C,2H,2W], in gout's type, laid out channels_last when
    `channels_last`; the kernel for CUDA tensors (the types of
    `upsample2x`), `upsample2x_plain_vjp` for CPU tensors.  The kernel runs
    in float32 NCHW, training's type and layout: any other gout is copied
    to it once (exactly), and the float32 sums are rounded once to gout's
    type, as the plain version rounds them."""
    if not gout.is_cuda:
        return upsample2x_plain_vjp(gout, channels_last)
    _check_cuda(gout, "upsample2x_vjp")
    n, c, h2, w2 = gout.shape
    g = gout.to(torch.float32, memory_format=torch.contiguous_format)
    gx = torch.empty((n, c, h2 // 2, w2 // 2), dtype=torch.float32, device=g.device)
    if gx.numel():
        build.call("v2e_upsample_bilinear2x_vjp", g.device, g, gx, n, c, h2 // 2, w2 // 2,
                   counter="launch.k6_vjp")
    return gx.to(gout.dtype, memory_format=_format(channels_last))


class Upsample2xFn(torch.autograd.Function):
    """K6 with its gradient: `apply(x)` is `upsample2x(x)`, and its backward
    runs `upsample2x_vjp` into x's layout.  The wrappers pick the kernels for
    CUDA tensors and the plain versions for CPU tensors.  The backward is
    not differentiable: a double backward raises."""

    @staticmethod
    def forward(ctx, x):
        ctx.channels_last = _channels_last(x)
        return upsample2x(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        return upsample2x_vjp(gout, ctx.channels_last)
