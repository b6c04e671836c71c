"""K6's plain versions (v2e_tpu_torch/ops/kernels/upsample.py:
`upsample2x_plain`, `upsample2x_plain_vjp`, `Upsample2xFn`) against
F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False) and
its autograd, on the CPU.

Shapes: up levels of the UNet at base 8 on 64x96 frames, and ragged ones
(one row, one column, one pixel, odd sizes).  Tolerances are in ulps of a
type at the binade of the taps' scale (the upsample of |x|, or the VJP of
|gout|): an output rounded to bf16 is within one bf16 ulp of another
rounding of the same float32 sum; in float32 the plain forward and
F.interpolate (whose CPU kernel rounds its products otherwise) are each up
to 2.5 ulps off the exact sum (measured over 20 seeds), so within 3 of
each other, and the plain VJP, eight products and six sums, within 4 of
autograd in float64 (measured 2.24).  The kernels themselves run only on
the card (tests/test_torch_kernels_gpu.py).
"""
import pytest
import torch
import torch.nn.functional as F

from v2e_tpu_torch import tracing
from v2e_tpu_torch.models.unet import _upsample2
from v2e_tpu_torch.ops.kernels.upsample import (
    Upsample2xFn,
    upsample2x_along,
    upsample2x_plain,
    upsample2x_plain_vjp,
)

# (N, C, H, W) inputs: the UNet's up1, up3 and up5 at base 8 on 64x96
# frames, and ragged shapes
SHAPES = [(2, 128, 2, 3), (2, 64, 8, 12), (2, 16, 32, 48),
          (1, 3, 1, 5), (1, 2, 4, 1), (1, 1, 1, 1), (2, 5, 7, 9)]
DTYPES = [torch.float32, torch.bfloat16]


def library(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def ulp(scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of `dtype` at each element's magnitude `scale` (float64),
    the smallest normal's ulp at zero."""
    fi = torch.finfo(dtype)
    s = scale.to(torch.float64).abs().clamp(min=fi.tiny)
    return fi.eps * torch.exp2(torch.floor(torch.log2(s)))


def within_ulps(got, want, scale, dtype, n=1.0) -> bool:
    err = (got.to(torch.float64) - want.to(torch.float64)).abs()
    return bool((err <= n * ulp(scale, dtype)).all())


def inputs(shape, dtype, seed=0, channels_last=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return x.contiguous(memory_format=fmt)


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_interpolate(shape, dtype, channels_last):
    x = inputs(shape, dtype, channels_last=channels_last)
    got = upsample2x_plain(x)
    want = library(x)
    assert got.dtype == dtype and got.shape == want.shape
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt)
    n_ulps = 3.0 if dtype == torch.float32 else 1.0
    assert within_ulps(got, want, library(x.abs().to(torch.float64)), dtype, n_ulps)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_vjp_matches_interpolate_autograd(shape, dtype):
    n, c, h, w = shape
    gout = inputs((n, c, 2 * h, 2 * w), dtype, seed=1)
    x = torch.zeros(shape, dtype=torch.float64, requires_grad=True)
    library(x).backward(gout.to(torch.float64))
    got = upsample2x_plain_vjp(gout)
    assert got.dtype == dtype and got.is_contiguous()
    scale = upsample2x_plain_vjp(gout.to(torch.float64).abs())
    if dtype == torch.float32:
        assert within_ulps(got, x.grad, scale, torch.float32, 4.0)
    else:  # float32 sums, then one rounding to the output type
        assert within_ulps(got, x.grad, scale, dtype)


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
def test_upsample_fn_on_cpu_runs_the_plain_versions(channels_last):
    """Upsample2xFn (the UNets' `_upsample2`) on a CPU tensor: the plain
    forward and VJP, in the input's layout, and no kernel launch."""
    x = inputs((2, 16, 8, 12), torch.float32, seed=2, channels_last=channels_last)
    gout = inputs((2, 16, 16, 24), torch.float32, seed=3)
    before = tracing.counters()
    xg = x.clone().requires_grad_()
    out = _upsample2(xg)
    out.backward(gout)
    assert torch.equal(out, upsample2x_plain(x))
    assert torch.equal(xg.grad, upsample2x_plain_vjp(gout, channels_last))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert out.is_contiguous(memory_format=fmt) and xg.grad.is_contiguous(memory_format=fmt)
    after = tracing.counters()
    for k in ("launch.k6", "launch.k6_vjp"):
        assert after.get(k, 0) == before.get(k, 0)


def test_upsample_fn_gradcheck():
    x = torch.randn((1, 2, 3, 4), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(Upsample2xFn.apply, (x,))


def test_upsample_along_composes_to_the_plain_upsample():
    """`upsample2x_along`, the fold's border lines, is the plain version's
    pass along one axis: along W and then H in float32 it equals it."""
    x = inputs((2, 5, 7, 9), torch.float32, seed=4)
    assert torch.equal(upsample2x_along(upsample2x_along(x, 3), 2), upsample2x_plain(x))
