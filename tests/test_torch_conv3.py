"""K5's plain version (v2e_tpu_torch/ops/kernels/conv3.py) against the JAX
package's lane conv kernel (v2e_tpu/ops/pallas/conv3.py::conv3x3_lane, in
Pallas interpret mode on the CPU), and the port's folded upsample+conv
(models/unet.py::upconv_fold) against the JAX fold.

Shapes: those of tests/test_conv3_lane.py (single-strip and ragged widths
12, 20 and 24, both TPU modes), the UNet's own up-tail layers (128->64 and
64->32) at a small batch, and, for the fold, those of
tests/test_unet_fold.py (the degenerate 1x1 case and the thin strips).

Tolerances:
* K5 in float32: 1e-5 absolute (both sum in float32, in another order;
  inputs of unit scale).
* K5 in bf16: every element within one bf16 ulp of the larger of the two
  values, or 1e-6 absolute near zero, where the two float32 sums' own
  rounding (about 1e-7 for 1152 terms) exceeds a bf16 ulp; and at most
  0.1 % of the elements differ at all (measured 0.01-0.02 %: only where the
  float32 sum lies within its rounding of a bf16 rounding boundary).  The
  dense epilogue, which rounds the conv and the bias add separately,
  differs at 20-40 % of the elements, and a bfloat16 bias at 11-16 %.
* The fold in float32: 3e-5 absolute, 1e-5 relative, as
  tests/test_unet_fold.py holds the JAX fold to the staged pair.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from v2e_tpu.models.unet import _upconv_fold_block
from v2e_tpu.ops.pallas.conv3 import conv3x3_lane as jax_conv3x3_lane
from v2e_tpu_torch.models.unet import upconv_fold, upfold_kernel
from v2e_tpu_torch import tracing
from v2e_tpu_torch.ops.kernels.conv3 import conv3x3_lane, conv3x3_lane_plain, shape_counts


def bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    m, e = np.frexp(np.abs(v).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def assert_bf16_close(got, want, max_share=1e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = np.maximum(bf16_ulp(np.maximum(np.abs(got), np.abs(want))), 1e-6)
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{int(bad.sum())} elements beyond one bf16 ulp"
    share = float(np.mean(got != want))
    assert share <= max_share, f"{share:.4%} of the elements differ"
    return share


def inputs(n, h, w, ci, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    wt = (rng.standard_normal((co, ci, 3, 3)) / np.sqrt(9 * ci)).astype(np.float32)
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    return x, wt, b


CASES = [
    # (n, h, w, ci, co, mode, th): tests/test_conv3_lane.py's shapes
    (2, 16, 24, 8, 4, "hcol", 8),
    (2, 16, 24, 8, 4, "zfull", 8),
    (1, 32, 20, 16, 8, "auto", 8),
    (3, 8, 12, 4, 4, "hcol", 8),  # single strip: both halos masked
    (1, 24, 16, 8, 16, "zfull", 8),
    # the UNet's up4 (128->64) and up5 (64->32) layers at a small batch
    (2, 16, 20, 128, 64, "auto", None),
    (2, 32, 24, 64, 32, "auto", None),
]


@pytest.mark.parametrize("n,h,w,ci,co,mode,th", CASES)
def test_plain_matches_jax_f32(n, h, w, ci, co, mode, th):
    x, wt, b = inputs(n, h, w, ci, co, seed=h * w + ci)
    want = np.asarray(jax_conv3x3_lane(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                       mode=mode, th=th, interpret=True))
    got = conv3x3_lane_plain(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, h, w, co)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,h,w,ci,co,mode,th", CASES)
def test_plain_matches_jax_bf16(n, h, w, ci, co, mode, th):
    x, wt, b = inputs(n, h, w, ci, co, seed=h * w + ci + 1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_conv3x3_lane(xb, jnp.asarray(wt), jnp.asarray(b), mode=mode, th=th,
                            interpret=True)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = conv3x3_lane_plain(xt, torch.from_numpy(wt), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_bf16_tolerance_separates_the_epilogues():
    """At the up4 shape the tolerance that K5's plain version meets is one
    that the dense epilogue (conv and bias rounded separately) and a
    bfloat16 bias both miss."""
    x, wt, b = inputs(2, 16, 32, 128, 64, seed=0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_conv3x3_lane(xb, jnp.asarray(wt), jnp.asarray(b),
                                       interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    wt_t, b_t = torch.from_numpy(wt), torch.from_numpy(b)
    assert_bf16_close(conv3x3_lane_plain(xt, wt_t, b_t).float().numpy(), want)
    dense = F.leaky_relu(F.conv2d(xt.permute(0, 3, 1, 2), wt_t.bfloat16(), b_t.bfloat16(),
                                  padding=1), 0.1).permute(0, 2, 3, 1)
    bf16_bias = conv3x3_lane_plain(xt, wt_t, b_t.bfloat16())
    for other in (dense, bf16_bias):
        with pytest.raises(AssertionError):
            assert_bf16_close(other.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_without_activation(dtype):
    x, wt, b = inputs(1, 8, 12, 4, 4, seed=3)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_conv3x3_lane(xj, jnp.asarray(wt), jnp.asarray(b), mode="zfull",
                                       neg_slope=None, th=8, interpret=True)
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = conv3x3_lane_plain(xt, torch.from_numpy(wt), torch.from_numpy(b), neg_slope=None)
    assert (want < 0).any()  # no activation: negative outputs stay
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        assert_bf16_close(got.float().numpy(), want)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    x, wt, b = inputs(2, 8, 12, 16, 32, seed=5)
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(wt), torch.from_numpy(b))
    n0 = tracing.counters().get("launch.k5", 0)
    shapes = shape_counts(tracing.counters())
    got = conv3x3_lane(*args)
    assert torch.equal(got, conv3x3_lane_plain(*args))
    assert tracing.counters().get("launch.k5", 0) == n0  # launches count the CUDA kernel only
    key = ((2, 8, 12, 16), 32)
    assert shape_counts(tracing.counters())[key] == shapes.get(key, 0) + 1


@pytest.mark.parametrize(
    "n,h,w,ci,co",
    [
        (2, 8, 12, 7, 5),    # generic odd channel counts
        (1, 9, 11, 16, 32),  # odd spatial
        (2, 1, 1, 4, 3),     # degenerate 1x1
        (1, 2, 16, 32, 16),  # thin strip
        (1, 16, 2, 8, 8),
    ],
)
def test_upconv_fold_matches_jax(n, h, w, ci, co):
    rng = np.random.default_rng(n * 100 + h * 10 + ci)
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    wt = (rng.normal(size=(co, ci, 3, 3)) * 0.2).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    want = np.asarray(_upconv_fold_block(jnp.asarray(x), {"w": jnp.asarray(wt),
                                                          "b": jnp.asarray(b)}))
    conv = torch.nn.Conv2d(ci, co, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(wt))
        conv.bias.copy_(torch.from_numpy(b))
        got = upconv_fold(torch.from_numpy(x).permute(0, 3, 1, 2), conv,
                          upfold_kernel(conv.weight))
    assert tuple(got.shape) == (n, co, 2 * h, 2 * w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=3e-5, rtol=1e-5)
