"""K8: the UNets' conv epilogue on the inference path, NHWC: bias,
LeakyReLU(0.1) and, optionally, the concatenation with an up level's skip,
in one pass over the conv's output.

Replaces no Pallas kernel: the JAX package's NHWC UNet leaves bias and
activation to XLA's fusion (v2e_tpu/models/unet.py::_conv_block).
`conv_bias_leaky` launches the CUDA kernel (csrc/conv_epilogue.cu) for
CUDA tensors and runs `conv_bias_leaky_plain` for CPU tensors
(models/unet.py's inference path, `UNet._fused`).

    out = round(LeakyReLU_0.1(float(y) + bias))         without a skip
    out = cat([that, skip], channel axis)                with a skip

y and skip are [N,C,H,W] tensors laid out channels_last (NHWC in memory),
as F.conv2d returns them for channels_last input and weights; bias is the
float32 master bias [Co] (`conv.bias_f32`), added before the one rounding
to y's type, as K5's epilogue does.  The skip is copied exactly.  The
output is channels_last too, so the next conv reads it with no transpose.

The kernel is bound by its bytes (see the source's note); it equals the
plain version bit for bit.  It takes bfloat16, float16 and float32 tensors
that are NHWC-contiguous and 16-byte aligned, the conv outputs the
allocator hands the UNet: anything else is refused, never copied or run on
the kernel's scalar path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from v2e_tpu_torch.ops.kernels import build

# the kernel's dtype codes (csrc/conv_epilogue.cu)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
NEGATIVE_SLOPE = 0.1


def _check(y: torch.Tensor, bias: torch.Tensor, skip: Optional[torch.Tensor]) -> None:
    for what, t in (("y", y), ("skip", skip)):
        if t is None:
            continue
        if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"conv_bias_leaky: {what} must be [N,C,H,W] laid out "
                             f"channels_last (NHWC), got shape {tuple(t.shape)} "
                             f"strides {t.stride()}")
    if skip is not None and (skip.shape != y.shape or skip.dtype != y.dtype):
        raise ValueError(f"conv_bias_leaky: skip {tuple(skip.shape)} {skip.dtype} does "
                         f"not match y {tuple(y.shape)} {y.dtype}")
    if bias.shape != (y.shape[1],) or bias.dtype != torch.float32:
        raise ValueError(f"conv_bias_leaky: bias must be float32 [{y.shape[1]}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def _empty_out(y: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
    n, c, h, w = y.shape
    return torch.empty((n, 2 * c if skip is not None else c, h, w), dtype=y.dtype,
                       device=y.device, memory_format=torch.channels_last)


def conv_bias_leaky_plain(y: torch.Tensor, bias: torch.Tensor,
                          skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What K8 computes, in plain PyTorch: LeakyReLU(0.1) of y plus the
    float32 bias, in float32 (float64 for float64 y), rounded once to y's
    type, then the skip beside it on the channel axis; channels_last."""
    _check(y, bias, skip)
    acc = torch.promote_types(y.dtype, torch.float32)
    v = F.leaky_relu(y.to(acc) + bias.to(acc)[:, None, None], NEGATIVE_SLOPE).to(y.dtype)
    if skip is None:
        return v.contiguous(memory_format=torch.channels_last)
    out = _empty_out(y, skip)
    c = y.shape[1]
    out[:, :c] = v
    out[:, c:] = skip
    return out


def conv_bias_leaky(y: torch.Tensor, bias: torch.Tensor,
                    skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 wrapper: the epilogue of the bias-free conv output y (and the
    skip beside it, if given) as a new channels_last tensor; the kernel for
    CUDA tensors (bfloat16, float16, float32, NHWC-contiguous, 16-byte
    aligned: anything else raises), `conv_bias_leaky_plain` for CPU
    tensors."""
    if not y.is_cuda:
        return conv_bias_leaky_plain(y, bias, skip)
    _check(y, bias, skip)
    if y.dtype not in _DTYPES:
        raise TypeError(f"conv_bias_leaky: K8 takes {sorted(map(str, _DTYPES))}, got {y.dtype}")
    if not bias.is_cuda or not bias.is_contiguous():
        raise ValueError("conv_bias_leaky: bias must be a contiguous tensor on y's device")
    for what, t in (("y", y), ("skip", skip)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"conv_bias_leaky: {what} is not 16-byte aligned")
    out = _empty_out(y, skip)
    n, c, h, w = y.shape
    if out.numel():
        build.call("v2e_conv_bias_leaky", y.device, y, bias, skip, out, n * h * w, c,
                   _DTYPES[y.dtype], counter="launch.k8")
    return out
