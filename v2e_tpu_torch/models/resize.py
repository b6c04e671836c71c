"""Separable image resize with the JAX package's semantics
(jax.image.resize, i.e. scale-and-translate with antialiasing).

torch.nn.functional.interpolate has no lanczos kernel and treats the edges
differently when antialiasing, so the port builds the same per-axis weight
matrices as JAX in numpy and applies them with two einsums:

* sample position of output pixel j: (j + 0.5) / scale - 0.5 (half-pixel
  centres);
* when downscaling, the kernel is widened by 1/scale (low-pass first);
* each output's weights are renormalised to sum to 1, which drops the taps
  that fall outside the input at the borders.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _lanczos3(x: np.ndarray) -> np.ndarray:
    radius = np.float32(3.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        out = np.where(
            x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1), np.float32(1.0)
        )
    return np.where(x > radius, np.float32(0.0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), 1 - np.abs(x)).astype(np.float32)


_KERNELS = {"lanczos3": _lanczos3, "bilinear": _triangle}


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """f32[in_size, out_size] resampling weights of one axis."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _KERNELS[method](x.astype(np.float32))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize(x: torch.Tensor, out_hw, method: str) -> torch.Tensor:
    """Resize the last two axes of x [..., H, W] to `out_hw`; an axis whose
    size does not change is left alone, as JAX does."""
    H, W = x.shape[-2:]
    oh, ow = out_hw
    if H != oh:
        wh = torch.from_numpy(weight_matrix(H, oh, method)).to(x.device, x.dtype)
        x = torch.einsum("...hw,hH->...Hw", x, wh)
    if W != ow:
        ww = torch.from_numpy(weight_matrix(W, ow, method)).to(x.device, x.dtype)
        x = torch.einsum("...hw,wW->...hW", x, ww)
    return x
