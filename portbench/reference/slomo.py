"""Super-SloMo interpolation in plain PyTorch (Jiang et al., CVPR 2018,
arXiv:1711.00080; the public PyTorch code v2e's SloMo derives from), as v2e
runs it on a chunk of source frames.

* Frames are scaled to 0-1, the dataset mean 0.428 taken off, and resized
  to the UNets' size (each axis rounded down to a multiple of 32) with a
  Lanczos-3 kernel, antialiased when shrinking (the scale-and-translate
  resize of jax.image.resize, which the port follows).
* The flow UNet gives F_0_1 and F_1_0 per pair; for each intermediate time
  t = (i + 0.5) / U the flows are blended (paper eq. 4), I0 and I1 are
  backwarped (bilinear, zero padding, the sample at p + flow - 0.5 as the
  public code's grid_sample grid puts it), the refinement UNet adds flow
  residuals and a visibility map, and the warped frames are blended (eq. 1).
* The frames are resized back bilinearly, the mean added, scaled to 0-255,
  clipped and rounded to 8-bit levels.

`precision` chooses the UNets' arithmetic: "f32" (float32, TF32 off: the
reference), "bf16" (every conv in bfloat16) or "fp8" (every conv's input
and weights rounded to float8 e4m3 with one scale per tensor, the products
summed in float32): the lower precisions are the controls.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MEAN = 0.428
Weights = Dict[str, Tuple[torch.Tensor, torch.Tensor]]  # layer -> (OIHW w, b)


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls in float32 (PyTorch lets cuDNN
    use TF32 by default)."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude to the format's 448), back in float32."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _conv(x: torch.Tensor, wb, precision: str) -> torch.Tensor:
    w, b = wb
    pad = (w.shape[-1] - 1) // 2
    if precision == "bf16":
        y = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16),
                     padding=pad).to(torch.float32)
    elif precision == "fp8":
        y = F.conv2d(_fp8(x), _fp8(w.float()), b.float(), padding=pad)
    else:
        y = F.conv2d(x, w.float(), b.float(), padding=pad)
    return F.leaky_relu(y, 0.1)


def unet(weights: Weights, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The Super-SloMo UNet on [N, C, h, w] float32 input (h, w multiples of
    32); LeakyReLU(0.1) after every conv, the output conv included."""
    x = _conv(x, weights["conv1"], precision)
    s = _conv(x, weights["conv2"], precision)
    skips = [s]
    x = s
    for i in range(1, 6):
        x = F.avg_pool2d(x, 2)
        x = _conv(x, weights[f"down{i}.conv1"], precision)
        x = _conv(x, weights[f"down{i}.conv2"], precision)
        if i < 5:
            skips.append(x)
    for i in range(1, 6):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        x = _conv(x, weights[f"up{i}.conv1"], precision)
        x = _conv(torch.cat([x, skips[5 - i]], dim=1), weights[f"up{i}.conv2"], precision)
    return _conv(x, weights["conv3"], precision)


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """[N,1,h,w] images sampled at p + flow - 0.5 (bilinear, zeros outside):
    the public code's backWarp, whose grid is 2 (p + flow) / size - 1."""
    n, _, h, w = img.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=img.device, dtype=img.dtype),
                            torch.arange(w, device=img.device, dtype=img.dtype), indexing="ij")
    x = 2.0 * (gx[None] + flow[:, 0]) / w - 1.0
    y = 2.0 * (gy[None] + flow[:, 1]) / h - 1.0
    grid = torch.stack([x, y], dim=-1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    out = np.where(np.abs(x) < 1e-3, 1.0,
                   3.0 * np.sin(np.pi * x) * np.sin(np.pi * x / 3.0)
                   / np.where(x == 0, 1.0, (np.pi * x) ** 2))
    return np.where(np.abs(x) > 3.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_matrix(n_in: int, n_out: int, kernel: str) -> np.ndarray:
    """[n_in, n_out] weights of a scale-and-translate resize along one
    axis: output j samples input position (j + 0.5) n_in / n_out - 0.5;
    when shrinking the kernel is widened by n_in / n_out; each output's
    weights are normalised to sum to 1 (taps past the border dropped); an
    output whose sample lies outside the input gets none."""
    k = {"lanczos3": _lanczos3, "bilinear": _triangle}[kernel]
    inv = n_in / n_out
    width = max(inv, 1.0)
    pos = (np.arange(n_out) + 0.5) * inv - 0.5
    w = k((pos[None, :] - np.arange(n_in)[:, None]) / width)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0.0)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(inside[None], w, 0.0)


def resize(x: torch.Tensor, h: int, w: int, kernel: str) -> torch.Tensor:
    """Resize the last two axes of x to (h, w); an axis that keeps its
    size is left alone."""
    H, W = x.shape[-2:]
    if H != h:
        m = torch.from_numpy(resize_matrix(H, h, kernel)).to(x.device, x.dtype)
        x = torch.einsum("...hw,hH->...Hw", x, m)
    if W != w:
        m = torch.from_numpy(resize_matrix(W, w, kernel)).to(x.device, x.dtype)
        x = torch.einsum("...hw,wW->...hW", x, m)
    return x


def unet_size(n: int) -> int:
    return max(32, (n // 32) * 32)


def interpolate_chunk(flow_w: Weights, interp_w: Weights, src: torch.Tensor, U: int,
                      precision: str = "f32") -> torch.Tensor:
    """Source frames u8 [B+1, H, W] -> the B*U interpolated frames [B*U, H,
    W] as float32 8-bit levels, frame k*U + i at pair k's time (i + 0.5)/U.
    Pairs run one at a time, so memory stays that of one pair's U frames."""
    H, W = src.shape[-2:]
    h, w = unet_size(H), unet_size(W)
    with no_tf32():
        x = resize(src.to(torch.float32) / 255.0 - MEAN, h, w, "lanczos3")[:, None]
        out = []
        for k in range(src.shape[0] - 1):
            I0, I1 = x[k:k + 1], x[k + 1:k + 2]
            flow = unet(flow_w, torch.cat([I0, I1], dim=1), precision)
            F01, F10 = flow[:, :2], flow[:, 2:]
            t = ((torch.arange(U, device=src.device, dtype=torch.float32) + 0.5) / U)[:, None, None, None]
            F01u, F10u = F01.expand(U, -1, -1, -1), F10.expand(U, -1, -1, -1)
            I0u, I1u = I0.expand(U, -1, -1, -1), I1.expand(U, -1, -1, -1)
            Ft0 = -(1 - t) * t * F01u + t * t * F10u
            Ft1 = (1 - t) * (1 - t) * F01u - t * (1 - t) * F10u
            g0 = backwarp(I0u, Ft0)
            g1 = backwarp(I1u, Ft1)
            r = unet(interp_w, torch.cat([I0u, I1u, F01u, F10u, Ft1, Ft0, g1, g0], dim=1), precision)
            Ft0f = r[:, 0:2] + Ft0
            Ft1f = r[:, 2:4] + Ft1
            V0 = torch.sigmoid(r[:, 4:5])
            V1 = 1 - V0
            g0f = backwarp(I0u, Ft0f)
            g1f = backwarp(I1u, Ft1f)
            w0, w1 = (1 - t) * V0, t * V1
            It = (w0 * g0f + w1 * g1f) / (w0 + w1)
            out.append(It[:, 0])
        y = resize(torch.cat(out), H, W, "bilinear")
        return torch.round(torch.clamp((y + MEAN) * 255.0, 0.0, 255.0))
