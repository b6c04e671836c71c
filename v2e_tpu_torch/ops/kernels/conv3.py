"""K5: 3x3 stride-1 'same' convolution + bias + LeakyReLU on NHWC input,
accumulated in float32, with the bias and the activation applied in float32
and the result cast once to the input's type.

Replaces v2e_tpu/ops/pallas/conv3.py::conv3x3_lane.  `conv3x3_lane`
launches the CUDA kernel (csrc/conv3x3.cu) for CUDA tensors and runs
`conv3x3_lane_plain`, a float32 F.conv2d with the same epilogue, for CPU
tensors.

Design (see the source's note): an implicit GEMM (M = N*H*W pixels, N =
Co, K = 9*Ci); one block per 8x16 output tile and 64 output channels
stages its input tile with a one-pixel halo and one Ci slice of the weights
in shared memory; bf16 runs WMMA 16x16x16 tensor-core products with
float32 accumulation, f32 runs float32 FMAs.  The TPU kernel's tap
rearrangements (hcol, zfull), made to fill its 128-lane matrix unit, are
not carried over.  At the UNet's up-tail shapes the kernel is bound by
bytes and tensor-core FLOPs about equally.

The UNet's `packedz` form (models/unet.py) sends the k=3 layers with
32 <= Co <= 64 here, as the JAX package's `_conv_block3_lane` does.  The
TPU's VMEM limit on strip heights (`choose_th`) is the TPU's and is not
carried over: the kernel takes any H and W.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from v2e_tpu_torch.ops.kernels import build

# output widths the UNet sends to K5 (v2e_tpu/models/unet.py:_LANE3_MAX_CO
# and v2e_tpu/ops/pallas/conv3.py:_MIN_CO)
LANE3_MIN_CO = 32
LANE3_MAX_CO = 64


def conv3x3_lane_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, neg_slope: Optional[float] = 0.1
) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: the weights cast to x's
    type, a float32 convolution, the float32 bias, max(y, slope*y) in
    float32 (none when neg_slope is None), one cast to x's type.

    x: NHWC [N,H,W,Ci]; w: OIHW [Co,Ci,3,3]; b: [Co].  Returns [N,H,W,Co].
    """
    f32 = torch.float32
    wf = w.to(x.dtype).to(f32)
    y = F.conv2d(x.to(f32).permute(0, 3, 1, 2), wf, padding=1)
    y = y + b.to(f32)[None, :, None, None]
    if neg_slope is not None:
        y = torch.maximum(y, y * neg_slope)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


def conv3x3_lane(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, neg_slope: Optional[float] = 0.1
) -> torch.Tensor:
    """K5 wrapper: the kernel for CUDA tensors, the plain version for CPU.

    x: contiguous NHWC [N,H,W,Ci] in bfloat16 or float32; w: OIHW
    [Co,Ci,3,3] (cast to x's type); b: [Co] (used in float32).  neg_slope
    None skips the activation.  Returns [N,H,W,Co] in x's type.  Every call
    is recorded in `conv3x3_lane.last_call` and counted by shape in
    `conv3x3_lane.shapes`, ((N,H,W,Ci), Co); `launches` counts kernel
    launches.
    """
    shape = (tuple(x.shape), int(w.shape[0]))
    conv3x3_lane.last_call = shape
    conv3x3_lane.shapes[shape] = conv3x3_lane.shapes.get(shape, 0) + 1
    if not x.is_cuda:
        return conv3x3_lane_plain(x, w, b, neg_slope)
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: expected NHWC bfloat16 or float32, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    N, H, W, Ci = x.shape
    Co = int(w.shape[0])
    if tuple(w.shape) != (Co, Ci, 3, 3) or w.device != x.device:
        raise ValueError(f"w: expected [Co,{Ci},3,3] on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if tuple(b.shape) != (Co,) or b.device != x.device:
        raise ValueError(f"b: expected [{Co}] on {x.device}, got {tuple(b.shape)} on {b.device}")
    if N * _ceil(Co, 64) // 64 > 65535:
        raise ValueError(f"batch {N} x {Co} channels exceeds the launch grid")
    CiP, CoP = _ceil(Ci, 16), _ceil(Co, 64)
    w9 = torch.zeros((9, CiP, CoP), dtype=x.dtype, device=x.device)
    w9[:, :Ci, :Co] = w.to(x.dtype).permute(2, 3, 1, 0).reshape(9, Ci, Co)
    bf = b.to(torch.float32).contiguous()
    y = torch.empty((N, H, W, Co), dtype=x.dtype, device=x.device)
    vec = int(Ci % 8 == 0 and x.data_ptr() % 16 == 0)
    fn = build.load("conv3x3").v2e_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w9.data_ptr()),
            ctypes.c_void_p(bf.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            N, H, W, Ci, Co, CiP, CoP,
            0.0 if neg_slope is None else float(neg_slope), int(neg_slope is not None),
            int(x.dtype == torch.bfloat16), vec, ctypes.c_void_p(stream),
        )
    build.check(err, "conv3x3_lane")
    conv3x3_lane.launches += 1
    return y


# kernel launches made by `conv3x3_lane`; the last call's and every call's
# ((N,H,W,Ci), Co)
conv3x3_lane.launches = 0
conv3x3_lane.last_call = None
conv3x3_lane.shapes = {}
