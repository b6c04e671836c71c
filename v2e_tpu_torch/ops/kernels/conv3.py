"""K5: 3x3 stride-1 'same' convolution + bias + LeakyReLU on NHWC input,
accumulated in float32, with the bias and the activation applied in float32
and the result cast once to the input's type.

Replaces v2e_tpu/ops/pallas/conv3.py::conv3x3_lane.  `conv3x3_lane`
launches the CUDA kernel (csrc/conv3x3.cu) for CUDA tensors and runs
`conv3x3_lane_plain`, a float32 F.conv2d with the same epilogue, for CPU
tensors.

Design (see the source's note).  bf16, the main path: a persistent,
pipelined implicit GEMM for sm_90a (M = pixels, N = Co, K = 9*Ci).  One
block per SM holds the layer's packed weights (`pack_conv3_weights`) in
shared memory for the whole launch; its two warpgroups each walk their own
output tiles (8 rows x 16 or 32 columns) through their own cp.async ring,
which stages each tile with its halo, 32 (or 16) input channels at a time,
ahead of the wgmma m64nCoTk16 products (float32 accumulators in
registers; a tap's operand is the staged tile shifted, with no im2col
copy); the epilogue adds the float32 bias, applies the activation, casts
once, and stores 16-byte NHWC rows through stmatrix.  A layer whose
weights do not fit beside the rings streams them with each stage.  f32
(tests and the plain-precision UNet): float32 FMAs per 8x16 tile.  The
TPU kernel's tap rearrangements (hcol, zfull), made to fill its 128-lane
matrix unit, are not carried over.  At the UNet's up-tail shapes up4 is
bound by tensor-core operations and up5 by bytes.

The UNet's `packedz` form (models/unet.py) sends the k=3 layers with
32 <= Co <= 64 here, as the JAX package's `_conv_block3_lane` does.  The
TPU's VMEM limit on strip heights (`choose_th`) is the TPU's and is not
carried over: the kernel takes any H and W.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from v2e_tpu_torch import tracing
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


def conv3_pack_shape(ci: int, co: int, dtype: torch.dtype) -> Tuple[int, ...]:
    """The shape `pack_conv3_weights` gives Co x Ci 3x3 weights for x of
    `dtype`: bf16 [co_blocks, 9, CiP/8, CoT, 8] with CiP = Ci rounded up to
    16 and CoT = 32 for Co <= 32, else 64; float32 [9, CiP, Co rounded up to
    64]."""
    cip = _ceil(ci, 16)
    if dtype == torch.bfloat16:
        cot = 32 if _ceil(co, 8) <= 32 else 64
        return (-(-co // cot), 9, cip // 8, cot, 8)
    return (9, cip, _ceil(co, 64))


def pack_conv3_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW [Co,Ci,3,3] weights cast to `dtype` and laid out as K5 reads
    them, zero past Ci and Co (see `conv3_pack_shape`).  bf16: per block of
    CoT output channels, per tap ky*3+kx, per 8 input channels, the CoT
    rows of 8 consecutive input channels: the K-major core matrices the
    kernel's wgmma reads from shared memory.  float32: [tap][ci][co]."""
    co, ci = int(w.shape[0]), int(w.shape[1])
    shape = conv3_pack_shape(ci, co, dtype)
    wt = w.detach().to(dtype)
    if dtype == torch.bfloat16:
        cb, _, ci8, cot, _ = shape
        wp = wt.new_zeros((cb * cot, ci8 * 8, 3, 3))
        wp[:co, :ci] = wt
        # [cb, CoT, Ci/8, 8, ky, kx] -> [cb, ky, kx, Ci/8, CoT, 8]
        return (wp.reshape(cb, cot, ci8, 8, 3, 3).permute(0, 4, 5, 2, 1, 3)
                .reshape(shape).contiguous())
    w9 = wt.new_zeros(shape)
    w9[:, :ci, :co] = wt.permute(2, 3, 1, 0).reshape(9, ci, co)
    return w9


def conv3x3_lane(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    neg_slope: Optional[float] = 0.1,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5 wrapper: the kernel for CUDA tensors, the plain version for CPU.

    x: contiguous NHWC [N,H,W,Ci] in bfloat16 or float32; w: OIHW
    [Co,Ci,3,3] (cast to x's type); b: [Co] (used in float32).  neg_slope
    None skips the activation.  `packed`: w already laid out for the kernel
    by `pack_conv3_weights(w, x.dtype)` (the UNet caches it); without it
    the wrapper packs w on each call.  Returns [N,H,W,Co] in x's type.
    Every call counts by shape in tracing's `shape_counter(N, H, W, Ci,
    Co)`; kernel launches count in tracing's "launch.k5".
    """
    tracing.count(shape_counter(*x.shape, int(w.shape[0])))
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
    want = conv3_pack_shape(Ci, Co, x.dtype)
    if packed is None:
        packed = pack_conv3_weights(w, x.dtype)
    elif (tuple(packed.shape) != want or packed.dtype != x.dtype
          or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"packed: expected contiguous {x.dtype} {want} on {x.device}, got "
                         f"{packed.dtype} {tuple(packed.shape)} on {packed.device}")
    bf = b.to(torch.float32).contiguous()
    is_bf16 = x.dtype == torch.bfloat16
    ci_k, co_k = Ci, Co
    if is_bf16:
        # the kernel copies 16 bytes (8 channels) at a time and stores
        # 8 output channels at a time: pad Ci and Co to multiples of 8 and
        # give it a 16-byte aligned input
        ci_k, co_k = _ceil(Ci, 8), _ceil(Co, 8)
        if ci_k != Ci or x.data_ptr() % 16:
            xk = x.new_zeros((N, H, W, ci_k))
            xk[..., :Ci] = x
            x = xk
        if co_k != Co:
            bf = torch.cat([bf, bf.new_zeros(co_k - Co)])
        cip, cop = want[2] * 8, want[0] * want[3]
    else:
        if N * _ceil(Co, 64) // 64 > 65535:
            raise ValueError(f"batch {N} x {Co} channels exceeds the launch grid")
        cip, cop = want[1], want[2]
    y = torch.empty((N, H, W, co_k), dtype=x.dtype, device=x.device)
    build.call("v2e_conv3x3", x.device, x, packed, bf, y, N, H, W, ci_k, co_k, cip, cop,
               0.0 if neg_slope is None else float(neg_slope), int(neg_slope is not None),
               int(is_bf16), 1, counter="launch.k5")
    return y if co_k == Co else y[..., :Co].contiguous()

SHAPE_COUNTER = "shape.k5."


def shape_counter(n: int, h: int, w: int, ci: int, co: int) -> str:
    """The counter of `conv3x3_lane`'s calls at one shape."""
    return f"{SHAPE_COUNTER}{n}x{h}x{w}x{ci}.{co}"


def shape_counts(counters: dict) -> dict:
    """{((N,H,W,Ci), Co): calls} from tracing's counters."""
    out = {}
    for name, n in counters.items():
        if name.startswith(SHAPE_COUNTER):
            xs, co = name[len(SHAPE_COUNTER):].split(".")
            out[(tuple(int(v) for v in xs.split("x")), int(co))] = n
    return out
