"""The benchmark's yardstick: the card's published peaks, the bytes each
kernel has to move and the FLOPs SuperSloMo's UNets have to compute.

Everything here is computed from shapes, never read from the program, so a
change to the program cannot move the yardstick.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
700 W power limit (a card set lower runs slower; the run prints the limit
beside every share).

Kernel bytes count each input byte read once and each output byte written
once (chip_smoke.py's counts):
* K1, the refractory scan: per pixel-frame the lowpassed log intensity
  (f32), the leak delta (f32, when leak is on), the shot mask (u8, when
  shot noise is on) in, the signed count and first iteration (i16 each)
  out; per pixel six f32/i32 planes of state in and out; per frame 12 B of
  times and K.
* K2, the refractory-free scan: per pixel-frame the log intensity (f32),
  with noise the leak delta (f32) and shot mask (u8), and the count (i16);
  per pixel the base and thresholds in and the base out (4 f32 planes).
* K3, the bilinear backwarp: per plane pixel the image, u and v in and the
  output out (4 x f32).  A SuperSloMo chunk needs two warp passes (before
  and after the refinement UNet), each warping I0 and I1, for each of the
  U intermediate times of each of the B pairs.

UNet FLOPs: 2 x Ci x Co x k x k per output pixel of each convolution, in
the layer list of Super-SloMo (Jiang et al., CVPR 2018, arXiv:1711.00080;
the public PyTorch code's UNet): conv1 and conv2 7x7 at full resolution,
five down levels (2x2 average pool, two convs: 5x5 on the first, 3x3 on
the rest), five up levels (bilinear x2, a 3x3 conv, the skip concatenated,
a 3x3 conv), and a 3x3 conv out.  Pooling, upsampling and activations are
not counted.  A backward pass counts twice the forward (the gradients of
the inputs and of the weights).
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12  # HBM3
PEAK_BF16_FLOP_S = 989e12  # dense bf16 tensor cores
PEAK_TF32_FLOP_S = 495e12  # dense TF32 tensor cores
PEAK_F32_OPS_S = 67e12  # float32 outside the tensor cores


def bound_s(nbytes: float, nops: float = 0.0, peak_ops: float = PEAK_F32_OPS_S) -> float:
    """The least time the card could take: the larger of bytes over the
    memory peak and operations over the compute peak."""
    return max(nbytes / PEAK_BYTES_S, nops / peak_ops)


def k1_bytes(frames: int, h: int, w: int, leak: bool = True, shot: bool = True) -> int:
    """Bytes K1 moves for one chunk of `frames` frames of h x w."""
    npix = h * w
    per_pf = 4 + (4 if leak else 0) + (1 if shot else 0) + 2 + 2
    return frames * npix * per_pf + npix * (4 * 4 + 2 * 4) + frames * 12


def k2_bytes(frames: int, h: int, w: int, noisy: bool = True) -> int:
    """Bytes K2 moves for one chunk of `frames` frames of h x w."""
    npix = h * w
    return frames * npix * (4 + (4 + 1 if noisy else 0) + 2) + npix * 4 * 4


def k3_bytes(planes: int, h: int, w: int) -> int:
    """Bytes K3 moves warping `planes` single-channel planes of h x w."""
    return planes * h * w * 16


def slomo_warp_planes(pairs: int, upsampling: int) -> int:
    """Planes a SuperSloMo chunk has to warp: 2 passes x (I0, I1) x U x B."""
    return 4 * upsampling * pairs


def snap32(x: int) -> int:
    """The UNets' input size along one axis: the frame size rounded down to
    a multiple of 32 (the five 2x poolings), at least 32."""
    return max(32, (x // 32) * 32)


def unet_layers(in_ch: int, out_ch: int, base: int = 32):
    """(name, Ci, Co, k, level) of each convolution; `level` is the power
    of two the layer's resolution is divided by."""
    b = base
    layers = [("conv1", in_ch, b, 7, 0), ("conv2", b, b, 7, 0)]
    down = [(b, 2 * b, 5), (2 * b, 4 * b, 3), (4 * b, 8 * b, 3),
            (8 * b, 16 * b, 3), (16 * b, 16 * b, 3)]
    for i, (ci, co, k) in enumerate(down, 1):
        layers += [(f"down{i}.conv1", ci, co, k, i), (f"down{i}.conv2", co, co, k, i)]
    up = [(16 * b, 16 * b), (16 * b, 8 * b), (8 * b, 4 * b), (4 * b, 2 * b), (2 * b, b)]
    for i, (ci, co) in enumerate(up, 1):
        level = 5 - i
        layers += [(f"up{i}.conv1", ci, co, 3, level), (f"up{i}.conv2", 2 * co, co, 3, level)]
    layers.append(("conv3", b, out_ch, 3, 0))
    return layers


def unet_forward_flops(in_ch: int, out_ch: int, h: int, w: int, base: int = 32) -> int:
    """FLOPs of one UNet forward on one h x w image (h, w multiples of 32)."""
    total = 0
    for _, ci, co, k, level in unet_layers(in_ch, out_ch, base):
        total += 2 * ci * co * k * k * (h >> level) * (w >> level)
    return total


FLOW_IO = (2, 4)  # the flow UNet: I0, I1 in; F01, F10 out
INTERP_IO = (12, 5)  # the refinement UNet: 12 planes in; 2 flows and V out


def slomo_chunk_flops(pairs: int, upsampling: int, h: int, w: int, base: int = 32) -> int:
    """FLOPs of the UNets for one conversion chunk: the flow UNet once per
    pair and the refinement UNet once per pair and intermediate time."""
    return (pairs * unet_forward_flops(*FLOW_IO, h, w, base)
            + pairs * upsampling * unet_forward_flops(*INTERP_IO, h, w, base))


def slomo_train_step_flops(batch: int, h: int, w: int, base: int = 32) -> int:
    """FLOPs of one training step's UNets: each UNet forward once per
    sample, and its backward at twice the forward."""
    fwd = unet_forward_flops(*FLOW_IO, h, w, base) + unet_forward_flops(*INTERP_IO, h, w, base)
    return 3 * batch * fwd
