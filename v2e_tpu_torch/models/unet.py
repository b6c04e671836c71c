"""SuperSloMo UNet as an `nn.Module` (port of v2e_tpu/models/unet.py).

  conv1 7x7 (in->b), conv2 7x7 (b->b)                        -> skip s1
  down{1..5}: avgpool2 + conv(k) + conv(k), k = 5,3,3,3,3     (b -> 16b)
  up{1..5}:   bilinear x2 + conv3 + concat(skip) + conv3     (16b -> b)
  conv3 3x3 (b->out), LeakyReLU(0.1) after every conv

with b = `base` (32 = the original SuperSloMo).  Submodule names follow the
original torch model, so its state-dict keys ('down1.conv1.weight', ...)
load unchanged.

Conv forms: the CLI's --unet_conv takes ten names, and `UNET_CONV` maps
each to one of the four forms the port runs (`UNetForm`):
* DENSE (dense, auto, and the TPU layouts packed, packedup and blocked,
  column packings that fill the TPU's 128 lanes): every conv is F.conv2d
  + LeakyReLU, in the module's dtype.
* PACKEDZ (packedz): the k=3 layers with 32 <= Co <= 64 of the up path
  and conv3 run through K5 (ops/kernels/conv3.py), whose bias and
  activation are applied in float32 and rounded once; every other layer is
  dense.  At base 32 that is up4 and up5, at base 8 up2 and up3.
* FOLD (fold, packedfold) and FOLD45 (fold45, packedfold45): each bilinear
  x2 upsample and the up level's conv1 after it become one half-resolution
  conv with the four output phases on the channel axis (`upconv_fold`), on
  every up level or on up4 and up5; every other layer is dense.
The fold is plain F.conv2d, as the JAX package left it to XLA.  Every
other up level's bilinear x2 is K6 (ops/kernels/upsample.py), its VJP in
training.

Two paths, chosen per call by what autograd would record (`forward`), over
one walk of the network (`_walk`), which differ only in the conv step, the
pooling and the layout:
* inference (grad mode off, or neither the input nor a parameter
  requiring grad, as conversion's frozen modules from
  convert_ckpt.from_jax_params, whose conv weights are channels_last):
  channels_last from input to output, so cuDNN's NHWC kernels transpose
  nothing.  Each dense conv runs bias-free, and K8
  (ops/kernels/conv_epilogue.py) adds the float32 bias, applies
  LeakyReLU and rounds once, in one pass; at each up level's conv1 it
  also copies the skip into the channels after its own, in place of
  torch.cat, and conv2 reads that buffer (`_fused`).  The pooling is a
  mean over the NHWC view's window axes (`avg_pool2_nhwc`), K6 runs
  channels_last, K5 keeps its own epilogue and the fold its NCHW form,
  its layout changed once at each side.  K8 has no VJP.
* autograd (training): NCHW nn.Conv2d with its bias, F.leaky_relu and
  torch.cat (`_act`), and F.avg_pool2d.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, FrozenSet, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from v2e_tpu_torch.ops.kernels.conv3 import (
    LANE3_MAX_CO, LANE3_MIN_CO, conv3x3_lane, pack_conv3_weights,
)
from v2e_tpu_torch.ops.kernels.conv_epilogue import conv_bias_leaky
from v2e_tpu_torch.ops.kernels.upsample import Upsample2xFn, upsample2x_along


@dataclass(frozen=True)
class UNetForm:
    """A conv form the port runs: whether K5 takes the up tail (`lane`),
    and which up levels fold their upsample into conv1 (`fold`)."""

    lane: bool = False
    fold: FrozenSet[int] = frozenset()


DENSE = UNetForm()
PACKEDZ = UNetForm(lane=True)
FOLD = UNetForm(fold=frozenset(range(1, 6)))
FOLD45 = UNetForm(fold=frozenset((4, 5)))

_TPU_LAYOUT = "a TPU layout of the dense UNet; the port runs the dense form"
_FOLDS = "the upsample and conv1 of {} run as one folded half-res conv, the others dense"
# each --unet_conv name: (the form the port runs, what args.log_layout_flags
# says of it; nothing for the two names that say dense themselves).  "auto"
# runs dense, as the JAX package's auto does off its TPU.
UNET_CONV: Dict[str, Tuple[UNetForm, str]] = {
    "auto": (DENSE, ""),
    "dense": (DENSE, ""),
    "packed": (DENSE, _TPU_LAYOUT),
    "packedup": (DENSE, _TPU_LAYOUT),
    "blocked": (DENSE, _TPU_LAYOUT),
    "packedz": (PACKEDZ, "the k=3 up-tail layers with 32-64 output channels run "
                         "through the K5 conv kernel, the others dense"),
    "fold": (FOLD, _FOLDS.format("up1, up2, up3, up4, up5")),
    "packedfold": (FOLD, _FOLDS.format("up1, up2, up3, up4, up5")),
    "fold45": (FOLD45, _FOLDS.format("up4, up5")),
    "packedfold45": (FOLD45, _FOLDS.format("up4, up5")),
}


def unet_form(form: Union[str, UNetForm]) -> UNetForm:
    """The form a --unet_conv name runs (a form is returned as it is);
    raises on an unknown name."""
    if isinstance(form, UNetForm):
        return form
    if form not in UNET_CONV:
        raise ValueError(f"unknown conv form {form!r}; one of {tuple(UNET_CONV)}")
    return UNET_CONV[form][0]


def unet_conv_specs(
    in_ch: int, out_ch: int, base: int = 32
) -> Sequence[Tuple[str, int, int, int]]:
    """(layer name, in_ch, out_ch, kernel) of each conv in definition order."""
    b = base
    specs = [("conv1", in_ch, b, 7), ("conv2", b, b, 7)]
    down_cfg = [(b, 2 * b, 5), (2 * b, 4 * b, 3), (4 * b, 8 * b, 3),
                (8 * b, 16 * b, 3), (16 * b, 16 * b, 3)]
    for i, (ci, co, k) in enumerate(down_cfg, 1):
        specs.append((f"down{i}.conv1", ci, co, k))
        specs.append((f"down{i}.conv2", co, co, k))
    up_cfg = [(16 * b, 16 * b), (16 * b, 8 * b), (8 * b, 4 * b),
              (4 * b, 2 * b), (2 * b, b)]
    for i, (ci, co) in enumerate(up_cfg, 1):
        specs.append((f"up{i}.conv1", ci, co, 3))
        specs.append((f"up{i}.conv2", 2 * co, co, 3))
    specs.append(("conv3", b, out_ch, 3))
    return specs


def lane3_eligible(conv: nn.Conv2d) -> bool:
    """Whether the packedz form sends this layer to K5: k = 3 and
    32 <= Co <= 64 (v2e_tpu/models/unet.py:_conv_block3_lane)."""
    return conv.kernel_size == (3, 3) and LANE3_MIN_CO <= conv.out_channels <= LANE3_MAX_CO


# _UPFOLD_A[r][i][d]: coefficient of half-res tap x[h+i-1] contributed by
# the dense kernel's tap d at full-res row parity r, from
#   up[2h] = 0.25 x[h-1] + 0.75 x[h],  up[2h+1] = 0.75 x[h] + 0.25 x[h+1]
_UPFOLD_A = (
    ((0.75, 0.25, 0.0), (0.25, 0.75, 0.75), (0.0, 0.0, 0.25)),  # r = 0
    ((0.25, 0.0, 0.0), (0.75, 0.75, 0.25), (0.0, 0.25, 0.75)),  # r = 1
)


def upfold_kernel(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Co,Ci,3,3] -> the folded half-res OIHW kernel [4*Co,Ci,3,3] in
    float32; output channels in (r, c, co) order, (r, c) the full-res row
    and column parity."""
    a = torch.tensor(_UPFOLD_A, dtype=torch.float32, device=w.device)
    wf = torch.einsum("rad,sbe,oide->rsoiab", a, a, w.to(torch.float32))
    return wf.reshape(4 * w.shape[0], w.shape[1], 3, 3)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 (F.interpolate's, align_corners=False) in x's layout:
    K6 with its VJP on the card, its plain version on the CPU."""
    return Upsample2xFn.apply(x)


def upconv_fold(x: torch.Tensor, conv: nn.Conv2d, wf: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(conv(bilinear x2 of x)) as one half-res conv (k = 3).

    x: [N,Ci,Hh,Wh] half-res; wf: `upfold_kernel(conv.weight)` in x's
    dtype.  Returns [N,Co,2Hh,2Wh].  The bilinear clamps at the half-res
    border, which edge padding of x reproduces (its tap weights sum to 1);
    the conv zero-pads beyond the full-res image.  So the folded conv over
    the edge-padded input over-counts exactly the conv taps that fall
    outside the image, in a one-pixel output ring; those are subtracted
    with 1-D convs along the border rows and columns, and the corner taps,
    subtracted twice, added back (v2e_tpu/models/unet.py:_upconv_fold_block).
    """
    w, b = conv.weight, conv.bias
    n, ci, hh, wh = x.shape
    co = w.shape[0]
    z = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), wf)
    z = z.reshape(n, 2, 2, co, hh, wh)  # [N, r, c, Co, Hh, Wh]

    def row_corr(row, wrow):
        # the out-of-range full-res row equals the border row upsampled in
        # W; its own out-of-range columns equal its corner pixels
        up = upsample2x_along(row, 3)
        c = F.conv2d(F.pad(up, (1, 1, 0, 0), mode="replicate"), wrow[:, :, None, :])
        return c.reshape(n, co, wh, 2).permute(0, 3, 1, 2)  # [N, c, Co, Wh]

    def col_corr(col, wcol):
        up = upsample2x_along(col, 2)
        c = F.conv2d(F.pad(up, (0, 0, 1, 1), mode="replicate"), wcol[:, :, :, None])
        return c.reshape(n, co, hh, 2).permute(0, 3, 1, 2)  # [N, r, Co, Hh]

    # full-res row 0 is parity r=0 at h=0; row 2Hh-1 is r=1 at h=Hh-1
    z[:, 0, :, :, 0, :] -= row_corr(x[:, :, :1], w[:, :, 0, :])
    z[:, 1, :, :, -1, :] -= row_corr(x[:, :, -1:], w[:, :, 2, :])
    z[:, :, 0, :, :, 0] -= col_corr(x[:, :, :, :1], w[:, :, :, 0])
    z[:, :, 1, :, :, -1] -= col_corr(x[:, :, :, -1:], w[:, :, :, 2])
    for hi, wi, r, c, dy, dx in ((0, 0, 0, 0, 0, 0), (0, -1, 0, 1, 0, 2),
                                 (-1, 0, 1, 0, 2, 0), (-1, -1, 1, 1, 2, 2)):
        z[:, r, c, :, hi, wi] += x[:, :, hi, wi] @ w[:, :, dy, dx].t()
    z = F.leaky_relu(z + b[None, None, None, :, None, None], 0.1)
    return z.permute(0, 3, 4, 1, 5, 2).reshape(n, co, 2 * hh, 2 * wh)


def avg_pool2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling of a channels_last [N,C,H,W] (H, W even), as
    F.avg_pool2d computes it, the window's mean accumulated in float32 and
    rounded once, but as a reduction over the NHWC view's window axes: on
    the card ATen's NHWC pooling kernel takes 3.3x as long.  Returns a
    channels_last [N,C,H/2,W/2]."""
    n, c, h, w = x.shape
    v = x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
    return v.mean((2, 4)).permute(0, 3, 1, 2)


class UNet(nn.Module):
    """The SuperSloMo UNet on NCHW tensors (H, W multiples of 32)."""

    def __init__(self, in_ch: int, out_ch: int, base: int = 32):
        super().__init__()
        self.in_ch, self.out_ch, self.base = in_ch, out_ch, base
        for name, ci, co, k in unet_conv_specs(in_ch, out_ch, base):
            parent = self
            *path, leaf = name.split(".")
            for p in path:
                if not hasattr(parent, p):
                    parent.add_module(p, nn.Module())
                parent = getattr(parent, p)
            parent.add_module(leaf, nn.Conv2d(ci, co, k, padding=(k - 1) // 2))
        self.keep_float32_terms(torch.float32)

    def lane_convs(self) -> Sequence[Tuple[str, nn.Conv2d]]:
        """(name, conv) of the layers the packedz form sends to K5: the up
        levels' convs and conv3 that `lane3_eligible` names."""
        names = [f"up{i}.conv{j}" for i in range(1, 6) for j in (1, 2)] + ["conv3"]
        convs = [(n, self.get_submodule(n)) for n in names]
        return [(n, c) for n, c in convs if lane3_eligible(c)]

    def keep_float32_terms(self, dtype: torch.dtype) -> None:
        """Record, from the current weights, what K5 and the fold take from
        the float32 masters: each conv's float32 bias (`bias_f32`), each up
        level's folded conv1 kernel, folded in float32 and cast once to
        `dtype` (`fold_weight`), as the JAX package does with its float32
        parameters, and for each layer of `lane_convs` its weights packed
        for K5 in `dtype` (`packed_w`), so that no forward packs them again.
        Call on the module's device, before casting it to `dtype`
        (convert_ckpt does)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.bias_f32 = m.bias.detach().to(torch.float32).clone()
                m.packed_w = None
        for _, conv in self.lane_convs():
            conv.packed_w = pack_conv3_weights(conv.weight, dtype)
        for i in range(1, 6):
            blk = getattr(self, f"up{i}")
            blk.fold_weight = upfold_kernel(blk.conv1.weight.detach()).to(dtype)

    @staticmethod
    def _lane(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """K5 on a layer `lane3_eligible` names.  K5 takes NHWC: a
        channels_last tensor's permute is that with no copy; any other input
        is copied once."""
        xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return conv3x3_lane(xh, conv.weight, conv.bias_f32, 0.1,
                            packed=conv.packed_w).permute(0, 3, 1, 2)

    @staticmethod
    def _act(conv: nn.Conv2d, x: torch.Tensor,
             skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Training's step: nn.Conv2d with its bias, LeakyReLU, and the
        skip concatenated after it, each differentiable."""
        y = F.leaky_relu(conv(x), 0.1)
        return y if skip is None else torch.cat([y, skip], dim=1)

    @staticmethod
    def _fused(conv: nn.Conv2d, x: torch.Tensor,
               skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inference's step: the bias-free conv of channels_last x, then K8:
        bias, LeakyReLU and the skip beside it, channels_last.  cuDNN
        returns channels_last for channels_last input and weights; the CPU's
        slow conv (small batches, 3x3) may not, and is copied once."""
        y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding)
        return conv_bias_leaky(y.contiguous(memory_format=torch.channels_last),
                               conv.bias_f32, skip)

    def _records_grad(self, x: torch.Tensor) -> bool:
        """Whether autograd would record this forward: grad mode on, and x
        or a parameter requiring grad."""
        return torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))

    def forward(self, x: torch.Tensor, form: UNetForm = DENSE) -> torch.Tensor:
        """The UNet of x [N,in_ch,H,W] in `form`, on the path that
        `_records_grad` picks (`_path`); the inference path returns a
        channels_last tensor."""
        return self._walk(x, form, *self._path(self._records_grad(x)))

    def _path(self, autograd: bool):
        """(block, pool, layout) of `_walk`: training's differentiable step
        (`_act`), F.avg_pool2d and NCHW, or inference's K8 step (`_fused`),
        `avg_pool2_nhwc` and channels_last."""
        if autograd:
            return self._act, partial(F.avg_pool2d, kernel_size=2), torch.contiguous_format
        return self._fused, avg_pool2_nhwc, torch.channels_last

    def _walk(self, x: torch.Tensor, form: UNetForm, block, pool,
              layout: torch.memory_format) -> torch.Tensor:
        """The network in `form`, x and every activation in `layout`.
        `block(conv, x, skip=None)` is one dense conv with its bias and
        LeakyReLU, the skip (if any) concatenated after it; `pool` the 2x2
        average pooling.  K5's layers keep their own epilogue, and the fold
        its NCHW form, its output laid out once in `layout`."""

        def cb3(conv, x, skip=None):
            if not (form.lane and lane3_eligible(conv)):
                return block(conv, x, skip)
            y = self._lane(conv, x)
            return y if skip is None else torch.cat([y, skip], dim=1)

        x = block(self.conv1, x.contiguous(memory_format=layout))
        s1 = block(self.conv2, x)
        skips = [s1]
        x = s1
        for i in range(1, 6):
            blk = getattr(self, f"down{i}")
            x = pool(x)
            x = block(blk.conv1, x)
            x = block(blk.conv2, x)
            if i < 5:
                skips.append(x)
        for i in range(1, 6):
            blk = getattr(self, f"up{i}")
            skip = skips[5 - i]
            if i in form.fold:
                x = upconv_fold(x.contiguous(), blk.conv1, blk.fold_weight)
                x = torch.cat([x.contiguous(memory_format=layout), skip], dim=1)
            else:
                x = cb3(blk.conv1, _upsample2(x), skip)
            x = cb3(blk.conv2, x)
        return cb3(self.conv3, x)


def unet_apply(net: UNet, x: torch.Tensor, form: Union[str, UNetForm] = DENSE) -> torch.Tensor:
    """Forward pass on NCHW input [N, in_ch, H, W], computed in the
    module's dtype (e.g. bfloat16) in `form` (a `UNetForm` or a --unet_conv
    name), and returned in x's dtype."""
    dtype = next(net.parameters()).dtype
    return net(x.to(dtype), unet_form(form)).to(x.dtype)


def unet_apply_io_nhwc(net: UNet, x: torch.Tensor,
                       form: Union[str, UNetForm] = DENSE) -> torch.Tensor:
    """`unet_apply` on NHWC input [N, H, W, in_ch], returning NHWC."""
    return unet_apply(net, x.permute(0, 3, 1, 2), form).permute(0, 2, 3, 1)
