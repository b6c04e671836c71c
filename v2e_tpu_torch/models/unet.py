"""SuperSloMo UNet as an `nn.Module` (port of v2e_tpu/models/unet.py, dense
form).

  conv1 7x7 (in->b), conv2 7x7 (b->b)                        -> skip s1
  down{1..5}: avgpool2 + conv(k) + conv(k), k = 5,3,3,3,3     (b -> 16b)
  up{1..5}:   bilinear x2 + conv3 + concat(skip) + conv3     (16b -> b)
  conv3 3x3 (b->out), LeakyReLU(0.1) after every conv

with b = `base` (32 = the original SuperSloMo).  Submodule names follow the
original torch model, so its state-dict keys ('down1.conv1.weight', ...)
load unchanged.  The JAX package's packed, blocked and fold forms are TPU
layouts of this same function and are not ported; the convolutions are
F.conv2d, as they were plain XLA convolutions there.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


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

    @staticmethod
    def _act(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(conv(x), 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self._act
        x = a(self.conv1, x)
        s1 = a(self.conv2, x)
        skips = [s1]
        x = s1
        for i in range(1, 6):
            blk = getattr(self, f"down{i}")
            x = F.avg_pool2d(x, 2)
            x = a(blk.conv1, x)
            x = a(blk.conv2, x)
            if i < 5:
                skips.append(x)
        for i in range(1, 6):
            blk = getattr(self, f"up{i}")
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
            x = a(blk.conv1, x)
            x = a(blk.conv2, torch.cat([x, skips[5 - i]], dim=1))
        return a(self.conv3, x)


def unet_apply(net: UNet, x: torch.Tensor) -> torch.Tensor:
    """Forward pass on NCHW input [N, in_ch, H, W], computed in the
    module's dtype (e.g. bfloat16) and returned in x's dtype."""
    dtype = next(net.parameters()).dtype
    return net(x.to(dtype)).to(x.dtype)


def unet_apply_io_nhwc(net: UNet, x: torch.Tensor) -> torch.Tensor:
    """`unet_apply` on NHWC input [N, H, W, in_ch], returning NHWC."""
    return unet_apply(net, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
