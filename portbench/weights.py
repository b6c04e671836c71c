"""SuperSloMo weights made from the run's seed, on the device, in the type
they are served in: one uniform draw for all layers of both UNets from a
torch.Generator on the device, each layer's weights scaled to He et al.'s
uniform law for LeakyReLU(0.1) (+-sqrt(6 / (1.01 fan_in)), torch's
kaiming_uniform_ with a = 0.1) and its biases to +-1/sqrt(fan_in).  The He
law keeps the activations' scale through the UNets' 23 layers, as a
trained network keeps it, so the flows and the visibility map move the
interpolated frames; torch Conv2d's default law (+-1/sqrt(fan_in)) shrinks
them about 1.7x a layer and leaves every frame near a blend of its pair.
The program loads the weights from a checkpoint file in the public code's
layout (state_dictFC, state_dictAT); the reference takes the same
tensors."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.yardstick import FLOW_IO, INTERP_IO, unet_layers

Weights = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _shapes(io, base):
    return [(name, (co, ci, k, k)) for name, ci, co, k, _ in unet_layers(*io, base)]


def make_slomo_weights(seed: int, base: int, device, dtype: torch.dtype) -> Tuple[Weights, Weights]:
    """(flow, interp) weights: {layer: (w OIHW, b)} in `dtype` on `device`."""
    shapes = [_shapes(FLOW_IO, base), _shapes(INTERP_IO, base)]
    total = sum(co * ci * k * kk + co for s in shapes for _, (co, ci, k, kk) in s)
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.rand(total, generator=g, device=device, dtype=torch.float32).mul_(2).sub_(1)
    out, o = [], 0
    for s in shapes:
        layers = {}
        for name, (co, ci, k, _) in s:
            fan_in = ci * k * k
            nw = co * ci * k * k
            w = (flat[o:o + nw] * math.sqrt(6.0 / (1.01 * fan_in))).to(dtype).view(co, ci, k, k)
            b = (flat[o + nw:o + nw + co] / math.sqrt(fan_in)).to(dtype)
            layers[name] = (w, b)
            o += nw + co
        out.append(layers)
    return out[0], out[1]


def state_dict(weights: Weights) -> Dict[str, torch.Tensor]:
    """`weights` as a torch state dict on the host ('down1.conv1.weight',
    ...)."""
    sd = {}
    for name, (w, b) in weights.items():
        sd[f"{name}.weight"] = w.detach().cpu()
        sd[f"{name}.bias"] = b.detach().cpu()
    return sd


def save_checkpoint(path: str, flow: Weights, interp: Weights) -> str:
    """Write the public Super-SloMo checkpoint layout that --slomo_model
    reads."""
    torch.save({"state_dictFC": state_dict(flow), "state_dictAT": state_dict(interp)}, path)
    return path


def numpy_trees(flow: Weights, interp: Weights):
    """(flow, interp) as {layer: {"w": array, "b": array}} of float32
    numpy arrays, the layout `create_train_state(params=...)` takes."""
    def tree(ws):
        return {n: {"w": w.detach().float().cpu().numpy(), "b": b.detach().float().cpu().numpy()}
                for n, (w, b) in ws.items()}
    return tree(flow), tree(interp)
