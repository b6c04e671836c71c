"""SuperSloMo weights: the reference's torch checkpoint, the converted npz,
seeded random weights, and the JAX package's parameter trees (port of
v2e_tpu/models/convert_ckpt.py).

Parameters travel as the JAX package's layout: nested dicts
``params[layer] = {"w": OIHW array, "b": array}`` of numpy arrays, which
`from_jax_params` turns into the port's UNet modules and `to_jax_params`
back.  The npz layout is ``flow/<layer>.weight`` etc., the original torch
checkpoint's state dicts; `save_slomo_npz` writes it as the JAX package's
training tool exports it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from v2e_tpu_torch.device import resolve_device
from v2e_tpu_torch.models.unet import UNet, unet_conv_specs

NpParams = Dict[str, Dict[str, np.ndarray]]

FLOW_IO = (2, 4)
INTERP_IO = (12, 5)


def _npz_to_params(npz, prefix: str) -> NpParams:
    params: NpParams = {}
    names = {k[len(prefix) + 1:].rsplit(".", 1)[0]
             for k in npz.files if k.startswith(prefix + "/")}
    for name in names:
        params[name] = {
            "w": np.asarray(npz[f"{prefix}/{name}.weight"], dtype=np.float32),
            "b": np.asarray(npz[f"{prefix}/{name}.bias"], dtype=np.float32),
        }
    return params


def load_slomo_params(path: str) -> Tuple[NpParams, NpParams]:
    """(flow, interp) parameter trees from a converted .npz checkpoint or
    the reference's torch .ckpt (state dicts ``state_dictFC`` and
    ``state_dictAT``), as f32 master copies whatever the stored dtype.  The
    .ckpt is read directly with torch.load; nothing is cached beside it."""
    if path.endswith(".npz"):
        npz = np.load(path)
        return _npz_to_params(npz, "flow"), _npz_to_params(npz, "interp")
    # the reference checkpoint pickles more than tensors (weights_only=False)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return tuple(
        _state_to_params(ckpt[key]) for key in ("state_dictFC", "state_dictAT")
    )


def convert_torch_checkpoint(ckpt_path: str, out_path: str) -> str:
    """Write the reference's torch checkpoint to an .npz of its two state
    dicts (``flow/<layer>.weight``, ``interp/<layer>.bias``, ...), the
    layout `load_slomo_params` and the JAX package read; returns
    `out_path`."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    out = {
        f"{prefix}/{k}": v.detach().cpu().numpy()
        for prefix, key in (("flow", "state_dictFC"), ("interp", "state_dictAT"))
        for k, v in ckpt[key].items()
    }
    np.savez(out_path, **out)
    return out_path


def _state_to_params(state) -> NpParams:
    names = {k.rsplit(".", 1)[0] for k in state}
    return {
        name: {
            "w": state[f"{name}.weight"].detach().to(torch.float32).numpy(),
            "b": state[f"{name}.bias"].detach().to(torch.float32).numpy(),
        }
        for name in names
    }


def init_random_slomo_params(seed: int = 0, base: int = 32) -> Tuple[NpParams, NpParams]:
    """Seeded random weights with torch Conv2d's +-1/sqrt(fan_in) uniform
    law, drawn with numpy (the same law as the JAX package's init; the
    numbers differ)."""
    rng = np.random.default_rng(seed)
    out = []
    for in_ch, out_ch in (FLOW_IO, INTERP_IO):
        params: NpParams = {}
        for name, ci, co, k in unet_conv_specs(in_ch, out_ch, base):
            bound = 1.0 / math.sqrt(ci * k * k)
            params[name] = {
                "w": rng.uniform(-bound, bound, (co, ci, k, k)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (co,)).astype(np.float32),
            }
        out.append(params)
    return out[0], out[1]


def _to_unet(params: NpParams, io: Tuple[int, int], device, dtype) -> UNet:
    base = int(np.asarray(params["conv1"]["w"]).shape[0])
    net = UNet(io[0], io[1], base)
    state = {}
    for name, ci, co, k in unet_conv_specs(io[0], io[1], base):
        w = np.asarray(params[name]["w"], dtype=np.float32)
        if w.shape != (co, ci, k, k):
            raise ValueError(f"{name}: weight shape {w.shape} != {(co, ci, k, k)}")
        state[f"{name}.weight"] = torch.from_numpy(w.copy())
        state[f"{name}.bias"] = torch.from_numpy(
            np.asarray(params[name]["b"], dtype=np.float32).copy()
        )
    net.load_state_dict(state)
    net = net.to(device=device)
    net.keep_float32_terms(dtype)
    # the conv weights channels_last (OHWI in memory), as the inference
    # path's NHWC convs read them
    net = net.to(dtype=dtype, memory_format=torch.channels_last)
    return net.eval().requires_grad_(False)


def from_jax_params(
    flow_np: NpParams,
    interp_np: NpParams,
    device: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[UNet, UNet]:
    """The port's (flow, interp) UNets from parameter trees in the JAX
    package's layout, for inference: in `dtype`, in eval mode, no
    parameter requiring grad, the conv weights channels_last; the width is
    read from conv1's shape."""
    dev = resolve_device(device)
    return _to_unet(flow_np, FLOW_IO, dev, dtype), _to_unet(interp_np, INTERP_IO, dev, dtype)


def to_jax_params(flow_net: UNet, interp_net: UNet) -> Tuple[NpParams, NpParams]:
    """The inverse of `from_jax_params`: (flow, interp) parameter trees of
    float32 numpy arrays, ``params[layer] = {"w": OIHW, "b": [Co]}``."""
    out = []
    for net in (flow_net, interp_net):
        params: NpParams = {}
        for name, *_ in unet_conv_specs(net.in_ch, net.out_ch, net.base):
            conv = net.get_submodule(name)
            params[name] = {
                "w": conv.weight.detach().to("cpu", torch.float32).numpy().copy(),
                "b": conv.bias.detach().to("cpu", torch.float32).numpy().copy(),
            }
        out.append(params)
    return out[0], out[1]


def save_slomo_npz(
    path: str, flow_np: NpParams, interp_np: NpParams, dtype: str = "float32"
) -> str:
    """Write parameter trees to a compressed .npz in `dtype` (float16 halves
    the file; `load_slomo_params` restores float32), the layout
    dataset_tools/train_slomo.py exports and --slomo_model reads in both
    packages; returns `path`."""
    dt = np.dtype(dtype)
    blobs = {}
    for prefix, tree in (("flow", flow_np), ("interp", interp_np)):
        for layer, wb in tree.items():
            blobs[f"{prefix}/{layer}.weight"] = np.asarray(wb["w"], dt)
            blobs[f"{prefix}/{layer}.bias"] = np.asarray(wb["b"], dt)
    np.savez_compressed(path, **blobs)
    return path
