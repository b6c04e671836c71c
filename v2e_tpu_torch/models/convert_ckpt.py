"""SuperSloMo weights: the npz checkpoint, seeded random weights, and the
JAX package's parameter trees (port of v2e_tpu/models/convert_ckpt.py).

Parameters travel as the JAX package's layout: nested dicts
``params[layer] = {"w": OIHW array, "b": array}`` of numpy arrays, which
`from_jax_params` turns into the port's UNet modules.  The npz layout is
``flow/<layer>.weight`` etc., the original torch checkpoint's state dicts.
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
    """(flow, interp) parameter trees from a converted .npz checkpoint
    (f32 master copies, whatever the stored dtype)."""
    npz = np.load(path)
    return _npz_to_params(npz, "flow"), _npz_to_params(npz, "interp")


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
    return net.to(device=device, dtype=dtype).eval().requires_grad_(False)


def from_jax_params(
    flow_np: NpParams,
    interp_np: NpParams,
    device: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[UNet, UNet]:
    """The port's (flow, interp) UNets from parameter trees in the JAX
    package's layout; the width is read from conv1's shape."""
    dev = resolve_device(device)
    return _to_unet(flow_np, FLOW_IO, dev, dtype), _to_unet(interp_np, INTERP_IO, dev, dtype)
