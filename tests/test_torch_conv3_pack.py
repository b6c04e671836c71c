"""K5's weight packing (v2e_tpu_torch/ops/kernels/conv3.py::pack_conv3_weights)
and the UNet's cache of packed weights, on the CPU.

* The packed layout, unpacked here independently of the port's code,
  equals the OIHW weights cast to the working type, with zeros past Ci and
  Co, at every shape K5 takes: the UNet's up tails (Co 64 and 32, the
  latter packed as 32 columns, unpadded), Ci not a multiple of 16 or of 8,
  Co not a multiple of 8, and two blocks of output channels.  Exact.
* `UNet.keep_float32_terms` packs exactly the layers the packedz form
  sends to K5: a packedz forward, recorded as tests/test_torch_unet_forms.py
  records it, passes each K5 call the cached weights of its layer, and no
  other layer holds a cache.  The JAX package's forward in the same form
  is recorded beside it: the same number of K5 calls at the same shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import v2e_tpu.models.unet as junet
import v2e_tpu.ops.pallas.conv3 as jconv3
import v2e_tpu_torch.models.unet as tunet
from v2e_tpu.models.unet import UNetSpec, init_unet_host
from v2e_tpu_torch.models.convert_ckpt import from_jax_params
from v2e_tpu_torch.ops.kernels.conv3 import conv3_pack_shape, pack_conv3_weights

from test_torch_unet_forms import np_tree, recorder


def unpack_bf16(packed, co, ci):
    """[co_blocks, 9, CiP/8, CoT, 8] -> OIHW [Co, Ci, 3, 3], and the padding."""
    cb, taps, ci8, cot, eight = packed.shape
    assert taps == 9 and eight == 8
    full = torch.empty((cb * cot, ci8 * 8, 3, 3), dtype=packed.dtype)
    for blk in range(cb):
        for t in range(9):
            for c8 in range(ci8):
                for o in range(cot):
                    full[blk * cot + o, c8 * 8: c8 * 8 + 8, t // 3, t % 3] = packed[blk, t, c8, o]
    return full[:co, :ci], full


def unpack_f32(packed, co, ci):
    """[9, CiP, CoP] -> OIHW [Co, Ci, 3, 3], and the padding."""
    full = packed.reshape(3, 3, packed.shape[1], packed.shape[2]).permute(3, 2, 0, 1)
    return full[:co, :ci], full


SHAPES = [
    (128, 64),  # up4 at base 32
    (64, 32),   # up5 at base 32: 32 columns, unpadded
    (256, 64),  # up2/up3 at base 8 and up3 at base 16
    (24, 40),   # Ci a multiple of 8, not of 16
    (20, 80),   # Ci not a multiple of 8; two blocks of output channels
    (8, 36),    # Co not a multiple of 8
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("ci,co", SHAPES)
def test_packed_layout_unpacks_to_the_weights(ci, co, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(ci * 100 + co)
    w = torch.from_numpy(rng.standard_normal((co, ci, 3, 3)).astype(np.float32))
    packed = pack_conv3_weights(w, dt)
    assert packed.dtype == dt and packed.is_contiguous()
    assert tuple(packed.shape) == conv3_pack_shape(ci, co, dt)
    if dtype == "bfloat16":
        cot = packed.shape[3]
        assert cot == (32 if co <= 32 else 64)
        assert packed.shape[0] * cot < co + cot  # no block of columns that is all padding
        got, full = unpack_bf16(packed, co, ci)
    else:
        got, full = unpack_f32(packed, co, ci)
    assert full.shape[1] == -(-ci // 16) * 16  # Ci padded to the MMA depth, no further
    assert torch.equal(got, w.to(dt))
    pad = full.clone()
    pad[:co, :ci] = 0
    assert not bool(pad.any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", [8, 16])
def test_unet_caches_packed_weights_for_the_k5_layers(monkeypatch, base, dtype):
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3 + base)
    flow = np_tree(init_unet_host(rng, UNetSpec(2, 4, base)))
    interp = np_tree(init_unet_host(rng, UNetSpec(12, 5, base)))
    tflow, tinterp = from_jax_params(flow, interp, "cpu", tdt)
    for params, net in ((flow, tflow), (interp, tinterp)):
        cached = {name: conv.packed_w for name, conv in net.named_modules()
                  if isinstance(conv, torch.nn.Conv2d) and conv.packed_w is not None}
        assert set(cached) == {name for name, _ in net.lane_convs()}
        for name, conv in net.lane_convs():
            assert torch.equal(cached[name], pack_conv3_weights(conv.weight, tdt))

        j_k5, t_k5 = [], []
        monkeypatch.setattr(jconv3, "conv3x3_lane", recorder(
            jconv3.conv3x3_lane, j_k5, lambda a, y: tuple(a[0].shape)))
        calls = []

        def keep(args, y):
            return tuple(args[0].shape), args[1]

        real = tunet.conv3x3_lane

        def wrapped(*args, **kw):
            calls.append(kw.get("packed"))
            return real(*args, **kw)

        monkeypatch.setattr(tunet, "conv3x3_lane", recorder(wrapped, t_k5, keep))
        cin = net.in_ch
        x = np.random.default_rng(base).normal(size=(1, 32, 64, cin)).astype(np.float32)
        junet.unet_apply_io_nhwc(params, jnp.asarray(x),
                                 jnp.bfloat16 if dtype == "bfloat16" else None, "packedz")
        tunet.unet_apply_io_nhwc(net, torch.from_numpy(x), "packedz")
        assert [s for s, _ in t_k5] == j_k5
        by_weight = {id(conv.weight): conv for _, conv in net.lane_convs()}
        assert len(t_k5) == len(by_weight) and len(calls) == len(t_k5)
        for (_, w), packed in zip(t_k5, calls):
            assert packed is by_weight[id(w)].packed_w
        monkeypatch.undo()
