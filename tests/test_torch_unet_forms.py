"""The port's UNet forward in each of the nine conv forms (--unet_conv)
against the JAX package's unet_apply_io_nhwc in the same form, on the CPU,
at 32x64 pixels: the interp UNet (12->5) at base 8 and the flow UNet (2->4)
at base 16, with the same numpy-drawn weights, in float32 and in bf16.

The JAX package runs its lane conv kernel (K5) through
`_conv_block3_lane` in Pallas interpret mode, and its fold through
`_upconv_fold_block`; both are wrapped here to record what each forward
sent to them, and so are the port's `conv3x3_lane` and `upconv_fold`:
* each form sends the same layers, at the same shapes, to K5 and to the
  fold in both packages (packedz: up2 and up3 at base 8, up3 and up4 at
  base 16; fold45: up4 and up5; fold: every up level);
* every shape the port sends to K5 is one JAX's `conv3x3_lane_supported`
  accepts;
* in bf16, the port's K5 applied to the exact input JAX's K5 received
  returns JAX's output within one bf16 ulp, at most 0.1 % of the elements
  differing (test_torch_conv3.py: a dense epilogue differs at 20-40 %, a
  bfloat16 bias at 11-16 %).  This is the check that fails if the port
  runs a dense layer where JAX runs K5: the whole forward cannot show it,
  because the dense layers before the up tail already differ by bf16
  roundings (the port adds the bias inside the conv, JAX after rounding
  the conv), some 10x the difference between the two epilogues.

Whole-forward tolerances: float32 1e-6 absolute (measured 1.0e-7: the sums
of 23 convolutions in another order); bf16 2e-3 absolute, two bf16 ulps of
the outputs' largest magnitudes, with a mean absolute difference below
1e-4 (measured 9.8e-4 and 4.5e-5).
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
from v2e_tpu_torch.ops.kernels.conv3 import conv3x3_lane

from test_torch_conv3 import assert_bf16_close

FORMS = ("dense", "packedz", "fold", "fold45", "packedfold", "packedfold45",
         "packed", "packedup", "blocked")
# base -> (in, out) of the UNet under test, and the up levels packedz sends to K5
NETS = {8: ((12, 5), (2, 3)), 16: ((2, 4), (3, 4))}
FOLDED = {"fold": (1, 2, 3, 4, 5), "packedfold": (1, 2, 3, 4, 5),
          "fold45": (4, 5), "packedfold45": (4, 5)}


def np_tree(tree):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}


@pytest.fixture(scope="module")
def nets():
    out = {}
    for base in NETS:
        rng = np.random.default_rng(3 + base)
        flow = np_tree(init_unet_host(rng, UNetSpec(2, 4, base)))
        interp = np_tree(init_unet_host(rng, UNetSpec(12, 5, base)))
        for dtype in (torch.float32, torch.bfloat16):
            tf, ti = from_jax_params(flow, interp, "cpu", dtype)
            params, net = (interp, ti) if NETS[base][0][0] == 12 else (flow, tf)
            out[base, dtype] = (params, net)
    return out


def recorder(fn, calls, keep):
    def wrapped(*args, **kw):
        y = fn(*args, **kw)
        calls.append(keep(args, y))
        return y
    return wrapped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", sorted(NETS))
@pytest.mark.parametrize("form", FORMS)
def test_forward_matches_jax(nets, monkeypatch, form, base, dtype):
    tdt = getattr(torch, dtype)
    params, net = nets[base, tdt]
    (cin, _), lane_levels = NETS[base]
    x = np.random.default_rng(base).normal(size=(2, 32, 64, cin)).astype(np.float32)

    j_k5, t_k5, j_fold, t_fold = [], [], [], []
    monkeypatch.setattr(jconv3, "conv3x3_lane", recorder(
        jconv3.conv3x3_lane, j_k5,
        lambda a, y: (np.array(a[0].astype(jnp.float32)), np.array(y.astype(jnp.float32)))))
    monkeypatch.setattr(tunet, "conv3x3_lane", recorder(
        tunet.conv3x3_lane, t_k5, lambda a, y: (tuple(a[0].shape), a[1], a[2])))
    monkeypatch.setattr(junet, "_upconv_fold_block", recorder(
        junet._upconv_fold_block, j_fold, lambda a, y: tuple(a[0].shape)))
    monkeypatch.setattr(tunet, "upconv_fold", recorder(
        tunet.upconv_fold, t_fold, lambda a, y: tuple(a[0].permute(0, 2, 3, 1).shape)))

    want = np.asarray(junet.unet_apply_io_nhwc(
        params, jnp.asarray(x), jnp.bfloat16 if dtype == "bfloat16" else None, form))
    got = tunet.unet_apply_io_nhwc(net, torch.from_numpy(x), form).numpy()
    assert got.shape == want.shape == (2, 32, 64, NETS[base][0][1])

    # the same layers go to K5 and to the fold, at the same shapes
    assert [c[0] for c in t_k5] == [c[0].shape for c in j_k5]
    # packedz: conv1 and conv2 of each lane level, Ci = 32 * base >> (i - 1)
    lane_ci = [32 * base >> (i - 1) for i in lane_levels for _ in (1, 2)]
    assert [c[0][3] for c in t_k5] == (lane_ci if form == "packedz" else [])
    for shape, w, _ in t_k5:
        assert 32 <= w.shape[0] <= 64
        assert jconv3.conv3x3_lane_supported(shape, w.shape[0],
                                             itemsize=4 if dtype == "float32" else 2)
    assert t_fold == j_fold
    assert len(t_fold) == len(FOLDED.get(form, ()))

    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.astype(np.float32)
    assert np.abs(got - want).max() <= 2e-3 and np.abs(got - want).mean() <= 1e-4
    # K5 layer by layer: the port's call on the input JAX's kernel received
    for (_, w, b), (xj, yj) in zip(t_k5, j_k5):
        assert b.dtype == torch.float32
        y = conv3x3_lane(torch.from_numpy(xj).to(torch.bfloat16), w, b)
        assert_bf16_close(y.float().numpy(), yj)
