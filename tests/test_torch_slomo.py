"""Port parity of the SloMo pieces against the JAX package (CPU, f32), on
the committed trained fixture tests/fixtures/slomo_golden.npz (base=8).

Tolerances: UNet and interpolation 1e-4 absolute on the normalised scale
(the convolutions sum in another order); warp 1e-5; resize 1e-5.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2e_tpu.models import slomo as jslomo
from v2e_tpu.models.backwarp import backwarp as jax_backwarp
from v2e_tpu.models.convert_ckpt import load_slomo_params as jax_load
from v2e_tpu.models.unet import unet_apply as jax_unet_apply
from v2e_tpu.ops.pallas.warp import bilinear_warp_pallas
from v2e_tpu_torch.models import slomo as tslomo
from v2e_tpu_torch.models.backwarp import backwarp, warp, warp_planar
from v2e_tpu_torch.models.convert_ckpt import from_jax_params, load_slomo_params
from v2e_tpu_torch.models.unet import unet_apply, unet_apply_io_nhwc

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "slomo_golden.npz")


def to_np(tree):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}


@pytest.fixture(scope="module")
def golden():
    jf, ji = jax_load(GOLDEN)
    tf, ti = from_jax_params(to_np(jf), to_np(ji), "cpu")
    return jf, ji, tf, ti


def test_npz_route_equals_jax_trees(golden):
    _, _, tf, ti = golden
    nf, ni = from_jax_params(*load_slomo_params(GOLDEN), device="cpu")
    for a, b in ((tf, nf), (ti, ni)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    assert "down1.conv1.weight" in tf.state_dict() and tf.base == 8


def test_unet_dense_matches(golden):
    jf, ji, tf, ti = golden
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.3, (2, 2, 64, 96)).astype(np.float32)
    want = np.asarray(jax_unet_apply(jf, jnp.asarray(x), None, "dense"))
    got = unet_apply(tf, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    x12 = rng.normal(0, 0.3, (2, 32, 64, 12)).astype(np.float32)
    want = np.asarray(jax_unet_apply(ji, jnp.asarray(x12).transpose(0, 3, 1, 2), None, "dense"))
    got = unet_apply_io_nhwc(ti, torch.from_numpy(x12)).numpy().transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def warp_inputs(N, H, W, max_flow, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.4, 0.6, (N, 1, H, W)).astype(np.float32)
    flow = rng.uniform(-max_flow, max_flow, (N, 2, H, W)).astype(np.float32)
    return img, flow


@pytest.mark.parametrize("max_flow", [3.0, 40.0])
def test_backwarp_and_warp_match_backwarp(max_flow):
    img, flow = warp_inputs(3, 30, 44, max_flow, seed=1)
    want = np.asarray(jax_backwarp(jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_allclose(backwarp(torch.from_numpy(img), torch.from_numpy(flow)).numpy(),
                               want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(warp(torch.from_numpy(img), torch.from_numpy(flow)).numpy(),
                               want, rtol=0, atol=1e-5)
    got = warp_planar(torch.from_numpy(img[:, 0]), torch.from_numpy(flow[:, 0]),
                      torch.from_numpy(flow[:, 1]), 32)
    np.testing.assert_allclose(got.numpy(), want[:, 0], rtol=0, atol=1e-5)


def test_warp_matches_pallas_within_window():
    img, flow = warp_inputs(2, 24, 136, 7.0, seed=2)
    want = np.asarray(bilinear_warp_pallas(
        jnp.asarray(img[:, 0]), jnp.asarray(flow), 8, True, precision="highest"))
    got = warp_planar(torch.from_numpy(img[:, 0]), torch.from_numpy(flow[:, 0]),
                      torch.from_numpy(flow[:, 1]), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_pre_and_postprocess_resize():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 70, 100)).astype(np.uint8)
    want = np.asarray(jslomo.preprocess_frames(jnp.asarray(frames), 64, 96))
    got = tslomo.preprocess_frames(torch.from_numpy(frames), 64, 96).numpy()
    assert got.shape == (3, 1, 64, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    interp = rng.normal(0, 0.2, (2, 3, 1, 64, 96)).astype(np.float32)
    want = np.asarray(jslomo.postprocess_frames(jnp.asarray(interp), 70, 100, False))
    got = tslomo._levels(torch.from_numpy(interp), 70, 100).numpy()
    # 1e-5 on the normalised scale is 255e-5 on the 0-255 scale
    np.testing.assert_allclose(got / 255.0, want / 255.0, rtol=0, atol=1e-5)
    q_want = np.asarray(jslomo.postprocess_frames(jnp.asarray(interp), 70, 100, True))
    q_got = tslomo.postprocess_frames(torch.from_numpy(interp), 70, 100).numpy()
    assert np.mean(q_got == q_want) > 0.999 and np.abs(q_got - q_want).max() <= 1.0


@pytest.mark.parametrize("U", [3, 5])
def test_interpolate_pairs(golden, U):
    jf, ji, tf, ti = golden
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 255, (3, 64, 96)).astype(np.float32)
    pre = jslomo.preprocess_frames(jnp.asarray(x), 64, 96)
    I0, I1 = pre[:-1], pre[1:]
    want = np.asarray(jslomo.interpolate_pairs(
        jf, ji, I0, I1, U, 4, jnp.float32, False, 32, "3pass", "dense"))
    tI0, tI1 = torch.from_numpy(np.array(I0)), torch.from_numpy(np.array(I1))
    got = tslomo.interpolate_pairs(tf, ti, tI0, tI1, U, max_group=4)
    assert got.shape == want.shape == (2, U, 1, 64, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    n_groups, g = tslomo._group_split(U, 2, 4)
    assert (n_groups, g) == jslomo._group_split(U, 2, 4) and n_groups > 1
