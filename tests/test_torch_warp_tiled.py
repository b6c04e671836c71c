"""K4's plain version (v2e_tpu_torch `warp_tiled` on CPU tensors) against
the JAX package's bilinear_warp_tiled in interpret mode, at the shapes of
tests/test_pallas_warp.py's TestWarpV2 plus 260x346 planes, and the warp
dispatch of models/backwarp.py.

Tolerance: 1e-5 absolute against the Pallas kernel, including flows that
leave the residual envelope (where both clamp).  Against backwarp inside
the envelope, 1e-4 as tests/test_pallas_warp.py holds the TPU kernel: both
kernels form the sample coordinate relative to the displaced tile, which
rounds differently from x + u by up to an ulp of ~200 px (1.5e-5 px),
times image gradients of up to ~4 per px in these random images.  Tile bases: the port sums a tile's flow in
float64, the JAX prepass in float32, so the two means can differ in the
last bits.  That changes a base only where a mean sits on a rounding tie
(an odd multiple of 64 px in x, of 4 px in y), and the output only where
the clamp is active as well.  The test therefore checks that its inputs
keep every tile mean at least 1e-3 px from a tie, and then holds the bases
equal and the outputs to 1e-5.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2e_tpu.models.backwarp import backwarp as jax_backwarp
from v2e_tpu.ops.pallas.warp_v2 import bilinear_warp_tiled
from v2e_tpu_torch import tracing
from v2e_tpu_torch.models.backwarp import warp, warp_planar
from v2e_tpu_torch.ops.kernels.warp_tiled import (
    max_base_for,
    tile_bases,
    warp_tiled,
)

ATOL = 1e-5
ATOL_BACKWARP = 1e-4


def jax_tiled(img, flow, max_base):
    return np.asarray(bilinear_warp_tiled(jnp.asarray(img), jnp.asarray(flow), max_base, True))


def jax_reference(img, flow):
    return np.asarray(jax_backwarp(jnp.asarray(img)[:, None], jnp.asarray(flow)))[:, 0]


def port_tiled(img, flow, max_base):
    f = torch.from_numpy(flow)
    return warp_tiled(torch.from_numpy(img), f[:, 0], f[:, 1], max_base).numpy()


def tie_margin(flow):
    """Smallest distance (px) of a tile mean from a rounding tie, with the
    means of the edge-replicated flow as the JAX prepass takes them."""
    n, _, H, W = flow.shape
    Ht, Wt = -(-H // 8) * 8, -(-W // 128) * 128
    p = np.pad(flow, ((0, 0), (0, 0), (0, Ht - H), (0, Wt - W)), mode="edge").astype(np.float64)
    m = p.reshape(n, 2, Ht // 8, 8, Wt // 128, 128).mean(axis=(3, 5))
    du = np.abs((m[:, 0] / 128.0) % 1.0 - 0.5) * 128.0
    dv = np.abs((m[:, 1] / 8.0) % 1.0 - 0.5) * 8.0
    return float(min(du.min(), dv.min()))


def jax_bases(flow, max_base):
    n, _, H, W = flow.shape
    Ht, Wt = -(-H // 8) * 8, -(-W // 128) * 128
    u = jnp.pad(jnp.asarray(flow[:, 0]), ((0, 0), (0, Ht - H), (0, Wt - W)), mode="edge")
    v = jnp.pad(jnp.asarray(flow[:, 1]), ((0, 0), (0, Ht - H), (0, Wt - W)), mode="edge")
    u5 = u.reshape(n, Ht // 8, 8, Wt // 128, 128)
    v5 = v.reshape(n, Ht // 8, 8, Wt // 128, 128)
    bu = jnp.clip(128 * jnp.round(jnp.mean(u5, axis=(2, 4)) / 128.0), -max_base, max_base)
    bv = jnp.clip(8 * jnp.round(jnp.mean(v5, axis=(2, 4)) / 8.0), -max_base, max_base)
    return np.asarray(bu), np.asarray(bv)


def smooth_field(rng, n, H, W, lo, hi, ny=5, nx=6):
    """Smooth flow [n,2,H,W]: bilinear upsampling of a coarse random grid."""
    coarse = torch.from_numpy(rng.uniform(lo, hi, (n, 2, ny, nx)).astype(np.float32))
    return torch.nn.functional.interpolate(
        coarse, size=(H, W), mode="bilinear", align_corners=True).numpy()


def case_large_base(rng):  # test_pallas_warp.py TestWarpV2.test_large_base_flow_exact
    img = rng.normal(size=(2, 24, 200)).astype(np.float32)
    base = rng.uniform(-60, 60, (2, 2, 1, 1)).astype(np.float32)
    var = np.clip(rng.normal(size=(2, 2, 24, 200)) * 1.5, -5, 5).astype(np.float32)
    return img, (base + var).astype(np.float32), 128


def case_smooth_gradient(rng):  # TestWarpV2.test_smooth_gradient_flow
    H, W = 24, 260
    img = rng.normal(size=(1, H, W)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    flow = np.stack([20 * np.sin(xx / 90)[None], 5 * np.cos(yy / 40)[None]], axis=1)
    return img, flow.astype(np.float32), 128


def case_sensor_fast(rng):
    """260x346 (partial tiles on both edges): fast motion of 33-120 px per
    image with a few px of smooth variation, inside the envelope."""
    n, H, W = 3, 260, 346
    img = (rng.random((n, H, W)) - 0.428).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    a = rng.uniform(33, 120, (n, 2, 1, 1)) * rng.choice([-1.0, 1.0], (n, 2, 1, 1))
    wave = np.stack([4 * np.sin(xx / 60) * np.cos(yy / 50), 3 * np.cos(xx / 70 + yy / 40)])
    return img, (a + wave[None]).astype(np.float32), 128


def case_sensor_clamped(rng):
    """260x346 with flow that varies by far more than the residual window
    inside a tile: the clamps act at many pixels."""
    img = (rng.random((1, 260, 346)) - 0.428).astype(np.float32)
    flow = smooth_field(rng, 1, 260, 346, 33.0, 120.0)
    flow = flow + rng.uniform(-120, 120, flow.shape).astype(np.float32)
    return img, flow.astype(np.float32), 128


def case_bucket_256(rng):
    """U = 192 or 256 widens max_base to 256."""
    img = (rng.random((1, 64, 300)) - 0.428).astype(np.float32)
    return img, smooth_field(rng, 1, 64, 300, 130.0, 240.0), 256


CASES = {
    "large_base": case_large_base,
    "smooth_gradient": case_smooth_gradient,
    "sensor_fast": case_sensor_fast,
    "sensor_clamped": case_sensor_clamped,
    "max_base_256": case_bucket_256,
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret(name):
    img, flow, max_base = CASES[name](np.random.default_rng(len(name)))
    assert tie_margin(flow) > 1e-3
    f = torch.from_numpy(flow)
    bu, bv = tile_bases(f[:, 0], f[:, 1], max_base)
    ju, jv = jax_bases(flow, max_base)
    np.testing.assert_array_equal(bu.numpy(), ju)
    np.testing.assert_array_equal(bv.numpy(), jv)
    got = port_tiled(img, flow, max_base)
    np.testing.assert_allclose(got, jax_tiled(img, flow, max_base), rtol=0, atol=ATOL)


def test_clamp_case_leaves_the_envelope():
    """The clamped case really differs from the unclamped backwarp."""
    img, flow, max_base = case_sensor_clamped(np.random.default_rng(len("sensor_clamped")))
    got = port_tiled(img, flow, max_base)
    assert np.abs(got - jax_reference(img, flow)).max() > 0.1


@pytest.mark.parametrize("name", ["large_base", "smooth_gradient", "sensor_fast", "max_base_256"])
def test_equals_backwarp_inside_envelope(name):
    img, flow, max_base = CASES[name](np.random.default_rng(len(name)))
    np.testing.assert_allclose(port_tiled(img, flow, max_base), jax_reference(img, flow),
                               rtol=0, atol=ATOL_BACKWARP)


def test_half_to_even_tile_base():
    """A tile mean of exactly 64 px rounds to base 0, 192 to 256 (half to
    even, as jnp.round); rows: 4 -> 0, 12 -> 16."""
    u = torch.full((4, 8, 128), 64.0)
    u[1], u[2], u[3] = 192.0, -64.0, 100.0
    v = torch.full((4, 8, 128), 4.0)
    v[1], v[2], v[3] = 12.0, -4.0, 5.0
    bu, bv = tile_bases(u, v, 256)
    assert bu.flatten().tolist() == [0.0, 256.0, -0.0, 128.0]
    assert bv.flatten().tolist() == [0.0, 16.0, -0.0, 8.0]
    assert tile_bases(torch.full((1, 8, 128), 900.0), torch.zeros(1, 8, 128), 128)[0].item() == 128


def test_warp_dispatch_by_window(monkeypatch):
    """models/backwarp.py: max_disp <= 32 goes to K3's wrapper (which takes
    no window), larger windows to K4's with max_base rounded up to a
    multiple of 128."""
    # the module: v2e_tpu_torch.models exports the function `backwarp` under its name
    bw = importlib.import_module("v2e_tpu_torch.models.backwarp")

    calls = []
    monkeypatch.setattr(bw, "bilinear_warp", lambda img, u, v: calls.append(("k3",)) or img)
    monkeypatch.setattr(bw, "warp_tiled", lambda img, u, v, mb: calls.append(("k4", mb)) or img)
    img = torch.zeros(2, 8, 16)
    flow = torch.zeros(2, 2, 8, 16)
    for d in (8, 32, 33, 96, 128, 129, 256):
        warp_planar(img, flow[:, 0], flow[:, 1], d)
    warp(img[:, None], flow, 64)
    assert calls == [("k3",), ("k3",), ("k4", 128), ("k4", 128), ("k4", 128),
                     ("k4", 256), ("k4", 256), ("k4", 128)]
    assert [max_base_for(d) for d in (33, 128, 129, 192, 256)] == [128, 128, 256, 256, 256]


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    img, flow, max_base = case_large_base(rng)
    before = tracing.counters()
    port_tiled(img, flow, max_base)
    after = tracing.counters()
    for k in ("launch.k3", "launch.k4"):
        assert after.get(k, 0) == before.get(k, 0), k
    with pytest.raises(ValueError):
        warp_tiled(torch.from_numpy(img), torch.from_numpy(flow[:, 0]),
                   torch.from_numpy(flow[:, 1]), 100)
