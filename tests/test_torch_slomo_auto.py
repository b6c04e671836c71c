"""The port's auto-upsampling and warp-kernel decisions against the JAX
package's, for the same flows: SuperSloMo.choose_upsampling (U =
ceil(max flow), floored by an explicit factor, bucketed), the warp window
(auto and U > 32 -> window U and K4, else K3) and
FusedConverter.note_collected (the one-chunk lookahead).  The JAX engine
is built with use_pallas_warp=True, the TPU's setting, under which its
_choose_disp buckets the window of K3 to 8, 16 or 32 px; the port's K3
takes no window, so what must be equal is the kernel each side picks, and
K4's window.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2e_tpu.fused import FusedConverter as JaxFused
from v2e_tpu.models import slomo as jslomo
from v2e_tpu_torch.fused import FusedConverter
from v2e_tpu_torch.models import slomo as tslomo

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "slomo_golden.npz")
MAX_SPEEDS = (0.0, 0.7, 1.0, 1.01, 4.9, 5.2, 11.0, 23.9, 24.5, 33.0, 47.5, 96.0, 100.2,
              250.0, 600.0, 1500.0)


def flow_with_speed(speed, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(-1, 1, (3, 4, 8, 12)).astype(np.float32)
    f[:, :2] *= 0.5 * speed / np.sqrt(2)
    f[:, 2:] *= 0.4 * speed / np.sqrt(2)
    f[1, 0, 3, 5], f[1, 1, 3, 5] = 0.6 * speed, 0.8 * speed  # the max, |(u,v)| = speed
    return f


def kernel(window):
    """The warp kernel a window selects (models/backwarp.py::warp_planar),
    with K4's window."""
    return ("K4", window) if window > 32 else ("K3",)


def engines(auto, factor):
    j = jslomo.SuperSloMo(GOLDEN, auto, factor, use_pallas_warp=True, compute_dtype="float32")
    t = tslomo.SuperSloMo(GOLDEN, auto, factor, compute_dtype="float32", device="cpu")
    return j, t


def test_bucket_ladder_matches():
    assert tslomo.UPSAMPLE_BUCKETS == jslomo.UPSAMPLE_BUCKETS
    for u in range(0, 1100):
        assert tslomo.bucket_upsampling_factor(u) == jslomo.bucket_upsampling_factor(u)


@pytest.mark.parametrize("auto,factor", [(True, None), (True, 67), (True, 12), (False, 12)],
                         ids=["auto", "auto_floor67", "auto_floor12", "fixed12"])
def test_upsampling_and_window_choices_match(auto, factor):
    j, t = engines(auto, factor)
    for speed in MAX_SPEEDS:
        f = flow_with_speed(speed)
        uj = j.choose_upsampling(jnp.asarray(f))
        ut = t.choose_upsampling(torch.from_numpy(f))
        assert ut == uj, speed
        assert kernel(t.warp_window(ut)) == kernel(j._choose_disp(jnp.asarray(f), uj)), speed
    assert t.avg_upsampling_factor == j.avg_upsampling_factor


@pytest.mark.parametrize("auto,factor", [(True, None), (True, 67), (False, 12)],
                         ids=["auto", "auto_floor67", "fixed12"])
def test_lookahead_matches(auto, factor):
    j, t = engines(auto, factor)
    fj, ft = JaxFused(j, None), FusedConverter(t, None)
    for speed in MAX_SPEEDS:
        fj.note_collected({"max_flow": float(np.float32(speed))})
        ft.note_collected({"max_flow": float(np.float32(speed))})
        assert (ft._next_u, kernel(ft.window)) == (fj._next_u, kernel(fj._disp)), speed
