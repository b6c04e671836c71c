"""Port parity of the fused conversion chunk (v2e_tpu_torch.fused) against
v2e_tpu.fused at a small size: f32 compute, the XLA warp on the JAX side,
the golden fixture's weights, noise off, the emulator's parameters and
state carried across.

Tolerances: interpolated frames 1e-4 absolute on the normalised scale; at
least 99.9 % of ev_count cells equal and total events within 0.1 %
(rounding to 8-bit levels can flip at ties); the JAX package's
postprocessed frames fed to both emulators give identical events.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2e_tpu.emulator.config import EmulatorConfig as JaxConfig
from v2e_tpu.emulator.core import emulate_and_compact, unpack_scalars
from v2e_tpu.emulator.events import materialize_events_sparse as jax_materialize
from v2e_tpu.emulator.state import init_state
from v2e_tpu.fused import fused_chunk as jax_fused_chunk
from v2e_tpu.models import slomo as jslomo
from v2e_tpu.models.convert_ckpt import load_slomo_params
from v2e_tpu.models.unet import unet_apply as jax_unet_apply
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import emulate_and_compact_impl
from v2e_tpu_torch.emulator.events import materialize_events_sparse
from v2e_tpu_torch.emulator.state import from_jax_emulator
from v2e_tpu_torch.fused import fused_chunk
from v2e_tpu_torch.models import slomo as tslomo
from v2e_tpu_torch.models.convert_ckpt import from_jax_params
from v2e_tpu_torch.models.unet import DENSE, unet_apply

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "slomo_golden.npz")
H, W, B, U = 48, 64, 3, 4
EMU = dict(sigma_thres=0.03, cutoff_hz=300.0, leak_rate_hz=0.0,
           shot_noise_rate_hz=0.0, refractory_period_s=0.0005)
CAP = 1 << 14
NO_DRAWS = {"leak": None, "shot": None, "photoreceptor": None}


def np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None and f.name != "key"}


def to_np(tree):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}


@pytest.fixture(scope="module")
def case():
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    src = np.stack([np.clip(110 + 60 * np.sin((xx + 1.7 * i) / 9.0) * np.cos(yy / 7.0),
                            0, 255) for i in range(B + 1)]).astype(np.float32)
    times = ((np.arange(B * U) + 1) / (30.0 * U)).astype(np.float32)
    jf, ji = load_slomo_params(GOLDEN)
    jcfg = JaxConfig(use_pallas_scan=False, **EMU)
    params, state = init_state(jcfg, jnp.asarray(src[0]), jnp.float32(0.0), jax.random.key(2))
    statics = (H, W, U, 8, jnp.float32, False, 32, True, "3pass", "dense")
    j_state, j_outs, j_packed = jax_fused_chunk(
        jcfg, statics, params, state, jf, ji, CAP, jnp.asarray(src), jnp.asarray(times))
    tf, ti = from_jax_params(to_np(jf), to_np(ji), "cpu")
    tparams, tstate = from_jax_emulator(np_fields(params), np_fields(state), "cpu")
    t_state, t_outs, t_packed = fused_chunk(
        EmulatorConfig(**EMU), (H, W, U, 8, 32, DENSE), tparams, tstate, tf, ti, CAP,
        torch.from_numpy(src), torch.from_numpy(times), None, NO_DRAWS)
    return dict(src=src, times=times, jf=jf, ji=ji, tf=tf, ti=ti, jcfg=jcfg,
                params=params, state=state, tparams=tparams, tstate=tstate,
                jax=(j_state, j_outs, j_packed), port=(t_state, t_outs, t_packed))


def test_interpolated_frames_match(case):
    x = jslomo.preprocess_frames(jnp.asarray(case["src"]), 32, 64)
    flow = jax_unet_apply(case["jf"], jnp.concatenate([x[:-1], x[1:]], axis=1), None, "dense")
    want = np.asarray(jslomo.interpolate_pairs(
        case["jf"], case["ji"], x[:-1], x[1:], U, 8, jnp.float32, False, 32, "3pass",
        "dense", flow_out=flow))
    tx = tslomo.preprocess_frames(torch.from_numpy(case["src"]), 32, 64)
    tflow = unet_apply(case["tf"], torch.cat([tx[:-1], tx[1:]], dim=1))
    got = tslomo.interpolate_pairs(case["tf"], case["ti"], tx[:-1], tx[1:], U, 8,
                                   flow_out=tflow)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tslomo.max_flow_speed(tflow)),
                               float(jslomo.max_flow_speed(flow)), rtol=1e-4)


def test_fused_chunk_events_match(case):
    _, jo, jp = case["jax"]
    _, to, tp = case["port"]
    jc, tc = np.asarray(jo["ev_count"]), to["ev_count"].numpy()
    assert jc.shape == tc.shape == (B * U, H, W)
    n_j, n_t = int(np.abs(jc).sum()), int(np.abs(tc).sum())
    assert n_j > 500
    assert np.mean(jc == tc) >= 0.999
    assert abs(n_t - n_j) <= 0.001 * n_j
    j_scal, t_scal = np.asarray(jp["scalars"]), tp["scalars"].numpy()
    np.testing.assert_allclose(t_scal[-1:].view(np.float32), j_scal[-1:].view(np.float32),
                               rtol=1e-4)


def test_same_frames_give_identical_events(case):
    """The JAX package's postprocessed frames through both emulators."""
    x = jslomo.preprocess_frames(jnp.asarray(case["src"]), 32, 64)
    interp = jslomo.interpolate_pairs(case["jf"], case["ji"], x[:-1], x[1:], U, 8,
                                      jnp.float32, False, 32, "3pass", "dense")
    dvs = jslomo.postprocess_frames(interp, H, W, True)
    _, jo, jp = emulate_and_compact(case["jcfg"], case["params"], case["state"], dvs,
                                    jnp.asarray(case["times"]), CAP)
    _, to, tp = emulate_and_compact_impl(
        EmulatorConfig(**EMU), case["tparams"], case["tstate"],
        torch.from_numpy(np.array(dvs)), torch.from_numpy(case["times"]), CAP, NO_DRAWS)
    np.testing.assert_array_equal(to["ev_count"].numpy(), np.asarray(jo["ev_count"]))
    np.testing.assert_array_equal(tp["scalars"].numpy(), np.asarray(jp["scalars"]))
    sc = unpack_scalars(np.asarray(jp["scalars"]))
    n = sc["n_occ"]
    rest = (sc["stride"], sc["K"], sc["t_prev"], sc["t_frame"], H, W, 1.5)
    want = jax_materialize(*(np.asarray(jp["sparse"][k])[:n] for k in ("idx", "count", "i0")),
                           None, *rest)
    got = materialize_events_sparse(*(tp["sparse"][k][:n].numpy() for k in ("idx", "count", "i0")),
                                    None, *rest)
    assert want[0].shape[0] > 500
    np.testing.assert_array_equal(got[0], want[0])
