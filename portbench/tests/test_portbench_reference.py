"""The plain references agree with the port's own CPU path at a small size
(base 8, 64x96 or 180x240), so that on the card they judge the port by
the published equations: the UNet forward, the warp, a SloMo chunk, an
emulator chunk with noise off, one training step (float32, TF32 off)."""
import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.reference import emulator as ref_em
from portbench.reference import slomo as ref_slomo
from portbench.reference import train as ref_train
from portbench.weights import make_slomo_weights, numpy_trees


@pytest.fixture(scope="module")
def weights():
    return make_slomo_weights(7, 8, "cpu", torch.float32)


def port_unets(weights, dtype=torch.float32):
    from v2e_tpu_torch.models.convert_ckpt import from_jax_params

    return from_jax_params(*numpy_trees(*weights), "cpu", dtype)


def test_unet_forward(weights):
    flow_net, interp_net = port_unets(weights)
    g = torch.Generator().manual_seed(1)
    for net, w, cin in ((flow_net, weights[0], 2), (interp_net, weights[1], 12)):
        x = torch.randn(2, cin, 64, 96, generator=g)
        with torch.no_grad():
            want = net(x)
        got = ref_slomo.unet(w, x)
        assert torch.allclose(got, want, atol=1e-5, rtol=1e-4)


def test_warp():
    from v2e_tpu_torch.models.backwarp import backwarp

    g = torch.Generator().manual_seed(2)
    img = torch.rand(3, 1, 32, 48, generator=g)
    flow = 6 * torch.randn(3, 2, 32, 48, generator=g)
    assert torch.allclose(ref_slomo.backwarp(img, flow), backwarp(img, flow), atol=1e-5)


def test_resize_matches():
    from v2e_tpu_torch.models.resize import resize

    x = torch.rand(2, 180, 240, generator=torch.Generator().manual_seed(3))
    for (h, w), k in (((160, 224), "lanczos3"), ((200, 260), "bilinear")):
        # the port builds its weights in float32, the reference in float64
        assert torch.allclose(ref_slomo.resize(x, h, w, k), resize(x, (h, w), k), atol=5e-5)


def test_slomo_chunk(weights):
    from v2e_tpu_torch.models.slomo import SuperSloMo

    src = traffic.make_source({"kind": "texture_blob", "fps": 30, "loop_frames": 8}, 180, 240, 5)
    frames = torch.from_numpy(src.frames[:3])
    engine = SuperSloMo(None, upsampling_factor=3, compute_dtype="float32", device="cpu", base=8)
    engine.flow_net, engine.interp_net = port_unets(weights)
    got, U = engine.interpolate_batch(frames, 180, 240)
    want = ref_slomo.interpolate_chunk(*weights, frames, 3)
    assert U == 3 and got.shape == want.shape
    assert float((got - want).abs().mean()) < 1e-3 and float((got - want).abs().max()) <= 1.0


@pytest.mark.parametrize("refractory", [0.0, 0.0005])
def test_emulator_chunk_without_noise(refractory):
    from v2e_tpu_torch.emulator import EventEmulator

    src = traffic.make_source({"kind": "texture_blob", "fps": 30, "loop_frames": 40}, 60, 80, 9)
    frames = src.frames[:40].astype(np.float32)
    times = np.arange(40) / 300.0
    px = dict(sigma_thres=0.0, cutoff_hz=300.0, leak_rate_hz=0.0, shot_noise_rate_hz=0.0,
              refractory_period_s=refractory)
    em = EventEmulator(**px, seed=3, device="cpu", shuffle_events_within_iteration=False)
    ev = em.generate_events_batch(frames, times)
    ref = ref_em.PixelArray(ref_em.PixelConfig(**px), 3, "cpu")
    ref.start(torch.from_numpy(frames[0]), 0.0)
    on, off = ref.run_chunk(torch.from_numpy(frames[1:]), times[1:])
    got = np.zeros((2, 60, 80), np.int64)
    np.add.at(got, ((ev[:, 3] > 0).astype(int), ev[:, 2].astype(int), ev[:, 1].astype(int)), 1)
    total = int(on.sum() + off.sum())
    assert total > 10000
    # 8-bit frames return to earlier levels, where lp - base is an exact
    # multiple of the threshold: float32 and float64 round those ties
    # apart (the port's float32 misses some crossings the reference makes)
    diff = np.abs(got[1] - on.numpy()).sum() + np.abs(got[0] - off.numpy()).sum()
    assert diff / total < 0.01


def test_one_training_step(weights):
    from v2e_tpu_torch.models.train import create_train_state, make_train_step

    clip = traffic.render_texture_clip(8, 72, 128, np.random.default_rng(4))
    (batch,) = ref_train.sample_batches([clip], (64, 96), 2, 11, 2, 1)
    state = create_train_state(0, 1e-4, 8, "cpu", numpy_trees(*weights))
    state, metrics = make_train_step()(state, batch)
    ref = ref_train.train(*weights, [batch], 1e-4, "cpu")
    assert float(metrics["loss"]) == pytest.approx(ref["loss"][0]["loss"], rel=1e-5)
    # Adam's first step moves each element by lr times the gradient's
    # sign, so an element whose gradient is nought to rounding may move
    # the other way (2 lr apart); every other element agrees to 1e-7
    far = total = 0
    for net, m in (("flow", state.flow_net), ("interp", state.interp_net)):
        for n, p in m.named_parameters():
            d = (p.detach() - ref["params"][f"{net}/{n}"]).abs()
            assert float(d.max()) <= 2e-4 + 1e-7
            far += int((d > 1e-7).sum())
            total += d.numel()
    assert far / total < 1e-3
