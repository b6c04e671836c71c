"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`; each test skips when no CUDA device is present (decided in a
fixture, so every test worker collects the same tests).  On an H100:
    python -m pytest tests/test_torch_kernels_gpu.py -q
Tolerance: K1 counts, i0 and K identical, base and memory within 1e-6; K2
counts identical, base within 1e-6 (at CLI run B's shape, at 720x1280, in
the clean form, with one stream absent, at F = 1 and F below the ring
depth, and from views whose data pointers are not 16-byte aligned); K3 and K4 within 1e-5; K3's VJP
within 1e-6 for the flow gradients and 1e-5 of the largest value for the
image gradient (summed with atomics in no fixed order), and one training
step at base 8 on the card against the CPU with cuDNN's TF32 off at
tests/test_torch_train.py's tolerances with cuDNN off, and with cuDNN on
its gradients within 1e-3 of their largest (cuDNN's float32 weight
gradients of the 5x5 layers: 4.4e-4 off float64); K5 in float32
within 1e-5 (float32 sums in another order, inputs of unit scale: measured
4.3e-6), in bf16 within one bf16 ulp of each element, or 1e-5 absolute near
zero where the two float32 sums' own rounding exceeds an ulp (measured up
to 4e-6 at values near 1e-4), with at most 0.5 % of the elements differing
(measured 0.06 % at up4), against the plain version run with cuDNN's TF32
off.  K6 (the bilinear x2 upsample) and its VJP equal their plain
versions bit for bit; K6 is within one ulp of F.interpolate in bf16 and
fp16 and three in float32, and its VJP within four float32 ulps of
autograd in float64 (see the tests for the scale).  K8 (the UNets' conv
epilogue) equals its plain version bit for bit; the inference path's
pooling is within one bf16 ulp of F.avg_pool2d.  The emulator's
variant paths (SciDVS, CSDVS, the per-frame path) have no kernel: they
are held card against CPU at the tolerances of
test_torch_variants.py, and a checkpoint's resume on the card bit for bit.
The synthetic renderers on the card equal the port's host generators
(particles within 1e-3 of its float64 painter, two float32 ulps of the
CPU renderer), and the CLI's synthetic device path gives the CPU's events
with K1 and with K2.
"""
import pytest
import torch

from v2e_tpu_torch import tracing
from v2e_tpu_torch.ops.kernels.conv3 import (
    conv3x3_lane,
    conv3x3_lane_plain,
    pack_conv3_weights,
)
from v2e_tpu_torch.ops.kernels.emulator_scan import (
    refractory_grid,
    refractory_scan,
    refractory_scan_plain,
    scan,
    scan_plain,
)
from v2e_tpu_torch.ops.kernels.warp import (
    BilinearWarpFn,
    bilinear_warp,
    bilinear_warp_vjp,
    warp_plain,
    warp_plain_vjp,
)
from v2e_tpu_torch.ops.kernels.upsample import (
    Upsample2xFn,
    upsample2x,
    upsample2x_plain,
    upsample2x_plain_vjp,
    upsample2x_vjp,
)
from v2e_tpu_torch.ops.kernels.warp_tiled import warp_tiled, warp_tiled_plain
from v2e_tpu_torch.ops.kernels.conv_epilogue import conv_bias_leaky, conv_bias_leaky_plain
from test_torch_upsample import library, within_ulps

pytestmark = pytest.mark.gpu

# each wrapper's launch counter (v2e_tpu_torch/tracing.py)
LAUNCH = {"refractory_scan": "launch.k1", "refractory_scan_strips": "launch.k1_strips",
          "scan": "launch.k2", "bilinear_warp": "launch.k3", "bilinear_warp_vjp": "launch.k3_vjp",
          "warp_tiled": "launch.k4", "conv3x3_lane": "launch.k5", "upsample2x": "launch.k6",
          "upsample2x_vjp": "launch.k6_vjp", "conv_bias_leaky": "launch.k8"}


def n_launches(kernel) -> int:
    """The kernel launches `kernel`'s wrapper has made in this process."""
    return tracing.counters().get(LAUNCH[kernel.__name__], 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def refractory_inputs(cuda, F, H, W, R, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    lp = 4.6 + 0.4 * torch.randn((F, H, W), generator=g, device=cuda)
    pos = 0.2 + 0.03 * torch.rand((H, W), generator=g, device=cuda)
    neg = 0.2 + 0.03 * torch.rand((H, W), generator=g, device=cuda)
    base = lp[0].clone()
    mem = torch.full((H, W), -R, device=cuda)
    dts = torch.full((F,), 1 / 3000.0, device=cuda)
    t_prevs = torch.cumsum(dts, 0) - dts
    leak = 1e-3 * torch.rand((F, H, W), generator=g, device=cuda)
    shot = (torch.rand((F, H, W), generator=g, device=cuda) < 0.01).to(torch.uint8)
    return (lp, leak, shot, pos, neg, base, mem, dts, t_prevs, R)


@pytest.mark.parametrize("F,H,W,R", [
    (12, 37, 301, 0.0),
    (12, 37, 301, 0.0005),
    (1, 37, 301, 0.0005),     # one frame: one grid barrier
    (4, 720, 1280, 0.0005),   # more pixels than resident threads: global state
])
def test_refractory_scan_kernel_matches_plain(cuda, F, H, W, R):
    args = refractory_inputs(cuda, F, H, W, R)
    n0 = n_launches(refractory_scan)
    got = refractory_scan(*args)
    want = refractory_scan_plain(*args)
    assert n_launches(refractory_scan) == n0 + 1
    (blocks, threads, regpix) = refractory_grid(H * W, args[0].device)
    assert regpix == 0 or H * W <= blocks * threads * regpix
    if H * W > 500_000:  # more pixels than the grid has threads
        assert H * W > blocks * threads
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= 1e-6
    if R > 0:  # the filter acts: R > dt/max(K, 1) in every frame, and cuts spikes
        assert bool((torch.clamp(got[4], min=1).to(torch.float32) * R > args[7]).all())
        if F > 1:
            assert int(got[3].max()) > 0


@pytest.mark.parametrize("noise", [True, False], ids=["leak_shot", "no_noise"])
def test_scan_kernel_matches_plain(cuda, noise):
    g = torch.Generator(device=cuda).manual_seed(2)
    F, H, W = 140, 37, 301
    lp = 4.6 + 0.4 * torch.randn((F, H, W), generator=g, device=cuda)
    pos = 0.2 + 0.03 * torch.rand((H, W), generator=g, device=cuda)
    neg = 0.2 + 0.03 * torch.rand((H, W), generator=g, device=cuda)
    base = lp[0].clone()
    leak = 1e-3 * torch.rand((F, H, W), generator=g, device=cuda) if noise else None
    shot = ((torch.rand((F, H, W), generator=g, device=cuda) < 0.01).to(torch.uint8)
            if noise else None)
    args = (lp, leak, shot, pos, neg, base)
    n0 = n_launches(scan)
    got = scan(*args)
    want = scan_plain(*args)
    assert n_launches(scan) == n0 + 1
    assert torch.equal(got[1], want[1])
    assert int(got[1].abs().sum()) > 1000
    assert float((got[0] - want[0]).abs().max()) <= 1e-6


def scan_inputs(cuda, F, H, W, leak=True, shot=True, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    lp = 4.6 + 0.4 * torch.randn((F, H, W), generator=g, device=cuda)
    pos = 0.2 + 0.03 * torch.rand((H, W), generator=g, device=cuda)
    neg = 0.2 + 0.03 * torch.rand((H, W), generator=g, device=cuda)
    base = lp[0] + 0.05 * torch.randn((H, W), generator=g, device=cuda)
    lk = 1e-3 * torch.rand((F, H, W), generator=g, device=cuda) if leak else None
    sh = ((torch.rand((F, H, W), generator=g, device=cuda) < 0.01).to(torch.uint8)
          if shot else None)
    return lp, lk, sh, pos, neg, base


def unaligned(t, elems):
    """A contiguous copy of t whose data pointer is `elems` elements past
    an allocation's start (not 16-byte aligned)."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = flat[elems: elems + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


def assert_scan_matches_plain(args):
    n0 = n_launches(scan)
    got = scan(*args)
    assert n_launches(scan) == n0 + 1
    want = scan_plain(*args)
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= 1e-6
    return got


@pytest.mark.parametrize("F,H,W,leak,shot", [
    (96, 260, 346, True, True),    # CLI run B's shape (noisy preset)
    (96, 260, 346, False, False),  # the clean form
    (96, 720, 1280, True, True),   # tiles: strips longer than a block's threads
    (1, 37, 301, True, True),      # one frame
    (3, 37, 301, True, True),      # fewer frames than the ring's stages
    (20, 37, 301, True, False),    # leak only
    (20, 37, 301, False, True),    # shot only
    (5, 1, 17, True, True),        # 17 pixels: two blocks, a partial unit
])
def test_scan_kernel_at_more_shapes(cuda, F, H, W, leak, shot):
    args = scan_inputs(cuda, F, H, W, leak, shot)
    got = assert_scan_matches_plain(args)
    from v2e_tpu_torch.ops.kernels import emulator_scan

    plan = emulator_scan._device_plan(H * W, F, args[0].device.index,
                                      *emulator_scan.stream_layout(*args[:3]))[0]
    assert plan.npix == H * W and plan.smem_bytes <= 232_448
    assert len(plan.strips) - 1 == min(torch.cuda.get_device_properties(cuda)
                                       .multi_processor_count, -(-H * W // 16))
    if F > 1:
        assert int(got[1].abs().sum()) > 0


@pytest.mark.parametrize("F,H,W", [(20, 37, 301), (9, 260, 346)])
def test_scan_kernel_unaligned_views(cuda, F, H, W):
    lp, leak, shot, pos, neg, base = scan_inputs(cuda, F, H, W)
    args = (unaligned(lp, 1), unaligned(leak, 3), unaligned(shot, 1), pos, neg, base)
    got = assert_scan_matches_plain(args)
    assert torch.equal(got[1], scan(lp, leak, shot, pos, neg, base)[1])


@pytest.mark.parametrize("refusal", ["shared_memory", "threads"])
def test_scan_kernel_raises_and_never_falls_back(cuda, monkeypatch, refusal):
    """A plan the card refuses raises from the wrapper, with no launch
    counted and no CUDA tensor sent to the plain version: more shared
    memory than a block may have (cudaFuncSetAttribute refuses it), or more
    threads than the kernel takes."""
    from v2e_tpu_torch.ops.kernels import emulator_scan

    args = scan_inputs(cuda, 4, 37, 301)
    plan, _, tiles = emulator_scan._device_plan(
        37 * 301, 4, args[0].device.index, *emulator_scan.stream_layout(*args[:3]))
    bad = emulator_scan.c_plan(plan)
    if refusal == "shared_memory":
        bad.frame_bytes = 16 * 1024
        ring = emulator_scan.RING * emulator_scan.GROUP * bad.frame_bytes
        bad.smem_bytes = emulator_scan.BAR_BYTES + ring
    else:
        bad.threads = 2048

    def refuse(*a, **k):
        raise AssertionError("scan_plain reached with CUDA tensors")

    monkeypatch.setattr(emulator_scan, "scan_plain", refuse)
    monkeypatch.setattr(emulator_scan, "_device_plan", lambda *a: (plan, bad, tiles))
    n0 = n_launches(scan)
    with pytest.raises(RuntimeError):
        scan(*args)
    assert n_launches(scan) == n0
    monkeypatch.undo()
    assert_scan_matches_plain(args)  # the refusal left no fault behind


@pytest.mark.parametrize("max_base", [128, 256])
def test_warp_tiled_kernel_matches_plain(cuda, max_base):
    g = torch.Generator(device=cuda).manual_seed(3)
    N, H, W = 3, 260, 346
    img = torch.rand((N, H, W), generator=g, device=cuda) - 0.428
    mean = (torch.rand((N, 2, 1, 1), generator=g, device=cuda) * 87 + 33) * (max_base // 128)
    flow = mean + 6 * torch.rand((N, 2, H, W), generator=g, device=cuda) - 3
    flow[1] += 200 * torch.rand((2, H, W), generator=g, device=cuda) - 100  # clamps act
    n0 = n_launches(warp_tiled)
    got = warp_tiled(img, flow[:, 0], flow[:, 1], max_base)
    assert n_launches(warp_tiled) == n0 + 1
    want = warp_tiled_plain(img, flow[:, 0], flow[:, 1], max_base)
    assert float((got - want).abs().max()) <= 1e-5


def test_bilinear_warp_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    img = torch.rand((5, 40, 70), generator=g, device=cuda)
    flow = 40 * torch.rand((5, 2, 40, 70), generator=g, device=cuda) - 20
    n0 = n_launches(bilinear_warp)
    got = bilinear_warp(img, flow[:, 0], flow[:, 1])
    assert n_launches(bilinear_warp) == n0 + 1
    assert float((got - warp_plain(img, flow[:, 0], flow[:, 1])).abs().max()) <= 1e-5


@pytest.mark.parametrize("reach", [48.0, 480.0])
def test_bilinear_warp_kernel_at_training_shape(cuda, reach):
    """K3 where training launches it: a batch of 8 planes of 256x320, from
    the two channels of one flow tensor, with flows beyond the inference
    window (random initial weights give unbounded flows)."""
    img, flow, _ = vjp_inputs(cuda, 8, 256, 320, reach, seed=3)
    n0 = n_launches(bilinear_warp)
    got = bilinear_warp(img, flow[:, 0], flow[:, 1])
    assert n_launches(bilinear_warp) == n0 + 1
    assert float((got - warp_plain(img, flow[:, 0], flow[:, 1])).abs().max()) <= 1e-5


def vjp_inputs(cuda, N, H, W, reach, seed=2):
    g = torch.Generator(device=cuda).manual_seed(seed)
    img = torch.rand((N, H, W), generator=g, device=cuda) - 0.428
    flow = (2 * reach) * torch.rand((N, 2, H, W), generator=g, device=cuda) - reach
    flow[:, :, ::7] = torch.round(flow[:, :, ::7]) + 0.5  # whole pixels
    gout = torch.randn((N, H, W), generator=g, device=cuda)
    return img, flow, gout


@pytest.mark.parametrize("N,H,W,reach", [(8, 256, 320, 48.0), (8, 256, 320, 480.0),
                                           (3, 37, 61, 20.0)])
@pytest.mark.parametrize("need_img", [False, True])
def test_bilinear_warp_vjp_kernel_matches_plain(cuda, N, H, W, reach, need_img):
    img, flow, gout = vjp_inputs(cuda, N, H, W, reach)
    flow = torch.cat([flow, flow], dim=1)[:, 1:3]  # a view: 4 planes between images
    n0 = n_launches(bilinear_warp_vjp)
    gf, gi = bilinear_warp_vjp(img, flow[:, 0], flow[:, 1], gout, need_img)
    assert n_launches(bilinear_warp_vjp) == n0 + 1
    wf, wi = warp_plain_vjp(img, flow[:, 0], flow[:, 1], gout, need_img)
    assert float((gf - wf).abs().max()) <= 1e-6
    if need_img:
        assert float((gi - wi).abs().max()) <= 1e-5 * float(wi.abs().max())
    else:
        assert gi is None


def test_bilinear_warp_fn_on_card_launches_both_kernels(cuda):
    img, flow, gout = vjp_inputs(cuda, 4, 64, 96, 30.0, seed=5)
    flow.requires_grad_()
    n0, m0 = n_launches(bilinear_warp), n_launches(bilinear_warp_vjp)
    out = BilinearWarpFn.apply(img, flow)
    out.backward(gout)
    assert (n_launches(bilinear_warp), n_launches(bilinear_warp_vjp)) == (n0 + 1, m0 + 1)
    want, _ = warp_plain_vjp(img, flow[:, 0].detach(), flow[:, 1].detach(), gout)
    assert float((flow.grad - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("cudnn,grad_tol", [(False, 1e-4), (True, 1e-3)])
def test_train_step_on_card_matches_cpu(no_tf32, monkeypatch, cudnn, grad_tol):
    """cuDNN off: PyTorch's own CUDA convolutions, so the port's losses, K3
    and its VJP are held at tests/test_torch_train.py's tolerances.  cuDNN
    on: its float32 weight gradients of the 5x5 layers are 4.4e-4 of their
    largest off a float64 reference (the CPU's 3.7e-6; H100 80GB HBM3 at
    700 W, torch 2.11.0+cu128), so 1e-3."""
    monkeypatch.setattr(torch.backends.cudnn, "enabled", cudnn)
    import numpy as np

    from v2e_tpu_torch.models import train
    from v2e_tpu_torch.models.convert_ckpt import init_random_slomo_params

    params = init_random_slomo_params(4, base=8)
    rng = np.random.default_rng(7)
    batch = {k: rng.normal(0, 0.3, (2, 1, 64, 96)).astype(np.float32) for k in ("I0", "I1", "It")}
    batch["t"] = rng.uniform(0.1, 0.9, (2,)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        state = train.create_train_state(params=params, device=dev)
        b = train.batch_to(batch, torch.device(dev))
        n0 = n_launches(bilinear_warp_vjp)
        u0, v0 = n_launches(upsample2x), n_launches(upsample2x_vjp)
        loss, metrics = train.slomo_loss(state.flow_net, state.interp_net,
                                         b["I0"], b["I1"], b["It"], b["t"])
        loss.backward()
        if dev == "cuda":
            assert n_launches(bilinear_warp_vjp) == n0 + 6
            # both UNets' five up levels, forward and VJP
            assert (n_launches(upsample2x), n_launches(upsample2x_vjp)) == (u0 + 10, v0 + 10)
        out[dev] = ({k: float(v.detach()) for k, v in metrics.items()},
                    [p.grad.cpu() for net in (state.flow_net, state.interp_net)
                     for p in net.parameters()])
    for k, want in out["cpu"][0].items():
        assert abs(out["cuda"][0][k] - want) <= 1e-5 * abs(want), k
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert float((got - want).abs().max()) <= grad_tol * float(want.abs().max())


def test_kernel_wrappers_check_their_inputs(cuda):
    img = torch.rand((2, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        bilinear_warp(img, img.double(), img)
    with pytest.raises(ValueError):
        bilinear_warp(img, img.transpose(1, 2), img)
    with pytest.raises(ValueError):
        bilinear_warp_vjp(img, img, img, img.double())
    with pytest.raises(ValueError):
        bilinear_warp_vjp(img, img, img[:, :, :4].contiguous(), img)
    with pytest.raises(ValueError):
        warp_tiled(img, img, img.double(), 128)
    with pytest.raises(ValueError):
        scan(img, None, None, img[0].double(), img[0], img[0])


@pytest.fixture
def no_tf32(cuda):
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,h,w,ci,co", [
    (2, 128, 160, 128, 64),  # up4
    (2, 256, 320, 64, 32),   # up5
    (3, 13, 21, 24, 40),     # ragged tiles, Co not a multiple of 16
    (1, 9, 30, 20, 80),      # Ci not a multiple of 8, two channel blocks
])
def test_conv3x3_kernel_matches_plain(no_tf32, dtype, n, h, w, ci, co):
    g = torch.Generator(device=no_tf32).manual_seed(6)
    dt = getattr(torch, dtype)
    x = torch.randn((n, h, w, ci), generator=g, device=no_tf32).to(dt)
    wt = torch.randn((co, ci, 3, 3), generator=g, device=no_tf32) / (9 * ci) ** 0.5
    b = 0.1 * torch.randn((co,), generator=g, device=no_tf32)
    for slope in (0.1, None):
        n0 = n_launches(conv3x3_lane)
        got = conv3x3_lane(x, wt, b, slope)
        assert n_launches(conv3x3_lane) == n0 + 1
        want = conv3x3_lane_plain(x, wt, b, slope)
        assert got.dtype == dt and got.shape == want.shape == (n, h, w, co)
        if dtype == "float32":
            assert float((got.double() - want.double()).abs().max()) <= 1e-5
            continue
        assert_bf16_close(got, want)


def assert_bf16_close(got, want):
    """Every element within one bf16 ulp (1e-5 absolute near zero), at most
    0.5 % of them differing."""
    a, r = got.double(), want.double()
    m = torch.maximum(a.abs(), r.abs())
    tol = torch.clamp(torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8), min=1e-5)
    assert bool(((a - r).abs() <= tol).all())
    assert float((a != r).double().mean()) <= 5e-3


def conv_inputs(cuda, n, h, w, ci, co, seed=6):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((n, h, w, ci), generator=g, device=cuda).to(torch.bfloat16)
    wt = torch.randn((co, ci, 3, 3), generator=g, device=cuda) / (9 * ci) ** 0.5
    b = 0.1 * torch.randn((co,), generator=g, device=cuda)
    return x, wt, b


@pytest.mark.parametrize("n,h,w,ci,co", [
    (96, 128, 160, 128, 64),  # up4 at the interp UNet's batch
    (96, 256, 320, 64, 32),   # up5 at the interp UNet's batch
    (1, 16, 40, 64, 32),      # two work items: fewer than the SMs
    (2, 12, 20, 256, 64),     # 295 KB of weights: streamed, not resident
    (2, 8, 700, 128, 64),     # a wide row: 22 tiles across, the last one ragged
])
def test_conv3x3_bf16_kernel_at_more_shapes(no_tf32, n, h, w, ci, co):
    x, wt, b = conv_inputs(no_tf32, n, h, w, ci, co)
    n0 = n_launches(conv3x3_lane)
    got = conv3x3_lane(x, wt, b)
    assert n_launches(conv3x3_lane) == n0 + 1
    assert_bf16_close(got, conv3x3_lane_plain(x, wt, b))


def test_conv3x3_kernel_unaligned_input(no_tf32):
    x, wt, b = conv_inputs(no_tf32, 2, 24, 40, 64, 32)
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=no_tf32)
    xu = flat[1:1 + x.numel()].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0 and xu.is_contiguous()
    got = conv3x3_lane(xu, wt, b)
    assert torch.equal(got, conv3x3_lane(x, wt, b))
    assert_bf16_close(got, conv3x3_lane_plain(x, wt, b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_conv3x3_packed_cache_matches_fresh_packing(no_tf32, dtype):
    dt = getattr(torch, dtype)
    x, wt, b = conv_inputs(no_tf32, 4, 32, 48, 128, 64)
    x = x.to(dt)
    packed = pack_conv3_weights(wt, dt)
    assert torch.equal(conv3x3_lane(x, wt, b, 0.1, packed=packed), conv3x3_lane(x, wt, b))
    with pytest.raises(ValueError):  # a layout for the other dtype
        conv3x3_lane(x, wt, b, packed=pack_conv3_weights(
            wt, torch.float32 if dtype == "bfloat16" else torch.bfloat16))


def test_conv3x3_wrapper_checks_its_inputs(cuda):
    x = torch.rand((1, 8, 8, 16), device=cuda, dtype=torch.bfloat16)
    wt = torch.rand((32, 16, 3, 3), device=cuda)
    b = torch.rand((32,), device=cuda)
    for bad in (
        (x.half(), wt, b),                          # dtype
        (x.permute(0, 2, 1, 3), wt, b),             # not contiguous NHWC
        (x, wt[:, :8], b),                          # Ci mismatch
        (x, wt[..., :2], b),                        # not 3x3
        (x, wt.cpu(), b),                           # device
        (x, wt, b[:16]),                            # bias shape
    ):
        with pytest.raises(ValueError):
            conv3x3_lane(*bad)


# ---- K6: the UNets' bilinear x2 upsample and its VJP ----

# the UNets' up-level inputs (C, H, W) at base 32 on 256x320 frames
UP_LEVELS = [(512, 8, 10), (512, 16, 20), (256, 32, 40), (128, 64, 80), (64, 128, 160)]
# the five levels at the conversion cells' N (8 flow, 80 refinement images;
# training's 8 are the first), then one row, one column, odd sizes and
# planes that fill no vector (12 channels, 10 or 13 columns)
UP_SHAPES = [(n, c, h, w) for n in (8, 80) for c, h, w in UP_LEVELS] + [
    (3, 16, 1, 40), (3, 16, 40, 1), (2, 12, 7, 13), (2, 12, 6, 10)]
UP_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def up_input(cuda, shape, dtype, channels_last, seed=4):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    return x.contiguous(memory_format=torch.channels_last if channels_last
                        else torch.contiguous_format)


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", UP_DTYPES, ids=str)
@pytest.mark.parametrize("shape", UP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_upsample2x_kernel_matches_plain_and_library(cuda, shape, dtype, channels_last):
    """K6 equals its plain version bit for bit and F.interpolate, in the
    input's layout, to one ulp of a 16-bit output type at the binade of the
    taps' scale, or three float32 ulps (PyTorch's kernel contracts the
    products into FMAs; each of the two is up to 1.5 ulps off the exact
    sum; measured 0 ulps in bf16 and 3 in float32 at training's shapes)."""
    x = up_input(cuda, shape, dtype, channels_last)
    n0 = n_launches(upsample2x)
    got = upsample2x(x)
    assert n_launches(upsample2x) == n0 + 1
    assert torch.equal(got, upsample2x_plain(x))
    want = library(x)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt) and want.is_contiguous(memory_format=fmt)
    n_ulps = 3.0 if dtype == torch.float32 else 1.0
    assert within_ulps(got, want, library(x.abs().to(torch.float64)), dtype, n_ulps)


@pytest.mark.parametrize("dtype", UP_DTYPES, ids=str)
def test_upsample2x_kernel_unaligned_and_strided_input(cuda, dtype):
    """A view 2 bytes off 16-byte alignment takes the kernel's scalar path;
    a transposed view is made contiguous once."""
    base = torch.randn(2 * 64 * 16 * 20 + 1, device=cuda).to(dtype)
    x = base[1:].view(2, 64, 16, 20)
    got = upsample2x(x)
    assert torch.equal(got, upsample2x_plain(x.contiguous()))
    xt = up_input(cuda, (2, 64, 20, 16), dtype, False).transpose(2, 3)
    assert torch.equal(upsample2x(xt), upsample2x_plain(xt.contiguous()))


@pytest.mark.parametrize("shape", UP_SHAPES[:5] + UP_SHAPES[10:],
                         ids=lambda s: "x".join(map(str, s)))
def test_upsample2x_vjp_kernel_matches_plain_and_autograd(cuda, shape):
    """K6's VJP (float32 NCHW, training's form) equals its plain version
    bit for bit and autograd of F.interpolate in float64 within four
    float32 ulps at the scale of the VJP of |gout|."""
    check_upsample2x_vjp(cuda, shape, torch.float32, False)


@pytest.mark.parametrize("dtype,channels_last", [(torch.float32, True),
                                                 (torch.bfloat16, False),
                                                 (torch.float16, True)], ids=str)
def test_upsample2x_vjp_wrapper_converts_other_gradients(cuda, dtype, channels_last):
    """Any other gradient (here also channels_last, as autograd may hand
    it) is copied to float32 NCHW once and the result rounded once to its
    type, in the layout asked for: the plain version's
    answer bit for bit, within one ulp of the output type of autograd."""
    for shape in (UP_SHAPES[1], UP_SHAPES[12]):
        check_upsample2x_vjp(cuda, shape, dtype, channels_last)


def check_upsample2x_vjp(cuda, shape, dtype, channels_last):
    n, c, h, w = shape
    gout = up_input(cuda, (n, c, 2 * h, 2 * w), dtype, channels_last, seed=5)
    n0 = n_launches(upsample2x_vjp)
    got = upsample2x_vjp(gout, channels_last)
    assert n_launches(upsample2x_vjp) == n0 + 1
    assert torch.equal(got, upsample2x_plain_vjp(gout, channels_last))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert got.is_contiguous(memory_format=fmt)
    x = torch.zeros(shape, dtype=torch.float64, device=cuda, requires_grad=True)
    library(x).backward(gout.to(torch.float64))
    scale = upsample2x_plain_vjp(gout.to(torch.float64).abs())
    if dtype == torch.float32:
        assert within_ulps(got, x.grad, scale, torch.float32, 4.0)
    else:
        assert within_ulps(got, x.grad, scale, dtype)


@pytest.mark.parametrize("form", ["dense", "packedz"])
def test_unet_forward_on_card_launches_k6_per_up_level(cuda, monkeypatch, form):
    """One K6 launch per up level, channels_last on the inference path in
    the dense form and on the view K5 leaves in packedz (at base 8, K5
    runs up2 and up3), and the same output as the UNet with the plain
    upsample."""
    from v2e_tpu_torch.models import unet as unet_mod
    from v2e_tpu_torch.models.unet import UNet, unet_apply

    net = UNet(6, 4, base=8).to(cuda)
    net.keep_float32_terms(torch.bfloat16)
    net = net.to(torch.bfloat16)
    x = torch.randn((2, 6, 64, 96), device=cuda)
    n0 = n_launches(upsample2x)
    with torch.no_grad():
        got = unet_apply(net, x, form)
    assert n_launches(upsample2x) == n0 + 5
    monkeypatch.setattr(unet_mod, "Upsample2xFn",
                        type("Plain", (), {"apply": staticmethod(upsample2x_plain)}))
    with torch.no_grad():
        want = unet_apply(net, x, form)
    assert n_launches(upsample2x) == n0 + 5
    assert torch.equal(got, want)


def test_upsample2x_refuses_other_types_and_never_falls_back(cuda):
    n0, v0 = n_launches(upsample2x), n_launches(upsample2x_vjp)
    x = torch.randn((1, 2, 4, 4), device=cuda, dtype=torch.float64)
    for bad in (x, x.to(torch.int32)):
        with pytest.raises(TypeError):
            upsample2x(bad)
        with pytest.raises(TypeError):
            Upsample2xFn.apply(bad)
    with pytest.raises(TypeError):
        upsample2x_vjp(torch.randn((1, 2, 8, 8), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        upsample2x(x[0].float())
    with pytest.raises(ValueError):
        upsample2x_vjp(torch.randn((1, 2, 7, 8), device=cuda))
    assert (n_launches(upsample2x), n_launches(upsample2x_vjp)) == (n0, v0)


# ---- K8: the UNets' conv epilogue (bias, LeakyReLU, skip) on the inference path ----

# (H, W, Co) of the UNets' conv outputs at base 32 on 256x320 frames: conv1
# and conv2, down1..down5, conv3 of the refinement (5) and flow (4) UNets;
# and the up levels' conv1 outputs, which take their skip
EPI_LEVELS = [(256, 320, 32), (128, 160, 64), (64, 80, 128), (32, 40, 256), (16, 20, 512),
              (8, 10, 512), (256, 320, 5), (256, 320, 4)]
EPI_SKIP_LEVELS = [(16, 20, 512), (32, 40, 256), (64, 80, 128), (128, 160, 64),
                   (256, 320, 32)]
EPI_SHAPES = ([(n, h, w, co, False) for n in (8, 80, 96) for h, w, co in EPI_LEVELS]
              + [(n, h, w, co, True) for n in (8, 80, 96) for h, w, co in EPI_SKIP_LEVELS])


def epi_input(cuda, n, h, w, co, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    y = torch.randn((n, h, w, co), generator=g, device=cuda).to(dtype)
    return y.permute(0, 3, 1, 2)  # channels_last [N,Co,H,W]


@pytest.mark.parametrize("dtype", UP_DTYPES, ids=str)
@pytest.mark.parametrize("n,h,w,co,with_skip", EPI_SHAPES,
                         ids=lambda v: str(v) if not isinstance(v, bool) else
                         ("skip" if v else "noskip"))
def test_conv_bias_leaky_kernel_matches_plain(cuda, n, h, w, co, with_skip, dtype):
    """K8 equals its plain version bit for bit at every level the UNets
    launch it at, for the flow (N = 8) and refinement (80, 96) batches;
    the skip slot holds the skip exactly."""
    y = epi_input(cuda, n, h, w, co, dtype, seed=co)
    bias = 0.2 * torch.randn(co, generator=torch.Generator(device=cuda).manual_seed(1),
                             device=cuda)
    skip = epi_input(cuda, n, h, w, co, dtype, seed=co + 1) if with_skip else None
    n0 = n_launches(conv_bias_leaky)
    got = conv_bias_leaky(y, bias, skip)
    assert n_launches(conv_bias_leaky) == n0 + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, conv_bias_leaky_plain(y, bias, skip))
    if with_skip:
        assert torch.equal(got[:, co:], skip)


def test_conv_bias_leaky_refuses_and_never_falls_back(cuda):
    """NCHW, a view not 16-byte aligned and float64 raise, and nothing is
    launched."""
    n0 = n_launches(conv_bias_leaky)
    y = epi_input(cuda, 2, 8, 10, 32, torch.bfloat16, seed=0)
    bias = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError):
        conv_bias_leaky(y.contiguous(), bias)
    base = torch.zeros(2 * 8 * 10 * 32 + 1, device=cuda, dtype=torch.bfloat16)
    off = base[1:].view(2, 8, 10, 32).permute(0, 3, 1, 2)
    assert off.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="aligned"):
        conv_bias_leaky(off, bias)
    with pytest.raises(ValueError, match="aligned"):
        conv_bias_leaky(y, bias, off)
    with pytest.raises(TypeError):
        conv_bias_leaky(y.double(), bias)
    assert n_launches(conv_bias_leaky) == n0


@pytest.mark.parametrize("n,c,h,w", [(80, 32, 256, 320), (96, 64, 128, 160), (8, 512, 16, 20)])
def test_nhwc_pooling_on_card_is_avg_pool2d(cuda, n, c, h, w):
    """The inference path's pooling (a mean over the NHWC view's window axes)
    against F.avg_pool2d in bf16 at the UNets' down levels: within one bf16
    ulp at the window's mean of |x| (the float32 sums of four bf16 terms are
    exact but for terms 2^16 apart; measured bit-equal), channels_last."""
    from v2e_tpu_torch.models.unet import avg_pool2_nhwc

    x = epi_input(cuda, n, h, w, c, torch.bfloat16, seed=c)
    got = avg_pool2_nhwc(x)
    assert got.is_contiguous(memory_format=torch.channels_last)
    scale = torch.nn.functional.avg_pool2d(x.double().abs(), 2)
    err = (got.double() - torch.nn.functional.avg_pool2d(x, 2).double()).abs()
    assert bool((err <= torch.finfo(torch.bfloat16).eps * scale).all())


def test_refinement_forward_runs_k8_and_no_layout_glue(cuda):
    """One bf16 dense refinement forward at N = 80, 256x320 on the
    inference path: 23 K8 launches, one per conv, and no cuDNN layout
    transpose, concatenation or LeakyReLU kernel in its profile."""
    from torch.profiler import ProfilerActivity, profile

    from v2e_tpu_torch.models.convert_ckpt import from_jax_params, init_random_slomo_params

    _, net = from_jax_params(*init_random_slomo_params(seed=0), device=cuda,
                             dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (0.3 * torch.randn((80, 256, 320, 12), generator=g, device=cuda)).to(torch.bfloat16)
    x = x.permute(0, 3, 1, 2)  # as interpolate_pairs stacks it
    with torch.no_grad():
        net(x)
        torch.cuda.synchronize()
        n0 = n_launches(conv_bias_leaky)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = net(x)
            torch.cuda.synchronize()
    assert n_launches(conv_bias_leaky) == n0 + 23
    assert out.shape == (80, 5, 256, 320) and bool(torch.isfinite(out).all())
    names = [e.key for e in prof.key_averages()]
    assert any("conv_bias_leaky" in k for k in names), names
    glue = [k for k in names if any(p in k.lower() for p in (
        "nchwtonhwc", "nhwctonchw", "catarraybatchedcopy", "leaky_relu"))]
    assert not glue, glue


# ---- the emulator's variant paths on the card (no kernel of their own) ----

def variant_configs():
    """SciDVS (fast path, plain loop), CSDVS exact and Euler with the probe
    and every state (per-frame path) and the plain pixel's per-frame path,
    all under the noisy preset."""
    import dataclasses

    from v2e_tpu_torch.emulator.config import EmulatorConfig
    from v2e_tpu_torch.emulator.emulator import MODEL_STATES

    noisy = EmulatorConfig.noisy()
    csdvs = dataclasses.replace(noisy, cs_lambda_pixels=2.0, cs_tau_p_ms=3.0,
                                probe=(48, 32), emit_states=tuple(MODEL_STATES))
    return {
        "scidvs": dataclasses.replace(noisy, scidvs=True, refractory_period_s=5e-4),
        "csdvs": csdvs,
        "csdvs_euler": dataclasses.replace(csdvs, csdvs_solver="euler"),
        "per_frame": dataclasses.replace(noisy, refractory_period_s=5e-4, probe=(3, 4),
                                         emit_states=("diff_frame",)),
    }


def variant_inputs(cfg, F=24, h=64, w=96, seed=6):
    """A moving bar over a texture (linear 0-255) at 1/360 s, the params
    and state from its first frame and the chunk's draws, on the CPU."""
    from v2e_tpu_torch.emulator.core import draw_chunk_noise
    from v2e_tpu_torch.emulator.state import init_state

    g = torch.Generator().manual_seed(seed)
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    tt = torch.arange(F + 1, dtype=torch.float32)[:, None, None]
    bar = (torch.remainder(xx + 0.5 * yy - 3.0 * tt, 96.0) < 10.0).float()
    frames = torch.round(torch.clamp(
        90 + 40 * torch.sin((xx + 0.2 * tt) / 17.0) * torch.cos(yy / 13.0) + 110 * bar
        + 2 * torch.randn((F + 1, h, w), generator=g), 0, 255))
    params, state = init_state(cfg, frames[0], 0.0, g)
    times = torch.arange(1, F + 1, dtype=torch.float32) / 360.0
    return params, state, frames[1:], times, draw_chunk_noise(cfg, F, (h, w), g, "cpu")


def moved(obj, dev):
    import dataclasses

    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(dev)
                                       for f in dataclasses.fields(obj)
                                       if getattr(obj, f.name) is not None})


@pytest.mark.parametrize("name", ["scidvs", "csdvs", "csdvs_euler", "per_frame"])
def test_variant_paths_on_card_match_cpu(cuda, name):
    """The card against the CPU on one set of inputs and draws, at the
    tolerances of test_torch_variants.py (the port against v2e_tpu):
    counts, i0, K, stride equal at >= 99.9 % of pixel-frames; SciDVS
    highpass and base within 1e-6; the Euler surround within 2e-6; the
    probe, the state frames and the rest of the state within 1e-5.  Neither
    K1 nor K2 is launched."""
    from v2e_tpu_torch.emulator.core import emulate_chunk_apply

    cfg = variant_configs()[name]
    params, state, frames, times, draws = variant_inputs(cfg)
    launches = (n_launches(refractory_scan), n_launches(scan))
    (gn, go), (cn, co) = (emulate_chunk_apply(
        cfg, moved(params, d), moved(state, d), frames.to(d), times.to(d),
        {k: (None if v is None else v.to(d)) for k, v in draws.items()})
        for d in (cuda, torch.device("cpu")))
    torch.cuda.synchronize()
    assert (n_launches(refractory_scan), n_launches(scan)) == launches
    assert int(co["ev_count"].abs().sum()) > 1000
    for key in ("ev_count", "i0", "K", "stride"):
        assert float((go[key].cpu() != co[key]).float().mean()) <= 1e-3, key
    tol = {"scidvs_highpass": 1e-6, "base_log_frame": 1e-6 if cfg.scidvs else 1e-5,
           "cs_surround_frame": 2e-6 if cfg.csdvs_solver == "euler" else 1e-5}
    for key in ("base_log_frame", "lp_log_frame", "scidvs_highpass", "cs_surround_frame"):
        if getattr(cn, key) is not None:
            err = float((getattr(gn, key).cpu() - getattr(cn, key)).abs().max())
            assert err <= tol.get(key, 1e-5), (key, err)
    for key, stack in go.get("states", {}).items():
        assert float((stack.cpu() - co["states"][key]).abs().max()) <= 1e-5, key
    if "probe" in go:
        assert float((go["probe"].cpu() - co["probe"]).abs().max()) <= 1e-5


@pytest.mark.parametrize("variant", [{}, {"scidvs": True}], ids=["refractory", "scidvs"])
def test_resume_on_card_equals_continuous_run(cuda, tmp_path, variant):
    """Save after chunk 1, load into a new emulator, run chunk 2: the events,
    counters and state equal the continuous run's bit for bit on the card
    (the CUDA generator's seed and offset travel in the checkpoint); K1
    runs under the noisy preset at R = 0.5 ms, and not under SciDVS."""
    import dataclasses

    import numpy as np

    from v2e_tpu_torch.emulator import EventEmulator
    from v2e_tpu_torch.synthetic import make_source_frames

    src = make_source_frames(33, 64, 96, seed=2).astype(np.float32)
    times = np.arange(33) / 360.0
    ems = []
    for _ in range(2):
        em = EventEmulator(seed=3, device="cuda", **variant)
        em.set_dvs_params("noisy")
        em.cfg = dataclasses.replace(em.cfg, refractory_period_s=5e-4)
        ems.append(em)
    cont, resumed = ems
    k1 = n_launches(refractory_scan)
    cont.generate_events_batch(src[:17], times[:17])
    cont.save_state(str(tmp_path / "c.npz"))
    want = cont.generate_events_batch(src[17:], times[17:])
    resumed.load_state(str(tmp_path / "c.npz"))
    got = resumed.generate_events_batch(src[17:], times[17:])
    assert want is not None and len(want) > 100
    np.testing.assert_array_equal(got, want)
    assert (resumed.num_events_on, resumed.num_events_off) == (
        cont.num_events_on, cont.num_events_off)
    for f in dataclasses.fields(cont.state):
        if getattr(cont.state, f.name) is not None:
            assert torch.equal(getattr(resumed.state, f.name), getattr(cont.state, f.name))
    assert (n_launches(refractory_scan) > k1) == (not variant)


# the synthetic renderers at the sizes of test_torch_synthetic.py:
# (width, height, arg_list, frames)
SYNTHETIC = {
    "moving_dot": (96, 80, ["--t_total", "0.005", "--radius", "30"], None),
    "single_linearly_moving_dot": (96, 64, [], 50),
    "spots": (96, 64, ["--total_time", "0.004"], None),
    "barberpole": (96, 64, ["--total_time", "0.002"], None),
    "gradients": (96, 32, ["--total_time", "0.003"], None),
    "particles": (96, 64, ["--total_time", "0.002", "--num_particles", "40"], None),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_renderers_on_card_match_host(cuda, monkeypatch, name):
    """Each renderer on the card against the port's host generator: the
    uint8-level stimuli equal; particles (float32 centers against the host's
    float64 positions) within 1e-3 (a lost or extra dot would be off by up
    to 31.75), and within two
    float32 ulps of the CPU renderer on the same centers."""
    import importlib

    import numpy as np

    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: real(7))
    w, h, args, n = SYNTHETIC[name]
    cls = getattr(importlib.import_module(f"v2e_tpu_torch.synthetic.{name}"), name)
    host_syn, syn = (cls(width=w, height=h, arg_list=args) for _ in range(2))
    frames, ts = [], []
    for _ in range(host_syn.total_frames() if n is None else n):
        fr, t = host_syn.next_frame()
        frames.append(np.asarray(fr, dtype=np.float32))
        ts.append(t)
    host, ts = np.stack(frames), np.array(ts)
    got = syn.device_frames(ts, cuda)
    assert got.device.type == "cuda" and got.is_contiguous()
    got = got.cpu().numpy()
    if name != "particles":
        np.testing.assert_array_equal(got, host)
        return
    from v2e_tpu_torch.synthetic.device import particles_frames

    np.testing.assert_allclose(got, host, atol=1e-3, rtol=0)
    centers = cls(width=w, height=h, arg_list=args).trajectory(ts)
    args = (w, h, float(syn.fg), float(syn.bg), float(syn.radius), 2.0, 3)
    np.testing.assert_array_max_ulp(particles_frames(centers, *args, device=cuda).cpu().numpy(),
                                    particles_frames(centers, *args, device="cpu").numpy(),
                                    maxulp=2)


@pytest.mark.parametrize("refractory", ["0.0005", "0"], ids=["k1", "k2"])
def test_synthetic_cli_device_path_on_card_matches_cpu(cuda, tmp_path, refractory):
    """The CLI's synthetic device path (frames rendered where the emulator
    runs) on the card and on the CPU, event for event, under the
    deterministic flags (the presets' threshold mismatch comes from the
    device's generator, Philox on the card and the CPU's own, which
    differ), with K1 (0.5 ms refractory period) and with K2."""
    import numpy as np

    from v2e_tpu_torch import cli
    from v2e_tpu_torch.ops.kernels.emulator_scan import refractory_scan as k1, scan as k2

    flags = ["--synthetic_input", "scripts.moving_dot", "--output_width", "96",
             "--output_height", "80", "--cycles", "0.02", "--radius", "30",
             "--dvs_text", "v2e.txt", "--skip_video_output", "--no_shuffle",
             "--sigma_thres", "0", "--leak_rate_hz", "0", "--shot_noise_rate_hz", "0",
             "--cutoff_hz", "0", "--refractory_period", refractory]
    kernel = k1 if refractory != "0" else k2
    before = n_launches(kernel)
    events = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        stats = cli.run(flags + ["-o", str(out)], device=device)
        assert stats.n_frames == 38
        events[device] = np.loadtxt(out / "v2e.txt", comments="#").reshape(-1, 4)
    assert n_launches(kernel) > before
    assert len(events["cpu"]) > 300
    np.testing.assert_array_equal(events["cuda"], events["cpu"])


# ---- several devices: K1 on strips, pixel strips and time segments ----

def card_strips(cuda, n):
    from v2e_tpu_torch.parallel.mesh import Mesh

    return Mesh([[cuda] * n], ("data", "spatial"))


def strip_args(args, S):
    """refractory_scan's arguments cut into S row strips."""
    from v2e_tpu_torch.parallel.mesh import strip_bounds

    rows = lambda x, a, b: x[..., a:b, :].clone(memory_format=torch.contiguous_format)
    return [tuple(rows(x, a, b) for x in args[:7]) + args[7:]
            for a, b in strip_bounds(args[0].shape[1], S)]


@pytest.mark.parametrize("F,H,W,S", [(96, 260, 346, 1), (96, 260, 346, 2), (96, 260, 346, 3),
                                     (96, 261, 346, 3), (96, 260, 346, 8), (7, 21, 17, 8),
                                     (24, 720, 1280, 4)])
def test_refractory_strips_match_plain_and_k1(cuda, F, H, W, S):
    """K1 on S strips of one card (one cooperative launch per strip, each
    frame's K exchanged in pinned host memory) against its plain version
    and against K1 on the whole plane: all equal bit for bit; one launch
    per strip; the strips' grids fit the card together (odd and padded
    shapes, 8 strips, and 720x1280 in the global-state form)."""
    from v2e_tpu_torch.ops.kernels.emulator_scan import (
        _device_grids,
        refractory_scan_strips,
        refractory_scan_strips_plain,
    )

    args = refractory_inputs(cuda, F, H, W, 0.0005)
    strips = strip_args(args, S)
    whole = refractory_scan(*args)
    n0 = n_launches(refractory_scan_strips)
    got = refractory_scan_strips(strips)
    torch.cuda.synchronize()
    assert n_launches(refractory_scan_strips) == n0 + S
    want = refractory_scan_strips_plain(strips)
    grids = _device_grids(tuple(a[0].shape[1] * a[0].shape[2] for a in strips),
                          tuple(a[0].device.index for a in strips))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert all(g.regs for g in grids) == (H * W <= 200_000)
    if grids[0].regs:
        assert sum(g.blocks for g in grids) <= sms
    for name, k in zip(("base", "mem", "counts", "i0"), range(4)):
        g = torch.cat([r[k] for r in got], dim=-2)
        assert torch.equal(g, torch.cat([r[k] for r in want], dim=-2)), name
        assert torch.equal(g, whole[k]), name
    for r in got:
        assert torch.equal(r[4], whole[4])
    assert bool(whole[3].any())


def test_strips_chunk_takes_one_launch_per_strip_and_no_plain(cuda, monkeypatch):
    """A chunk on 3 strips of the card asks for K1 once per strip: one
    launch of the strips' kernel per strip, no plain version of any scan
    and no K1, and the chunk equals the whole plane's."""
    from v2e_tpu_torch.emulator.config import EmulatorConfig
    from v2e_tpu_torch.emulator.core import emulate_chunk_apply
    from v2e_tpu_torch.ops.kernels import emulator_scan as es
    from v2e_tpu_torch.parallel import emulate_chunk_sharded

    cfg = EmulatorConfig(refractory_period_s=0.0005, leak_rate_hz=1.0, shot_noise_rate_hz=2.0)
    params, state, frames, times, draws = (
        moved(x, cuda) if hasattr(x, "__dataclass_fields__") else x
        for x in variant_inputs(cfg))
    frames, times = frames.to(cuda), times.to(cuda)
    draws = {k: (None if v is None else v.to(cuda)) for k, v in draws.items()}
    s1, o1 = emulate_chunk_apply(cfg, params, state, frames, times, draws)

    def refuse(*a, **k):
        raise AssertionError("a plain scan ran")
    for name in ("refractory_scan_plain", "refractory_scan_strips_plain",
                 "refractory_count_plain", "refractory_apply_plain", "scan_plain"):
        monkeypatch.setattr(es, name, refuse)
    n0, k1 = n_launches(es.refractory_scan_strips), n_launches(es.refractory_scan)
    s2, o2 = emulate_chunk_sharded(cfg, card_strips(cuda, 3), params, state, frames, times,
                                   draws=draws)
    torch.cuda.synchronize()
    assert (n_launches(es.refractory_scan_strips) - n0,
            n_launches(es.refractory_scan) - k1) == (3, 0)
    for k in o1:
        assert torch.equal(o1[k], o2[k]), k
    assert torch.equal(s1.base_log_frame, s2.base_log_frame)


def test_strips_missing_participant_raises_within_limit(cuda):
    """One strip launched into an exchange of two, with a 10 ms limit: the
    kernel gives up, the call raises instead of hanging, and the next call
    runs normally."""
    import time

    from v2e_tpu_torch.ops.kernels.emulator_scan import refractory_scan_strips

    args = refractory_inputs(cuda, 8, 40, 64, 0.0005)
    strips = strip_args(args, 2)
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="did not reach the exchange"):
        refractory_scan_strips(strips[:1], timeout_s=0.01, n_strips=2)
    assert time.perf_counter() - t < 5.0
    got = refractory_scan_strips(strips)
    whole = refractory_scan(*args)
    assert torch.equal(torch.cat([r[2] for r in got], dim=1), whole[2])


@pytest.mark.parametrize("name", ["refractory", "k2", "scidvs", "csdvs", "per_frame"])
def test_strips_on_card_equal_one_plane(cuda, name):
    """`emulate_chunk_sharded` over 3 strips of the card equals
    `emulate_chunk_apply` on the whole plane, every output and the state
    bit for bit (K1 on strips, K2 per strip, the SciDVS loop, the CSDVS
    surround gathered, the probe and states)."""
    import dataclasses

    from v2e_tpu_torch.emulator.core import emulate_chunk_apply
    from v2e_tpu_torch.parallel import emulate_chunk_sharded

    configs = dict(variant_configs(), refractory=dataclasses.replace(
        variant_configs()["per_frame"], probe=None, emit_states=()))
    configs["k2"] = dataclasses.replace(configs["refractory"], refractory_period_s=0.0)
    cfg = configs[name]
    params, state, frames, times, draws = (
        moved(x, cuda) if hasattr(x, "__dataclass_fields__") else x
        for x in variant_inputs(cfg))
    frames, times = frames.to(cuda), times.to(cuda)
    draws = {k: (None if v is None else v.to(cuda)) for k, v in draws.items()}
    s1, o1 = emulate_chunk_apply(cfg, params, state, frames, times, draws)
    s2, o2 = emulate_chunk_sharded(cfg, card_strips(cuda, 3), params, state, frames, times,
                                   draws=draws)
    torch.cuda.synchronize()
    for k in o1:
        pairs = [(o1[k][n], o2[k][n]) for n in o1[k]] if k == "states" else [(o1[k], o2[k])]
        for a, b in pairs:
            assert torch.equal(a, b), k
    for f in dataclasses.fields(s1):
        a, b = getattr(s1, f.name), getattr(s2, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


def test_segments_on_card_run_k1_once_each(cuda):
    """`emulate_chunk_segmented` with 4 segments on the card: K1 launched
    once per segment, the events those of the same run on the CPU at
    >= 99.9 % of pixel-frames (the card's and the CPU's log differ by an
    ulp at some levels)."""
    from v2e_tpu_torch.emulator.config import EmulatorConfig
    from v2e_tpu_torch.parallel.convert import emulate_chunk_segmented, make_segment_mesh

    cfg = EmulatorConfig(refractory_period_s=0.0005, leak_rate_hz=0.0, shot_noise_rate_hz=2.0)
    params, state, frames, times, draws = variant_inputs(cfg, F=64)
    outs = []
    for d in (cuda, torch.device("cpu")):
        launches = n_launches(refractory_scan)
        _, o = emulate_chunk_segmented(
            cfg, moved(params, d), moved(state, d), frames.to(d), times.to(d),
            frames[0].to(d).expand(9, *frames.shape[1:]), torch.zeros(9, device=d), 4, 8,
            make_segment_mesh(4, d), {k: (None if v is None else v.to(d))
                                      for k, v in draws.items()})
        outs.append(o)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert n_launches(refractory_scan) - launches == 4
    assert int(outs[1]["ev_count"].abs().sum()) > 1000
    assert float((outs[0]["ev_count"].cpu() != outs[1]["ev_count"]).float().mean()) <= 1e-3
