"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`; each test skips when no CUDA device is present (decided in a
fixture, so every test worker collects the same tests).  On an H100:
    python -m pytest tests/test_torch_kernels_gpu.py -q
Tolerance: K1 counts, i0 and K identical, base and memory within 1e-6; K2
counts identical, base within 1e-6; K3 and K4 within 1e-5.
"""
import pytest
import torch

from v2e_tpu_torch.ops.kernels.emulator_scan import (
    refractory_scan,
    refractory_scan_plain,
    scan,
    scan_plain,
)
from v2e_tpu_torch.ops.kernels.warp import bilinear_warp, warp_plain
from v2e_tpu_torch.ops.kernels.warp_tiled import warp_tiled, warp_tiled_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("R", [0.0, 0.0005])
def test_refractory_scan_kernel_matches_plain(cuda, R):
    g = torch.Generator(device=cuda).manual_seed(0)
    F, H, W = 12, 37, 301
    lp = 4.6 + 0.4 * torch.randn((F, H, W), generator=g, device=cuda)
    pos = 0.2 + 0.03 * torch.rand((H, W), generator=g, device=cuda)
    neg = 0.2 + 0.03 * torch.rand((H, W), generator=g, device=cuda)
    base = lp[0].clone()
    mem = torch.full((H, W), -R, device=cuda)
    dts = torch.full((F,), 1 / 3000.0, device=cuda)
    t_prevs = torch.cumsum(dts, 0) - dts
    leak = 1e-3 * torch.rand((F, H, W), generator=g, device=cuda)
    shot = (torch.rand((F, H, W), generator=g, device=cuda) < 0.01).to(torch.uint8)
    args = (lp, leak, shot, pos, neg, base, mem, dts, t_prevs, R)
    n0 = refractory_scan.launches
    got = refractory_scan(*args)
    want = refractory_scan_plain(*args)
    assert refractory_scan.launches == n0 + 2 * F
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= 1e-6


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
    n0 = scan.launches
    got = scan(*args)
    want = scan_plain(*args)
    assert scan.launches == n0 + 1
    assert torch.equal(got[1], want[1])
    assert int(got[1].abs().sum()) > 1000
    assert float((got[0] - want[0]).abs().max()) <= 1e-6


@pytest.mark.parametrize("max_base", [128, 256])
def test_warp_tiled_kernel_matches_plain(cuda, max_base):
    g = torch.Generator(device=cuda).manual_seed(3)
    N, H, W = 3, 260, 346
    img = torch.rand((N, H, W), generator=g, device=cuda) - 0.428
    mean = (torch.rand((N, 2, 1, 1), generator=g, device=cuda) * 87 + 33) * (max_base // 128)
    flow = mean + 6 * torch.rand((N, 2, H, W), generator=g, device=cuda) - 3
    flow[1] += 200 * torch.rand((2, H, W), generator=g, device=cuda) - 100  # clamps act
    n0 = warp_tiled.launches
    got = warp_tiled(img, flow[:, 0], flow[:, 1], max_base)
    assert warp_tiled.launches == n0 + 1
    want = warp_tiled_plain(img, flow[:, 0], flow[:, 1], max_base)
    assert float((got - want).abs().max()) <= 1e-5


def test_bilinear_warp_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    img = torch.rand((5, 40, 70), generator=g, device=cuda)
    flow = 40 * torch.rand((5, 2, 40, 70), generator=g, device=cuda) - 20
    n0 = bilinear_warp.launches
    got = bilinear_warp(img, flow[:, 0], flow[:, 1], 32)
    assert bilinear_warp.launches == n0 + 1
    assert float((got - warp_plain(img, flow[:, 0], flow[:, 1])).abs().max()) <= 1e-5


def test_kernel_wrappers_check_their_inputs(cuda):
    img = torch.rand((2, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        bilinear_warp(img, img.double(), img, 8)
    with pytest.raises(ValueError):
        bilinear_warp(img, img.transpose(1, 2), img, 8)
    with pytest.raises(ValueError):
        warp_tiled(img, img, img.double(), 128)
    with pytest.raises(ValueError):
        scan(img, None, None, img[0].double(), img[0], img[0])
