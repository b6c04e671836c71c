"""The yardstick's counts: UNet FLOPs against a FLOP counter run over the
port's UNet, and the kernels' bytes against PERF.md's bounds."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import yardstick as ys


@pytest.mark.parametrize("io", [ys.FLOW_IO, ys.INTERP_IO])
def test_unet_flops_match_a_counter_over_the_port(io):
    from v2e_tpu_torch.models.unet import UNet, unet_conv_specs

    base, h, w = 8, 64, 96
    assert [(n, ci, co, k) for n, ci, co, k, _ in ys.unet_layers(*io, base)] == \
        list(unet_conv_specs(*io, base))
    net = UNet(*io, base)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(1, io[0], h, w))
    convs = sum(v for k, v in counter.get_flop_counts()["Global"].items()
                if "convolution" in str(k))
    assert ys.unet_forward_flops(*io, h, w, base) == convs


def test_unet_flops_by_hand():
    # conv1 of the flow UNet at base 32 on 256x320: 2 * 2 * 32 * 49 * 81920
    layers = ys.unet_layers(*ys.FLOW_IO, 32)
    assert layers[0] == ("conv1", 2, 32, 7, 0)
    assert layers[-1] == ("conv3", 32, 4, 3, 0)
    assert ("up1.conv2", 1024, 512, 3, 4) in layers
    one = 2 * 2 * 32 * 49 * 256 * 320
    total = ys.unet_forward_flops(*ys.FLOW_IO, 256, 320)
    assert total > one and ys.slomo_chunk_flops(8, 10, 256, 320) == \
        8 * total + 80 * ys.unet_forward_flops(*ys.INTERP_IO, 256, 320)


@pytest.mark.parametrize("nbytes,want_ms", [
    (ys.k1_bytes(160, 260, 346), 0.0565),  # PERF.md's kernel table, K1 at the fused chunk
    (ys.k1_bytes(768, 260, 346), 0.2688),  # run A's F
    (ys.k1_bytes(64, 260, 346), 0.0230),  # run F's 64, 63, 12
    (ys.k1_bytes(63, 260, 346), 0.0226),
    (ys.k1_bytes(12, 260, 346), 0.0048),
    (ys.k2_bytes(96, 260, 346), 0.0288),  # K2, noisy
    (ys.k2_bytes(96, 720, 1280), 0.2949),
    (ys.k2_bytes(96, 260, 346, noisy=False), 0.0159),
    (ys.k3_bytes(160, 256, 320), 0.0626),  # K3 at N=160
])
def test_kernel_bounds_match_the_kernel_table(nbytes, want_ms):
    assert ys.bound_s(nbytes) * 1e3 == pytest.approx(want_ms, abs=6e-5)


def test_warp_planes_of_a_chunk():
    # two warp passes of I0 and I1 per pair and time: K3's two N=160 launches at U=10
    assert ys.slomo_warp_planes(8, 10) == 2 * 160
