"""K8's plain version (v2e_tpu_torch/ops/kernels/conv_epilogue.py:
`conv_bias_leaky_plain`) and the UNet's two paths (models/unet.py), on
the CPU.

* The plain version against F.leaky_relu(y + bias, 0.1) computed in
  float32 and rounded once, and against LeakyReLU written out
  (v > 0 ? v : 0.1 v), bit for bit, in bf16, fp16 and float32, at the
  UNets' output widths (5 and 4 fill no 8-channel vector); the skip slot
  holds the skip exactly.
* `UNet.forward`'s inference path (channels_last, the bias-free conv and
  K8's plain version: `UNet._fused`) against its autograd path (NCHW
  nn.Conv2d, LeakyReLU and torch.cat: `UNet._act`), same
  weights, base 8 at 32x64, in every conv form: float32 within 1e-6
  absolute (measured 1.5e-8: the same sums in another layout); bf16 within
  test_torch_unet_forms.py's tolerances, 2e-3 absolute and a mean below
  1e-4 (measured 9.8e-4 and 3.5e-5: the bias added in float32 before one
  rounding, where nn.Conv2d's bf16 conv rounds it in).
* The inference path's 2x2 pooling (`avg_pool2_nhwc`) against
  F.avg_pool2d: within one bf16 ulp, two float32 ulps (another order of
  the window's sum).
* Which path runs: the inference path when autograd records nothing
  (grad mode off, or neither x nor a parameter requiring grad).
The kernel itself runs only on the card (tests/test_torch_kernels_gpu.py).
"""
import pytest
import torch
import torch.nn.functional as F

from v2e_tpu_torch import tracing
from v2e_tpu_torch.models import unet as unet_mod
from v2e_tpu_torch.models.convert_ckpt import from_jax_params, init_random_slomo_params
from v2e_tpu_torch.models.train import create_train_state
from v2e_tpu_torch.models.unet import UNet, unet_form
from v2e_tpu_torch.ops.kernels.conv_epilogue import conv_bias_leaky, conv_bias_leaky_plain

DTYPES = [torch.bfloat16, torch.float16, torch.float32]
COS = [4, 5, 32, 64, 512]
FORMS = ("dense", "packedz", "fold", "fold45")


def nhwc(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = 0.5 * torch.randn(shape, generator=g)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("with_skip", [False, True], ids=["bias_act", "with_skip"])
@pytest.mark.parametrize("co", COS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_is_leaky_relu_of_the_float32_sum_rounded_once(dtype, co, with_skip):
    y = nhwc((2, co, 5, 7), dtype, seed=co)
    bias = 0.3 * torch.randn(co, generator=torch.Generator().manual_seed(1))
    skip = nhwc((2, co, 5, 7), dtype, seed=co + 1) if with_skip else None
    got = conv_bias_leaky(y, bias, skip)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == (2, 2 * co if with_skip else co, 5, 7)
    v = y.float() + bias[:, None, None]
    want = F.leaky_relu(v, 0.1).to(dtype)
    assert torch.equal(got[:, :co], want)
    assert torch.equal(got[:, :co], torch.where(v > 0, v, v * 0.1).to(dtype))
    assert torch.equal(conv_bias_leaky_plain(y, bias, skip), got)
    if with_skip:
        assert torch.equal(got[:, co:], skip)


def test_plain_counts_no_launch():
    before = tracing.counters().get("launch.k8", 0)
    conv_bias_leaky(nhwc((1, 8, 4, 4), torch.float32, 0), torch.zeros(8))
    assert tracing.counters().get("launch.k8", 0) == before


def test_wrapper_refuses_other_layouts_and_biases():
    y = nhwc((2, 8, 4, 6), torch.bfloat16, 0)
    b = torch.zeros(8)
    with pytest.raises(ValueError, match="channels_last"):
        conv_bias_leaky(y.contiguous(), b)
    with pytest.raises(ValueError, match="channels_last"):
        conv_bias_leaky(y, b, y.contiguous())
    with pytest.raises(ValueError, match="bias"):
        conv_bias_leaky(y, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bias"):
        conv_bias_leaky(y, torch.zeros(4))
    with pytest.raises(ValueError, match="match"):
        conv_bias_leaky(y, b, y.float().contiguous(memory_format=torch.channels_last))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("n,c,h,w", [(2, 32, 16, 20), (3, 5, 4, 6), (1, 64, 2, 2)])
def test_nhwc_pooling_is_avg_pool2d(n, c, h, w, dtype):
    """The inference path's pooling: F.avg_pool2d's window mean, channels_last.
    In ulps of the output type at the scale of the window's mean of |x|:
    bf16 within one (the float32 sums of four bf16 terms are exact here),
    float32 within two (the sums' order differs; each is within one of the
    exact mean, measured 0.85 and 1.0)."""
    x = nhwc((n, c, h, w), dtype, seed=c)
    got = unet_mod.avg_pool2_nhwc(x)
    want = F.avg_pool2d(x, 2)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    scale = F.avg_pool2d(x.double().abs(), 2)
    n_ulps = 2.0 if dtype == torch.float32 else 1.0
    eps = torch.finfo(dtype).eps
    assert bool(((got.double() - want.double()).abs() <= n_ulps * eps * scale).all())


@pytest.fixture(scope="module")
def nets():
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        flow, interp = from_jax_params(*init_random_slomo_params(seed=5, base=8), "cpu", dtype)
        out[dtype] = {"interp": interp, "flow": flow}
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["interp", "flow"])
@pytest.mark.parametrize("form", FORMS)
def test_inference_path_matches_autograd_path(nets, form, which, dtype):
    net = nets[getattr(torch, dtype)][which]
    x = torch.randn((2, net.in_ch, 32, 64), generator=torch.Generator().manual_seed(7))
    got = unet_mod.unet_apply(net, x, form)
    assert got.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = net._walk(x.to(getattr(torch, dtype)), unet_form(form),
                         *net._path(autograd=True)).float()
    err = (got - want).abs()
    if dtype == "float32":
        assert float(err.max()) <= 1e-6
    else:
        assert float(err.max()) <= 2e-3 and float(err.mean()) <= 1e-4


def test_the_path_follows_grad_mode_and_requires_grad(monkeypatch):
    net = UNet(2, 4, base=8)
    calls = []
    walk = UNet._walk
    monkeypatch.setattr(UNet, "_walk", lambda self, x, form, block, *a:
                        calls.append(block.__name__) or walk(self, x, form, block, *a))

    def path(x, grad=True, inference=False):
        calls.clear()
        if inference:
            with torch.inference_mode():
                net(x)
        else:
            with torch.set_grad_enabled(grad):
                net(x)
        return {"_act": "autograd", "_fused": "nhwc"}[calls[0]]

    x = torch.randn((1, 2, 32, 32))
    assert path(x) == "autograd"  # a fresh module's parameters require grad
    assert path(x, grad=False) == "nhwc"
    assert path(x, inference=True) == "nhwc"
    net.requires_grad_(False)
    assert path(x) == "nhwc"
    assert path(x.clone().requires_grad_()) == "autograd"
    assert path(x.clone().requires_grad_(), grad=False) == "nhwc"
    net.conv3.bias.requires_grad_(True)
    assert path(x) == "autograd"


def test_inference_weights_are_channels_last_and_training_weights_are_not():
    flow, interp = from_jax_params(*init_random_slomo_params(seed=0, base=8), "cpu",
                                   torch.bfloat16)
    state = create_train_state(seed=0, base=8, device="cpu")
    for net in (flow, interp):
        for p in net.parameters():
            assert not p.requires_grad
            if p.dim() == 4:
                assert p.is_contiguous(memory_format=torch.channels_last)
    for net in (state.flow_net, state.interp_net):
        for p in net.parameters():
            assert p.requires_grad and p.is_contiguous()
