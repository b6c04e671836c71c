"""The port's CLI with --unet_conv packedz (K5 on the UNets' up tail) and
--unet_conv packedfold45 (the folded upsample+conv on up4 and up5) against
the JAX package's CLI with the same flags, on the CPU.

The input, the golden SuperSloMo fixture (base 8: packedz sends up2 and up3
of both UNets to K5) and the deterministic emulator flags are those of
test_torch_cli.py, at a fixed U=7 and --cutoff_hz 0; the JAX CLI runs its
lane conv kernel in Pallas interpret mode (v2e_tpu/models/unet.py:241),
as its own tests run it on the CPU.  Tolerances are test_torch_cli.py's:
total events within 0.1 %, per-pixel ON and OFF counts by at most one
event at no more than 1 % of the pixels, first and last event times within
one interpolated frame (bf16 roundings move events to a neighbouring
interpolated frame).
"""
import numpy as np
import pytest

import v2e_tpu_torch.ops.kernels.conv3 as tconv3
from test_torch_cli import (  # noqa: F401 (frames_dir is a fixture)
    FIXED_U7,
    FPS,
    N_FRAMES,
    RTOL_EVENTS,
    assert_pixel_counts_close,
    common_args,
    events,
    frames_dir,
)
from v2e_tpu.cli import main as jax_main
from v2e_tpu_torch import cli

U = 7


@pytest.mark.parametrize("form", ["packedz", "packedfold45"])
def test_cli_unet_conv_matches_jax(frames_dir, tmp_path, monkeypatch, form):
    plain_calls = []
    plain = tconv3.conv3x3_lane_plain
    monkeypatch.setattr(tconv3, "conv3x3_lane_plain",
                        lambda x, w, *a: plain_calls.append((tuple(x.shape), w.shape[0]))
                        or plain(x, w, *a))
    flags = FIXED_U7 + ["--unet_conv", form]
    assert jax_main(common_args(frames_dir, tmp_path / "jax") + flags) == 0
    stats = cli.run(common_args(frames_dir, tmp_path / "port") + flags, device="cpu")

    assert stats.upsampling == [U, U, U]
    assert (stats.staged_chunks, stats.fused_chunks) == (1, 2)
    if form == "packedz":
        # up2 (Ci 128 -> 64) and up3 (64 -> 32) of the flow and the interp
        # UNet in each of the three windows
        assert {(s[3], co) for s, co in plain_calls} == {(128, 64), (64, 32)}
        assert len(plain_calls) == 3 * 2 * 4
    else:
        assert not plain_calls

    a, b = events(tmp_path / "jax"), events(tmp_path / "port")
    assert len(a) > 5000
    assert abs(len(a) - len(b)) <= RTOL_EVENTS * len(a)
    assert stats.num_events == len(b)
    assert_pixel_counts_close(a, b, 0.01)
    frame = 1.0 / (FPS * U)
    assert abs(a[0, 0] - b[0, 0]) <= frame and abs(a[-1, 0] - b[-1, 0]) <= frame
    assert stats.n_frames == (N_FRAMES - 1) * U
    assert np.isfinite(b).all()
