"""The port's SuperSloMo training tools (v2e_tpu_torch/dataset_tools:
make_training_videos, train_slomo, eval_slomo_ckpt) against the
repository's (dataset_tools/, scripts/eval_slomo_ckpt.py), on the CPU.

The clip renderer and the triplet sampler are numpy copies: equal bit for
bit from the same seed.  The trained weights export to the npz layout both
packages load.  The held-out PSNR of the golden fixture is within 0.05 dB
of the JAX script's (both in the default bf16 compute; measured 0.00 dB
apart).
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import dataset_tools.make_training_videos as jax_videos
import dataset_tools.train_slomo as jax_train_tool
from test_torch_train import one_torch_thread  # noqa: F401 (autouse fixture)
from v2e_tpu.models.convert_ckpt import load_slomo_params as jax_load
from v2e_tpu_torch.dataset_tools import eval_slomo_ckpt, make_training_videos, train_slomo
from v2e_tpu_torch.dataset_tools.batch_convert import find_videos
from v2e_tpu_torch.models.convert_ckpt import load_slomo_params
from v2e_tpu_torch.models.slomo import SuperSloMo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "slomo_golden.npz")


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("vids")
    assert make_training_videos.main(["-o", str(d), "--n_videos", "2", "--frames", "10",
                                      "--size", "64", "96", "--seed", "3"]) == 0
    return str(d)


@pytest.mark.parametrize("kind", ["texture", "blobs", "bar"])
def test_render_clip_matches(kind):
    a = make_training_videos.render_clip(kind, 5, 40, 56, np.random.default_rng(9))
    b = jax_videos.render_clip(kind, 5, 40, 56, np.random.default_rng(9))
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


def test_triplet_sampler_matches(videos):
    paths = find_videos(videos, {".avi"})
    assert len(paths) == 2
    ours = train_slomo.TripletSampler(paths, (32, 64), 2, seed=5)
    theirs = jax_train_tool.TripletSampler(paths, (32, 64), 2, seed=5)
    for _ in range(3):
        a, b = ours.sample_batch(3), theirs.sample_batch(3)
        for k in ("I0", "I1", "It", "t"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def trained(videos, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    argv = ["-i", videos, "-o", out, "--steps", "2", "--batch_size", "2", "--crop", "32", "64",
            "--base", "8", "--log_every", "1", "--checkpoint_every", "1"]
    assert train_slomo.main(argv, device="cpu") == 0
    return out


def test_train_writes_checkpoints_and_npz(trained):
    for step in ("1", "2"):
        ckpt = torch.load(os.path.join(trained, "ckpt", step, train_slomo.CKPT_FILE),
                          weights_only=True)
        assert ckpt["step"] == int(step)
        assert set(ckpt) == {"flow", "interp", "optimizer", "step"}
    assert os.path.isfile(os.path.join(trained, "slomo_trained.npz"))


def test_npz_loads_in_both_packages(trained):
    npz = os.path.join(trained, "slomo_trained.npz")
    for ours, theirs in zip(load_slomo_params(npz), jax_load(npz)):
        assert set(ours) == set(theirs)
        for layer in ours:
            for k in ("w", "b"):
                np.testing.assert_array_equal(ours[layer][k], np.asarray(theirs[layer][k]))
    # the last checkpoint holds the exported weights
    from_ckpt = train_slomo.load_init_params(os.path.join(trained, "ckpt", "2"))
    for a, b in zip(from_ckpt, load_slomo_params(npz)):
        for layer in a:
            np.testing.assert_array_equal(a[layer]["w"], b[layer]["w"])
    slomo = SuperSloMo(npz, upsampling_factor=2, batch_size=1, device="cpu")
    assert slomo.flow_net.base == 8
    frames = np.random.default_rng(0).uniform(0, 255, (2, 32, 64)).astype(np.float32)
    out, U = slomo.interpolate_batch(frames, 32, 64)
    assert U == 2 and out.shape == (2, 32, 64) and bool(torch.isfinite(out).all())


def test_init_from_own_checkpoint_and_npz(trained, videos, tmp_path):
    for src in (os.path.join(trained, "ckpt", "2"), os.path.join(trained, "slomo_trained.npz")):
        out = str(tmp_path / os.path.basename(src))
        argv = ["-i", videos, "-o", out, "--steps", "1", "--batch_size", "1", "--crop", "32",
                "64", "--base", "32", "--init_from", src]
        run = train_slomo.run(argv, device="cpu")
        assert run.steps == 1 and np.isfinite(run.metrics["loss"])
        assert load_slomo_params(run.npz)[0]["conv1"]["w"].shape[0] == 8  # width from src


def test_no_videos_exits_1(tmp_path):
    assert train_slomo.main(["-i", str(tmp_path), "-o", str(tmp_path / "o")], device="cpu") == 1


def test_eval_matches_the_jax_script(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_eval_slomo_ckpt", os.path.join(REPO, "scripts", "eval_slomo_ckpt.py"))
    jax_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_eval)
    monkeypatch.setattr("sys.argv", ["eval_slomo_ckpt.py", GOLDEN])
    assert jax_eval.main() == 0
    want = capsys.readouterr().out
    assert eval_slomo_ckpt.main([GOLDEN], device="cpu") == 0
    got = capsys.readouterr().out
    psnr = [[float(x) for x in re.findall(r"([0-9.]+) dB", text)[:2]] for text in (want, got)]
    assert abs(psnr[1][0] - psnr[0][0]) <= 0.05, (want, got)
    assert abs(psnr[1][1] - psnr[0][1]) <= 1e-9
    assert psnr[1][0] > psnr[1][1] + 1.0
    assert got.splitlines()[0] == want.splitlines()[0]
