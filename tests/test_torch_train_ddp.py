"""Data-parallel SuperSloMo training of the port on the CPU: one group of
two gloo ranks (spawned once for the module) runs

* one step with both UNets replicated (`replicate_state`: DDP) on its
  share of a global batch (`shard_batch`; base 8, 64x96, batch 4), which
  equals one process's step on the whole batch: the loss to 1e-6
  relative, the weights after Adam to 1e-5 of their largest (float32 sums
  in another order: DDP averages the two ranks' gradients);
* `shard_batch`'s refusal of a batch of 3 over 2 ranks;
* `train_slomo.main` inside the group for 2 steps, which writes one
  checkpoint and one npz (rank 0 alone).

The dry run (`python -m v2e_tpu_torch.parallel.dryrun 2 --device cpu`)
starts its own two ranks and prints its summary line.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from v2e_tpu_torch.models import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 4, 64, 96


def global_batch():
    rng = np.random.default_rng(0)
    batch = {k: (0.3 * rng.normal(size=(B, 1, H, W))).astype(np.float32)
             for k in ("I0", "I1", "It")}
    batch["t"] = rng.uniform(0.1, 0.9, (B,)).astype(np.float32)
    return batch


def weights(state):
    return [p.detach().clone() for net in (state.flow_net, state.interp_net)
            for p in train.unwrap(net).parameters()]


def _rank(rank, world, port, out, videos):
    import torch.distributed as dist

    from v2e_tpu_torch.dataset_tools import train_slomo

    torch.set_num_threads(1)
    train.init_ranks("cpu", rank, world, f"tcp://localhost:{port}")
    try:
        state = train.replicate_state(train.create_train_state(seed=0, base=8, device="cpu"))
        state, metrics = train.make_train_step()(state, train.shard_batch(global_batch()))
        try:
            train.shard_batch({k: v[:3] for k, v in global_batch().items()})
            refused = ""
        except ValueError as e:
            refused = str(e)
        if rank == 0:
            torch.save({"loss": metrics["loss"], "weights": weights(state),
                        "refused": refused}, os.path.join(out, "step.pt"))
        train_slomo.main(["-i", videos, "-o", os.path.join(out, "run"), "--steps", "2",
                          "--batch_size", "2", "--crop", "32", "64", "--base", "8",
                          "--log_every", "1"], device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from v2e_tpu_torch.dataset_tools import make_training_videos

    out = tmp_path_factory.mktemp("ddp")
    videos = str(out / "videos")
    assert make_training_videos.main(["-o", videos, "--n_videos", "2", "--frames", "10",
                                      "--size", "48", "80"]) == 0
    mp.spawn(_rank, args=(2, train.free_port(), str(out), videos), nprocs=2)
    return out


def test_ddp_step_equals_one_process(ranks):
    got = torch.load(ranks / "step.pt")
    state = train.create_train_state(seed=0, base=8, device="cpu")
    state, metrics = train.make_train_step()(state, global_batch())
    torch.testing.assert_close(got["loss"], metrics["loss"], rtol=1e-6, atol=0)
    want = weights(state)
    scale = max(float(w.abs().max()) for w in want)
    assert len(got["weights"]) == len(want)
    for a, b in zip(got["weights"], want):
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_shard_batch_refuses_an_uneven_batch(ranks):
    assert "does not split evenly over 2 ranks" in torch.load(ranks / "step.pt")["refused"]


def test_train_slomo_main_over_two_ranks(ranks):
    run = ranks / "run"
    assert os.listdir(run / "ckpt") == ["2"]
    assert os.path.getsize(run / "ckpt" / "2" / "train_state.pt") > 0
    with np.load(run / "slomo_trained.npz") as npz:
        assert len(npz.files) > 10


def test_dryrun_over_two_ranks():
    proc = subprocess.run([sys.executable, "-m", "v2e_tpu_torch.parallel.dryrun", "2",
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip OK on mesh (1, 2)" in proc.stdout
