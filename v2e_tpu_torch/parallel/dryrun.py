"""Multi-device dry run (port of v2e_tpu/parallel/dryrun.py):

    python -m v2e_tpu_torch.parallel.dryrun [N] [--device cpu]

Runs the three multi-device paths once at a small size: one data-parallel
SuperSloMo training step over N ranks (`torch.distributed`, one spawned
process per rank; base 8, 32x32 frames, a global batch of 2N), the
emulator's chunk in pixel strips over `make_mesh(N)`'s spatial axis, and
the segmented conversion over N segments.  On the card by default: the
ranks, strips and segments take the visible cards in turn (ranks sharing
a card talk over gloo); `--device cpu` runs everything on the CPU.  Prints
the JAX dry run's summary line, `dryrun_multichip OK on mesh (d, s) ...`.
"""
from __future__ import annotations

import argparse
import sys
import time


def _progress(msg: str, t0: float) -> None:
    print(f"# dryrun +{time.monotonic() - t0:7.1f}s  {msg}", flush=True)


def _train_rank(rank: int, world: int, port: int, device: str, queue) -> None:
    """One rank's training step; rank 0 hands the loss back."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from v2e_tpu_torch.models.train import (
        create_train_state,
        init_ranks,
        make_train_step,
        replicate_state,
        shard_batch,
    )

    dev = init_ranks(device, rank, world, f"tcp://localhost:{port}")
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    try:
        state = replicate_state(create_train_state(seed=0, base=8, device=dev))
        rng = np.random.default_rng(0)
        B, H, W = 2 * world, 32, 32
        batch = {k: rng.normal(size=(B, 1, H, W)).astype(np.float32) for k in ("I0", "I1", "It")}
        batch["t"] = rng.uniform(0.1, 0.9, (B,)).astype(np.float32)
        state, metrics = make_train_step()(state, shard_batch(batch))
        if rank == 0:
            queue.put(float(metrics["loss"]))
    finally:
        dist.destroy_process_group()


def run(n_devices: int, device=None) -> str:
    """The dry run on `n_devices` ranks, strips and segments; returns the
    summary line."""
    t0 = time.monotonic()
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from v2e_tpu_torch.device import resolve_device
    from v2e_tpu_torch.emulator.config import EmulatorConfig
    from v2e_tpu_torch.emulator.state import init_state
    from v2e_tpu_torch.models.train import free_port, rank_device
    from v2e_tpu_torch.parallel.convert import dryrun_segments
    from v2e_tpu_torch.parallel.mesh import emulate_chunk_sharded, make_mesh

    dev = resolve_device(device)
    devices = [rank_device(dev, i) for i in range(n_devices)]
    mesh = make_mesh(devices=devices)
    d, s = mesh.devices.shape
    _progress(f"mesh {mesh}", t0)

    queue = mp.get_context("spawn").SimpleQueue()  # one float: the join cannot wait on it
    mp.spawn(_train_rank, args=(n_devices, free_port(), str(dev), queue), nprocs=n_devices)
    loss = queue.get()
    assert np.isfinite(loss)
    _progress(f"train step OK over {n_devices} ranks (loss {loss:.3f})", t0)

    cfg = EmulatorConfig(sigma_thres=0.03, leak_rate_hz=0.1, shot_noise_rate_hz=1.0)
    rng = np.random.default_rng(0)
    F, EH, EW = 4, 16 * s, 32
    frames = torch.from_numpy(rng.uniform(0, 255, (F, EH, EW)).astype(np.float32)).to(mesh.lead)
    gen = torch.Generator(device=mesh.lead).manual_seed(0)
    params, state = init_state(cfg, frames[0], 0.0, gen)
    times = torch.arange(1, F + 1, dtype=torch.float32, device=mesh.lead) / 100.0
    _, outs = emulate_chunk_sharded(cfg, mesh, params, state, frames, times, gen)
    assert tuple(outs["ev_count"].shape) == (F, EH, EW)
    n_events = int((outs["num_on"] + outs["num_off"]).sum())
    _progress(f"pixel strips OK ({s} strips)", t0)

    seg_events = dryrun_segments(n_devices, dev)
    _progress("segment-parallel conversion OK", t0)
    return (f"dryrun_multichip OK on mesh {(d, s)} (train loss {loss:.3f}, "
            f"{n_events} events, segment-parallel events {seg_events})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    print(run(args.n_devices, args.device), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
