"""Train / fine-tune the SuperSloMo interpolator on a folder of videos, on
the card (port of dataset_tools/train_slomo.py).

Samples (I0, It, I1) triplets from videos, optimizes the Super-SloMo losses
(v2e_tpu_torch/models/train.py: K3 and its VJP kernel for the six
backwarps of each loss, cuDNN for the UNets, torch.optim.Adam), and
checkpoints with torch.save: ``<out>/ckpt/<step>/train_state.pt`` holds
both UNets' state dicts, the optimizer's and the step.  At the end the
weights are exported to ``<out>/slomo_trained.npz`` in the layout the JAX
package's tool writes, so --slomo_model loads them in both packages.
--init_from warm-starts the weights (the optimizer starts afresh) from a
.ckpt, an .npz or such a checkpoint.

Like the JAX tool it trains on every visible card, data-parallel: run as
one process, it spawns one process per rank (--devices, by default one
per card; ranks beyond the cards share them, and on the CPU N ranks share
it); called inside a process group a caller set up, it trains as this
process's rank.  The backend is NCCL when every rank has a card of its
own and gloo when ranks share a device.  Every rank samples the global
batch from the same seed and keeps its share (models/train.py:
shard_batch), so the ranks train on the batches one process would; rank
0 alone logs, checkpoints and exports the npz.

Usage:
  python -m v2e_tpu_torch.dataset_tools.train_slomo -i /data/videos \\
      -o slomo-run --steps 10000 --batch_size 8 --crop 256 320 --gap 2
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from v2e_tpu_torch import tracing

logger = logging.getLogger(__name__)

CKPT_FILE = "train_state.pt"


class TripletSampler:
    """Random (I0, It, I1) triplets from a set of videos.

    Frames I0 and I1 are `gap+1` apart; It is one of the interior frames at
    fractional time t (the Super-SloMo training regime).  The same seed
    gives the JAX package's sampler's batches.
    """

    def __init__(self, videos: List[str], crop, gap: int, seed: int = 0):
        import cv2

        self.videos = videos
        self.crop_h, self.crop_w = crop
        self.gap = gap
        self.rng = np.random.default_rng(seed)
        self._cv2 = cv2
        self._cache_path = None
        self._cache_frames = None
        self._batches = 0  # batches sampled: the next one's id in its span

    def _load(self, path: str) -> np.ndarray:
        if path == self._cache_path:
            return self._cache_frames
        cap = self._cv2.VideoCapture(path)
        frames = []
        while True:
            ret, fr = cap.read()
            if not ret:
                break
            frames.append(self._cv2.cvtColor(fr, self._cv2.COLOR_BGR2GRAY))
        cap.release()
        self._cache_path = path
        self._cache_frames = np.stack(frames) if frames else np.zeros((0, 1, 1))
        return self._cache_frames

    def sample_batch(self, batch_size: int):
        self._batches += 1
        with tracing.root("sampler", self._batches - 1):
            return self._sample(batch_size)

    def _sample(self, batch_size: int):
        from v2e_tpu_torch.models.slomo import MEAN

        I0 = np.empty((batch_size, 1, self.crop_h, self.crop_w), np.float32)
        I1 = np.empty_like(I0)
        It = np.empty_like(I0)
        t = np.empty((batch_size,), np.float32)
        n = 0
        while n < batch_size:
            path = self.videos[self.rng.integers(len(self.videos))]
            frames = self._load(path)
            if frames.shape[0] < self.gap + 2:
                continue
            H, W = frames.shape[1:]
            if H < self.crop_h or W < self.crop_w:
                continue
            s = int(self.rng.integers(0, frames.shape[0] - self.gap - 1))
            k = int(self.rng.integers(1, self.gap + 1))
            y = int(self.rng.integers(0, H - self.crop_h + 1))
            x = int(self.rng.integers(0, W - self.crop_w + 1))
            sl = (slice(y, y + self.crop_h), slice(x, x + self.crop_w))
            I0[n, 0] = frames[s][sl]
            It[n, 0] = frames[s + k][sl]
            I1[n, 0] = frames[s + self.gap + 1][sl]
            t[n] = k / (self.gap + 1)
            n += 1
        I0 = I0 / 255.0 - MEAN
        I1 = I1 / 255.0 - MEAN
        It = It / 255.0 - MEAN
        return {"I0": I0, "I1": I1, "It": It, "t": t}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input_dir", required=True,
                   help="directory tree of training videos")
    p.add_argument("-o", "--output_dir", default="slomo-train")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--crop", type=int, nargs=2, default=[256, 320],
                   help="training crop (multiples of 32)")
    p.add_argument("--gap", type=int, default=2,
                   help="frames between I0 and I1 minus one")
    p.add_argument("--init_from", default=None,
                   help="warm start from a SuperSloMo .ckpt/.npz or a checkpoint "
                        "this tool wrote (<out>/ckpt/<step>)")
    p.add_argument("--base", type=int, default=32,
                   help="UNet width scale (32 = reference SuperSloMo "
                        "architecture; smaller trains/ships a reduced-width "
                        "model, e.g. the committed golden fixture)")
    p.add_argument("--export_dtype", default="float32",
                   choices=["float32", "float16"],
                   help="npz export precision (float16 halves fixture size; "
                        "weights are restored to f32 at load)")
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--extensions", nargs="+", default=[".avi", ".mp4", ".mov"])
    p.add_argument("--devices", type=int, default=None,
                   help="ranks to train over, one process each (default: one per "
                        "visible card; on the CPU, 1); --batch_size is the global "
                        "batch and must divide by it")
    return p.parse_args(argv)


def load_init_params(path: str):
    """(flow, interp) parameter trees from a .ckpt, an .npz, or a checkpoint
    of this tool (its directory or its file)."""
    from v2e_tpu_torch.models.convert_ckpt import _state_to_params, load_slomo_params

    if path.endswith((".npz", ".ckpt")):
        return load_slomo_params(path)
    import torch

    if os.path.isdir(path):
        path = os.path.join(path, CKPT_FILE)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return _state_to_params(ckpt["flow"]), _state_to_params(ckpt["interp"])


def save_checkpoint(path: str, state) -> None:
    import torch

    from v2e_tpu_torch.models.train import unwrap

    os.makedirs(path, exist_ok=True)
    torch.save({
        "flow": unwrap(state.flow_net).state_dict(),
        "interp": unwrap(state.interp_net).state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
    }, os.path.join(path, CKPT_FILE))


@dataclass
class TrainRun:
    """What `run` did: the steps and samples trained, the wall seconds of
    the training loop, the last step's metrics, the checkpoints and the
    exported npz."""
    steps: int
    samples: int
    wall_s: float
    metrics: Dict[str, float]
    npz: str
    checkpoints: List[str]


def run(argv=None, device=None) -> Optional[TrainRun]:
    """Train as the command line asks, on "cuda" unless `device` names
    another; None when the input holds no video.  Inside an initialized
    process group this process trains as its rank; otherwise --devices > 1
    spawns that many ranks and returns rank 0's result."""
    args = parse_args(argv)
    import torch
    import torch.distributed as dist

    from v2e_tpu_torch.device import resolve_device
    from v2e_tpu_torch.models.train import free_port

    dev = resolve_device(device)
    n = args.devices
    if n is None:
        n = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    if dist.is_initialized() or n <= 1:
        return _train(args, dev)
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    logger.info(f"training on {n} ranks")
    # rank 0's result is a few hundred bytes, below a pipe's buffer, so its
    # put returns before this process reads it and the join cannot wait on it
    mp.spawn(_rank_main, args=(n, free_port(), argv, str(dev), queue), nprocs=n)
    return queue.get()


def _rank_main(rank: int, world: int, port: int, argv, device: str, queue) -> None:
    """One spawned rank: join the group, train, hand rank 0's result back."""
    import torch.distributed as dist

    from v2e_tpu_torch.models.train import init_ranks

    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING)
    dev = init_ranks(device, rank, world, f"tcp://localhost:{port}")
    try:
        result = run(argv, dev)
        if rank == 0:
            queue.put(result)
    finally:
        dist.destroy_process_group()


def _train(args, dev) -> Optional[TrainRun]:
    """The training loop of this process, rank-aware when a process group
    is initialized."""
    import torch.distributed as dist

    from v2e_tpu_torch.dataset_tools.batch_convert import find_videos
    from v2e_tpu_torch.models.convert_ckpt import save_slomo_npz, to_jax_params
    from v2e_tpu_torch.models.train import (
        create_train_state,
        make_train_step,
        replicate_state,
        shard_batch,
        unwrap,
    )

    world = dist.get_world_size() if dist.is_initialized() else 1
    lead = not dist.is_initialized() or dist.get_rank() == 0
    videos = find_videos(args.input_dir, set(args.extensions))
    if not videos:
        logger.error(f"no videos found under {args.input_dir}")
        return None
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} does not divide over {world} ranks")
    logger.info(f"training on {len(videos)} videos")
    os.makedirs(args.output_dir, exist_ok=True)

    params = load_init_params(args.init_from) if args.init_from else None
    state = create_train_state(args.seed, args.learning_rate, args.base, dev, params)
    if args.init_from:
        logger.info(f"warm-started from {args.init_from}")
    if world > 1:
        state = replicate_state(state)
        logger.info(f"data-parallel over {world} ranks ({dist.get_backend()})")

    train_step = make_train_step()
    sampler = TripletSampler(videos, args.crop, args.gap, args.seed)
    ckpt_dir = os.path.abspath(os.path.join(args.output_dir, "ckpt"))
    checkpoints = []

    t0 = time.time()
    metrics = {}
    for step in range(1, args.steps + 1):
        batch = sampler.sample_batch(args.batch_size)
        if world > 1:
            batch = shard_batch(batch)
        state, metrics = train_step(state, batch)
        if step % args.log_every == 0 and lead:
            m = {k: float(v) for k, v in metrics.items()}
            rate = step * args.batch_size / (time.time() - t0)
            logger.info(
                f"step {step}: loss={m['loss']:.4f} "
                f"l_r={m['l_r']:.4f} l_w={m['l_w']:.4f} "
                f"l_s={m['l_s']:.4f} ({rate:.1f} samples/s)"
            )
        if (step % args.checkpoint_every == 0 or step == args.steps) and lead:
            path = os.path.join(ckpt_dir, str(step))
            save_checkpoint(path, state)
            checkpoints.append(path)
            logger.info(f"checkpointed to {path}")
    wall = time.time() - t0
    logger.info(f"{args.steps} steps in {wall:.2f} s")

    out_npz = os.path.join(args.output_dir, "slomo_trained.npz")
    if lead:
        # also export a portable npz loadable by --slomo_model
        out_npz = save_slomo_npz(
            out_npz, *to_jax_params(unwrap(state.flow_net), unwrap(state.interp_net)),
            dtype=args.export_dtype,
        )
        logger.info(f"exported trained weights to {out_npz}")
    return TrainRun(args.steps, args.steps * args.batch_size, wall,
                    {k: float(v) for k, v in metrics.items()}, out_npz, checkpoints)


def main(argv=None, device=None) -> int:
    logging.basicConfig(level=logging.INFO)
    return 0 if run(argv, device) is not None else 1


if __name__ == "__main__":
    sys.exit(main())
