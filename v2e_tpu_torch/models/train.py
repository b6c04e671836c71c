"""SuperSloMo training (port of v2e_tpu/models/train.py): the Super-SloMo
losses and one optimizer step, on one device or data-parallel over the
ranks of a `torch.distributed` process group.

Losses follow the Super-SloMo paper (Jiang et al., CVPR 2018), as the JAX
package computes them: reconstruction L1, warping L1 and the flows' total
variation (no perceptual term).  The UNets run in float32 in the dense
form; the six backwarps of a loss go through `backwarp_grad` (K3 forward,
its VJP kernel backward on the card).  Adam is `torch.optim.Adam` with
optax.adam's defaults (betas 0.9 and 0.999, eps 1e-8).

On the card cuDNN runs float32 convolutions in TF32 unless
`torch.backends.cudnn.allow_tf32` is off; the caller chooses.

Several devices: `replicate_state` wraps both UNets in
DistributedDataParallel over the default process group, one process per
rank, and `shard_batch` gives each rank its equal share of the global
batch.  DDP averages the ranks' gradients, which equals the gradient of
the global batch's mean loss when the shares are equal, the JAX package's
loss; so `shard_batch` refuses a batch that does not divide.  The JAX
package also splits the images' rows over a second mesh axis, which
XLA's partitioner does for free; here that would need a halo exchange in
every convolution, so the port splits the batch only (ROADMAP, "No
counterpart, by design").
"""
from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from v2e_tpu_torch import tracing
from v2e_tpu_torch.device import resolve_device
from v2e_tpu_torch.models.backwarp import backwarp_grad
from v2e_tpu_torch.models.convert_ckpt import (
    NpParams,
    from_jax_params,
    init_random_slomo_params,
)
from v2e_tpu_torch.models.unet import UNet, unet_apply

LAMBDA_R = 204.0
LAMBDA_W = 102.0
LAMBDA_S = 1.0

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    flow_net: UNet  # or a DistributedDataParallel of one, after replicate_state
    interp_net: UNet
    optimizer: torch.optim.Adam
    step: int = 0
    replicated: bool = False


def unwrap(net: torch.nn.Module) -> UNet:
    """The UNet inside a DistributedDataParallel (or the UNet itself)."""
    return net.module if isinstance(net, DistributedDataParallel) else net


def rank_device(device, rank: int):
    """The device of `rank`: card rank mod the visible cards for "cuda",
    else `device` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_ranks(device, rank: int, world: int, init_method: str):
    """Join the process group as `rank` of `world` on `device`'s rank
    device (`rank_device`): NCCL when every rank has a card of its own,
    gloo when ranks share a device (NCCL refuses two ranks on one card).
    Returns the rank's device."""
    dev = rank_device(device, rank)
    own_cards = (dev.type == "cuda" and torch.device(device).index is None
                 and world <= torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if own_cards else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    return dev


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def replicate_state(state: TrainState) -> TrainState:
    """The state replicated over the ranks of the default process group:
    both UNets wrapped in DistributedDataParallel, which broadcasts rank
    0's weights at once and averages the ranks' gradients in every
    backward.  The optimizer keeps its parameters (DDP wraps the same
    tensors).  Each rank then takes its share of every batch
    (`shard_batch`)."""
    state.flow_net = DistributedDataParallel(state.flow_net)
    state.interp_net = DistributedDataParallel(state.interp_net)
    state.replicated = True
    return state


def shard_batch(batch: Dict) -> Dict:
    """This rank's equal share of a global batch (arrays or tensors with the
    batch first), by rank order; raises when the batch does not divide by
    the default process group's size."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = len(next(iter(batch.values())))
    if n % world:
        raise ValueError(f"a batch of {n} does not split evenly over {world} ranks")
    share = n // world
    return {k: v[rank * share: (rank + 1) * share] for k, v in batch.items()}


def create_train_state(
    seed: int = 0,
    learning_rate: float = 1e-4,
    base: int = 32,
    device: Optional[str] = None,
    params: Optional[Tuple[NpParams, NpParams]] = None,
) -> TrainState:
    """Trainable float32 UNets and their Adam optimizer, on "cuda" unless
    `device` names another.  The weights are `params` (flow, interp trees
    in the JAX package's layout, e.g. from `load_slomo_params`; their width
    wins over `base`) or seeded random ones of width `base`."""
    if params is None:
        params = init_random_slomo_params(seed, base)
    flow_net, interp_net = from_jax_params(*params, resolve_device(device), torch.float32)
    # training's convs run NCHW: its weights back in that layout
    nets = tuple(net.to(memory_format=torch.contiguous_format).requires_grad_(True).train()
                 for net in (flow_net, interp_net))
    opt = torch.optim.Adam(
        [p for net in nets for p in net.parameters()],
        lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
    )
    return TrainState(nets[0], nets[1], opt)


def _tv(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 1:, :] - x[..., :-1, :]).abs().mean() + (
        x[..., :, 1:] - x[..., :, :-1]
    ).abs().mean()


def slomo_loss(
    flow_net: UNet,
    interp_net: UNet,
    I0: torch.Tensor,
    I1: torch.Tensor,
    It: torch.Tensor,
    t: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Super-SloMo training loss for a batch of (I0, It, I1) triples.

    I0, I1, It: [B,1,H,W] normalized frames; t: [B] intermediate time of It
    in (0,1).  Returns (loss, {"loss", "l_r", "l_w", "l_s"}).
    """
    flow_out = unet_apply(flow_net, torch.cat([I0, I1], dim=1))
    F01 = flow_out[:, :2]
    F10 = flow_out[:, 2:]
    tb = t[:, None, None, None]

    tmp = -tb * (1.0 - tb)
    F_t_0 = tmp * F01 + (tb * tb) * F10
    F_t_1 = ((1.0 - tb) * (1.0 - tb)) * F01 + tmp * F10
    g0 = backwarp_grad(I0, F_t_0)
    g1 = backwarp_grad(I1, F_t_1)
    intrp = unet_apply(
        interp_net, torch.cat([I0, I1, F01, F10, F_t_1, F_t_0, g1, g0], dim=1)
    )
    F_t_0_f = intrp[:, 0:2] + F_t_0
    F_t_1_f = intrp[:, 2:4] + F_t_1
    V0 = torch.sigmoid(intrp[:, 4:5])
    V1 = 1.0 - V0
    g0f = backwarp_grad(I0, F_t_0_f)
    g1f = backwarp_grad(I1, F_t_1_f)
    w0 = (1.0 - tb) * V0
    w1 = tb * V1
    It_pred = (w0 * g0f + w1 * g1f) / (w0 + w1 + 1e-8)

    l_r = (It_pred - It).abs().mean()
    l_w = (
        (backwarp_grad(I1, F01) - I0).abs().mean()
        + (backwarp_grad(I0, F10) - I1).abs().mean()
        + (g0 - It).abs().mean()
        + (g1 - It).abs().mean()
    )
    l_s = _tv(F01) + _tv(F10)
    loss = LAMBDA_R * l_r + LAMBDA_W * l_w + LAMBDA_S * l_s
    return loss, {"loss": loss, "l_r": l_r, "l_w": l_w, "l_s": l_s}


def batch_to(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors ("I0", "I1", "It", "t") as
    float32 tensors on `device`."""
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
            for k, v in batch.items()}


def make_train_step():
    """The training step: `train_step(state, batch) -> (state, metrics)`,
    one Adam update of both UNets on the batch's loss.  The state is
    updated in place; the metrics are detached 0-d tensors on the device,
    averaged over the ranks when the state is replicated (the global
    batch's, as each rank's share is equal)."""

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with tracing.root("step", state.step):
            return step(state, batch)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        dev = next(state.flow_net.parameters()).device
        with tracing.span("step.upload", tracing.WAIT):
            b = batch_to(batch, dev)
        state.optimizer.zero_grad(set_to_none=True)
        with tracing.span("step.forward", tracing.DEVICE, dev):
            loss, metrics = slomo_loss(
                state.flow_net, state.interp_net, b["I0"], b["I1"], b["It"], b["t"]
            )
        with tracing.span("step.backward", tracing.DEVICE, dev):
            loss.backward()
        with tracing.span("step.adam", tracing.DEVICE, dev):
            state.optimizer.step()
        state.step += 1
        metrics = {k: m.detach() for k, m in metrics.items()}
        if state.replicated:
            values = torch.stack(list(metrics.values()))
            dist.all_reduce(values)
            values /= dist.get_world_size()
            metrics = dict(zip(metrics, values))
        return state, metrics

    return train_step
