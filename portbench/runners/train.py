"""The training cell: the port's train_slomo loop (TripletSampler's batch,
then make_train_step()'s Adam step on both UNets) over the cell's seeded
clips.

Set-up writes the clips (traffic.training_clips) under the run's temporary
directory, makes the float32 weights from the seed (weights.py), builds the
training state with create_train_state and drives it through its first
WARM_STEPS steps through the same sampler and step the window runs.  The
window then runs the loop until `seconds` have passed, waits for the card,
and closes.  Host ranges "sampler" and "step" are recorded around each
call; with --trace the profiler records the device for TRACE_SECONDS.

Correctness, from the warm-up steps: the reference (reference/train.py,
float32 with TF32 off) samples the same batches from the decoded clips and
trains from the same weights.  Compared:
* loss1_gap: the relative gap of the first step's loss (the later steps'
  losses follow parameters that Adam's sign-sized first steps move 2 lr
  apart wherever a gradient is nought to rounding, PERF.md);
* grad1_gap: per leaf, the gap between the norms of the first gradient (the
  program's from Adam's first moment after one step, m / 0.1), over the
  larger of the leaf's reference norm and the median leaf's; the worst
  leaf;
* change_gap: the same for the parameters' change after the warm-up steps,
  over the leaves whose reference gradient is at least 1e-3 of the median
  leaf's (leaves with a gradient nought to rounding move under Adam by
  round-off alone);
* grad1_rel: the norm of the difference of the first gradients over the
  norm of the reference's, all leaves as one vector: first order in the
  arithmetic's error, where the gaps of norms are second order, so it
  tells TF32 from bfloat16, which the gaps do not (PERF.md).
"""
from __future__ import annotations

import os
import time

import numpy as np

from portbench import traffic
from portbench.trace import TRACE_SECONDS, Profile

# the steps set-up drives the training state through, which the reference follows
WARM_STEPS = 3


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over the larger of its
    reference norm and the median leaf's."""
    import torch

    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys)


def run(run) -> None:
    import torch

    from portbench.weights import make_slomo_weights, numpy_trees

    cfg = run.config
    dev = torch.device(run.device)
    base, batch, lr = int(cfg["base"]), int(cfg["batch_size"]), float(cfg["learning_rate"])
    crop, gap = tuple(cfg["crop"]), int(cfg["gap"])
    warm = WARM_STEPS
    clips = traffic.training_clips(os.path.join(run.tmpdir, "clips"), run.cell["clips"], run.seed)
    flow_w, interp_w = make_slomo_weights(run.seed, base, dev, torch.float32)

    from v2e_tpu_torch.dataset_tools.train_slomo import TripletSampler
    from v2e_tpu_torch.models.train import create_train_state, make_train_step

    state = create_train_state(run.seed, lr, base, dev, numpy_trees(flow_w, interp_w))
    train_step = make_train_step()
    sampler = TripletSampler(clips, crop, gap, run.seed)
    host = run.host
    sample = host.wrap("sampler", sampler.sample_batch)
    step = host.wrap("step", train_step)
    leaves = {f"{net}/{n}": p for net, m in (("flow", state.flow_net), ("interp", state.interp_net))
              for n, p in m.named_parameters()}
    start = {k: p.detach().clone() for k, p in leaves.items()}

    loss1, grad1 = None, None
    for i in range(warm):
        state, metrics = step(state, sample(batch))
        if i == 0:  # Adam's first moment after one step is 0.1 g (none if it never stepped)
            loss1 = float(metrics["loss"])
            grad1 = {k: state.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - 0.9)
                     for k, p in leaves.items()}
    change = {k: p.detach() - start[k] for k, p in leaves.items()}
    del start

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    prof = Profile(dev.type) if run.trace else None
    if prof is not None:
        prof.start()  # before the window: its start-up is slow
    sync()
    run.window_start_ns = ws = time.perf_counter_ns()
    if prof is not None:
        prof.start_ns = ws
    steps = 0
    while True:
        state, metrics = step(state, sample(batch))
        steps += 1
        now = time.perf_counter_ns()
        if prof is not None and not prof.end_ns and now - ws >= TRACE_SECONDS * 1e9:
            sync()  # the traced steps' device work, inside the trace
            prof.stop()
        if now - ws >= run.seconds * 1e9:
            break
    sync()
    run.window_end_ns = time.perf_counter_ns()
    if prof is not None:
        prof.stop()
        run.trace_data = prof.reduce()
    last = float(metrics["loss"])
    run.attempted = steps
    run.failed = 0 if np.isfinite(last) else 1
    run.counts.update(steps=steps, samples=steps * batch, batch=batch, crop=crop, base=base)
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del state, metrics, leaves, sampler
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    check(run, clips, flow_w, interp_w, loss1, grad1, change, crop, gap, batch, lr, warm, dev)
    run.counts["check_s"] = time.perf_counter() - t


def check(run, clips, flow_w, interp_w, loss1, grad1, change, crop, gap, batch, lr, warm, dev,
          precision: str = "f32") -> None:
    from portbench.reference import train as ref_train

    frames = [ref_train.decode_gray(p) for p in clips]
    batches = ref_train.sample_batches(frames, crop, gap, run.seed, batch, warm)
    ref = ref_train.train(flow_w, interp_w, batches, lr, dev, precision)
    keys = sorted(ref["grad1"])
    loss1_gap = abs(loss1 - ref["loss"][0]["loss"]) / abs(ref["loss"][0]["loss"])
    gnorm = {k: float(ref["grad1"][k].double().norm()) for k in keys}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in keys if gnorm[k] >= 1e-3 * med]
    ref_change = {k: ref["params"][k] - ref["params0"][k] for k in keys}
    limits = run.cell["check"]["limits"]
    run.checks["loss1_gap"] = {"value": loss1_gap, "limit": limits["loss1_gap"]}
    run.checks["grad1_gap"] = {"value": leaf_gap(grad1, ref["grad1"], keys),
                               "limit": limits["grad1_gap"]}
    run.checks["change_gap"] = {"value": leaf_gap(change, ref_change, moved),
                                "limit": limits["change_gap"]}
    num = sum(float((grad1[k].double() - ref["grad1"][k].double()).pow(2).sum()) for k in keys)
    den = sum(float(ref["grad1"][k].double().pow(2).sum()) for k in keys)
    run.checks["grad1_rel"] = {"value": (num / den) ** 0.5, "limit": limits["grad1_rel"]}
    run.counts["leaves_compared"] = len(moved)
    run.counts["leaves"] = len(keys)
