"""Readings that set each check's upper limit: the controls (the reference
put in the program's place and computed one precision lower) and, for the
training cell, the planted faults.  Run on the card at the cell's size:

    python3 portbench/controls.py --workload <cell> --seeds 1 2 3

and kept as tests: at a small size on the CPU (tests/test_portbench_faults.py)
and at the cell's size on the card (tests/test_portbench_gpu.py).

Conversion cells: the control's UNets run in float8 e4m3 (the
configuration states bfloat16) and its pixel model in bfloat16 (float32
stated); it converts the cell's first chunks, and the same comparisons the
run makes (runners/convert.py) read it against the float32 / float64
reference.  Training: the control trains in bfloat16 (float32 with TF32
stated); the faults are planted in the reference put in the program's
place: half of each batch left out (the loss's mean over the other half),
and one sample's target frame replaced by its first frame (an answer
altered where the sampler produces it).  A step that returns its state
unchanged reads 1 in change_gap by the measure and needs no run.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np


def convert_readings(cell: dict, config: dict, seed: int, device: str, chunks: int = 4) -> dict:
    import torch

    from portbench import traffic
    from portbench.runners.convert import Shape, emulator_seed
    from portbench.reference.emulator import PixelArray, PixelConfig
    from portbench.reference.slomo import interpolate_chunk
    from portbench.weights import make_slomo_weights

    dev = torch.device(device)
    H, W = int(config["height"]), int(config["width"])
    src = traffic.make_source(cell["source"], H, W, seed)
    shape = Shape(cell, config, src.frame_interval)
    px = dict(config["dvs"])
    px.update(cell.get("pixel", {}))
    pc = PixelConfig.from_dict(px)
    ctrl = PixelArray(pc, emulator_seed(seed), dev, torch.bfloat16)
    ref = PixelArray(pc, emulator_seed(seed), dev)
    weights = (make_slomo_weights(seed, int(config["base"]), dev, getattr(torch, config["unet_dtype"]))
               if shape.slomo else None)
    frames_err, frames_n = [], int(cell["check"].get("frame_chunks", 0))
    diff = total = 0
    bad = n_state = 0
    for c in range(chunks):
        src_c = torch.from_numpy(np.stack([src.frame(i) for i in shape.src_frames(c)])).to(dev)
        times = shape.times(c)
        if shape.slomo:
            frames = interpolate_chunk(*weights, src_c, shape.U, "fp8")
            if len(frames_err) < frames_n:
                want = interpolate_chunk(*weights, src_c, shape.U, "f32")
                frames_err.append(float((frames - want).abs().mean()))
        else:
            frames = src_c
        if c == 0:
            ctrl.start(frames[0], float(times[0]))
            ref.start(frames[0], float(times[0]))
            frames, times = frames[1:], times[1:]
        else:
            # the reference follows the control's state, as it follows the
            # program's at a checked chunk
            ref.load(ctrl.base.float(), ctrl.lp.float(), ctrl.mem, 0.0, ctrl.t_prev)
        c_on, c_off = ctrl.run_chunk(frames, times)
        r_on, r_off = ref.run_chunk(frames, times)
        diff += int((c_on - r_on).abs().sum() + (c_off - r_off).abs().sum())
        total += int(r_on.sum() + r_off.sum())
        if c > 0:
            m = ((ref.base - ctrl.base.double()).abs() > 1e-3) | ((ref.lp - ctrl.lp.double()).abs() > 1e-3)
            bad += int(m.sum())
            n_state += m.numel()
    out = {"events_mismatch": diff / max(total, 1), "state_mismatch": bad / max(n_state, 1)}
    if shape.slomo:
        out["frames_mean_abs_dn"] = float(np.mean(frames_err))
    return out


def train_readings(cell: dict, config: dict, seed: int, device: str) -> dict:
    """{"control": ..., "half_batch": ..., "altered_target": ...}: each the
    training check's three gaps of that stand-in against the reference."""
    import torch

    from portbench import traffic
    from portbench.runners.train import leaf_gap
    from portbench.reference import train as rt
    from portbench.weights import make_slomo_weights

    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="portbench-controls-")
    try:
        clips = traffic.training_clips(os.path.join(tmp, "clips"), cell["clips"], seed)
        frames = [rt.decode_gray(p) for p in clips]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from portbench.runners.train import WARM_STEPS

    batch, warm = int(config["batch_size"]), WARM_STEPS
    batches = rt.sample_batches(frames, tuple(config["crop"]), int(config["gap"]), seed, batch, warm)
    weights = make_slomo_weights(seed, int(config["base"]), dev, torch.float32)
    lr = float(config["learning_rate"])
    ref = rt.train(*weights, batches, lr, dev)
    half = [{k: v[: batch // 2] for k, v in b.items()} for b in batches]
    altered = []
    for b in batches:
        b = {k: v.copy() for k, v in b.items()}
        b["It"][0] = b["I0"][0]
        altered.append(b)
    stand_ins = {"control": rt.train(*weights, batches, lr, dev, "bf16"),
                 "half_batch": rt.train(*weights, half, lr, dev),
                 "altered_target": rt.train(*weights, altered, lr, dev)}
    keys = sorted(ref["grad1"])
    gnorm = {k: float(ref["grad1"][k].double().norm()) for k in keys}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in keys if gnorm[k] >= 1e-3 * med]
    ref_change = {k: ref["params"][k] - ref["params0"][k] for k in keys}
    out = {}
    for name, r in stand_ins.items():
        change = {k: r["params"][k] - r["params0"][k] for k in keys}
        out[name] = {
            "loss1_gap": abs(r["loss"][0]["loss"] - ref["loss"][0]["loss"]) / abs(ref["loss"][0]["loss"]),
            "grad1_gap": leaf_gap(r["grad1"], ref["grad1"], keys),
            "change_gap": leaf_gap(change, ref_change, moved),
            "grad1_rel": (sum(float((r["grad1"][k] - ref["grad1"][k]).double().pow(2).sum()) for k in keys)
                          / sum(float(ref["grad1"][k].double().pow(2).sum()) for k in keys)) ** 0.5,
        }
    return out


def readings(cell_name: str, seed: int, device: str, cell=None, config=None) -> dict:
    from portbench import bench

    cell = cell if cell is not None else bench.cell_file(cell_name)
    config = config if config is not None else bench.config_file(cell["config"])
    if cell["runner"] == "train":
        return train_readings(cell, config, seed, device)
    return {"control": convert_readings(cell, config, seed, device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    for seed in a.seeds:
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "readings": readings(a.workload, seed, a.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
