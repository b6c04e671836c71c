"""The benchmark's core: it finds a cell, its configuration and its metric
readers by name, runs the cell's runner once, and prints the result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Files, each found by the name BENCHMARK.json gives it:
* portbench/cells/<cell>.json: the traffic (a `source` for traffic.py),
  the runner (runners/<runner>.py), the run's shape and the limits of its
  correctness check;
* portbench/configs/<config>.json: the model and pixel configuration;
* portbench/metrics/<metric>.py: `read(run) -> value or None` for each
  metric, end-to-end or per-layer; None leaves the metric out of the line.

A runner's `run(run)` sets up the program, warms up the cell's shapes,
measures for `run.seconds`, and fills `run`: the window, the host ranges,
the trace, the counts, and `run.checks`, the numbers its correctness
check compared, each with its limit.  With --trace 0 the line carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics and the
`breakdown`.

The run refuses (exit 1, no result) without CUDA or with fewer cards than
the cell asks for, and when jax, jaxlib, flax or the JAX package v2e_tpu is
loaded in this process once the window has closed (module names compared
by their first dotted part, whole).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "v2e_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_file(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "portbench", "cells", name + ".json"))


def config_file(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "portbench", "configs", name + ".json"))


def metric_reader(name: str, root: str = ROOT):
    """The `read` function of portbench/metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def runner_module(name: str):
    return importlib.import_module(f"portbench.runners.{name}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def process_start_ns() -> int:
    """This process's start on the perf_counter clock (from /proc)."""
    now_perf = time.perf_counter_ns()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now_perf
    return now_perf - int(age * 1e9)


@dataclass
class Run:
    """One run of one cell: its inputs, and what the runner measured."""

    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    tmpdir: str
    t_process_ns: int
    window_start_ns: int = 0
    window_end_ns: int = 0
    host: object = None  # trace.HostRanges
    trace_data: object = None  # trace.TraceData
    counts: Dict[str, float] = field(default_factory=dict)
    records: Dict[str, list] = field(default_factory=dict)
    checks: Dict[str, dict] = field(default_factory=dict)  # name -> {value, limit}
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0

    @property
    def window_s(self) -> float:
        return (self.window_end_ns - self.window_start_ns) / 1e9

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: str = ROOT, cell: Optional[dict] = None, config: Optional[dict] = None,
             t_process_ns: Optional[int] = None) -> Run:
    """Run `cell_name` once and return the filled `Run`.  `cell` and
    `config` replace the files' contents (the tests run small copies on
    the CPU)."""
    from portbench.trace import HostRanges

    cell = cell if cell is not None else cell_file(cell_name, root)
    config = config if config is not None else config_file(cell["config"], root)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    run = Run(cell_name, cell, config, int(seed), float(seconds), bool(trace), device, tmp,
              t_process_ns if t_process_ns is not None else process_start_ns(), host=HostRanges())
    try:
        runner_module(cell["runner"]).run(run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return run


def result_line(run: Run, bench: dict, root: str = ROOT) -> dict:
    """The last line's JSON object."""
    metrics = {}
    for m in cell_metrics(bench, run.cell_name, run.trace):
        value = metric_reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": device_name(run.device), "count": 1,
              "memory_peak_bytes": int(run.memory_peak_bytes),
              "power_limit": power_limit(run.device)}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.trace_data is not None:
        from portbench.trace import breakdown

        device["busy_s"] = run.trace_data.busy_s()
        device["window_s"] = run.trace_data.window_s
        out["breakdown"] = breakdown(run.trace_data, run.host)
    out["checks"] = run.checks
    return out


def device_name(device: str) -> str:
    if device != "cuda":
        return device
    import torch

    return torch.cuda.get_device_name(0)


def power_limit(device: str) -> str:
    """nvidia-smi's name and power limit of the card, printed beside the
    numbers (a card set below 700 W runs slower)."""
    if device != "cuda":
        return "not measured"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not
    load (compared whole: v2e_tpu_torch is not v2e_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_process = process_start_ns()
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    bench = spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        print(f"unknown workload {a.workload!r}; one of {sorted(cells)}", file=sys.stderr)
        return 2
    import torch

    need = int(cells[a.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    run = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", t_process_ns=t_process)
    bad = forbidden_modules()
    if bad:
        print(f"refused: this process loaded {bad}", file=sys.stderr)
        return 1
    line = result_line(run, bench)
    print("counts " + json.dumps(run.counts, default=str), file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
