"""Host ranges the benchmark records around its calls into the program,
and the reduction of a torch.profiler trace of the card to busy time,
kernel time by name and idle gaps.

`HostRanges` keeps (name, start, end) in perf_counter ns from any thread.
`Profile` runs torch.profiler over part of the window; its `reduce` turns
the device activity (kernels, copies, sets) inside the traced window into
`TraceData`: the intervals, the union's length (busy), the idle gaps each
labelled by the host range open at its middle, and kernel time by name.
The profiler records device activity only (no host operators, whose
recording would slow the host-bound cells); its timestamps are wall-clock
ns, tied to perf_counter by reading both clocks at its start.
"""
from __future__ import annotations

import re
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# seconds of the window the profiler records in a traced run, from its start
TRACE_SECONDS = 4.0



class HostRanges:
    """Named host-clock ranges, appended from any thread."""

    def __init__(self):
        self.ranges: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        with self._lock:
            self.ranges.append((name, start_ns, end_ns))

    def wrap(self, name: str, fn):
        """`fn` with each call recorded as a range named `name`."""
        def wrapper(*args, **kwargs):
            t = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, t, time.perf_counter_ns())
        return wrapper

    def durations_ms(self, name: str, start_ns: int, end_ns: int) -> List[float]:
        """Durations of the ranges named `name` that start in [start, end)."""
        return [(e - s) / 1e6 for n, s, e in self.ranges if n == name and start_ns <= s < end_ns]


@dataclass
class TraceData:
    start_ns: int  # perf_counter ns
    end_ns: int
    intervals: List[Tuple[int, int, str, str]] = field(default_factory=list)  # start, end, kind, name

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def union(self) -> List[Tuple[int, int]]:
        spans = sorted((max(s, self.start_ns), min(e, self.end_ns)) for s, e, _, _ in self.intervals)
        out: List[List[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e9

    def kernels(self, pattern: Optional[str] = None) -> List[Tuple[int, int, str]]:
        """Kernel intervals inside the window, by a substring of the name."""
        return [(s, e, n) for s, e, k, n in self.intervals
                if k == "kernel" and s >= self.start_ns and e <= self.end_ns
                and (pattern is None or pattern in n)]

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for s, e, k, n in self.intervals:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e > s:
                out[n] += (e - s) / 1e9
        return dict(out)

    def gaps(self) -> List[Tuple[int, int]]:
        u = self.union()
        edges = [self.start_ns] + [x for se in u for x in se] + [self.end_ns]
        pairs = list(zip(edges[0::2], edges[1::2]))
        return [(s, e) for s, e in pairs if e > s]


def short_name(name: str) -> str:
    """A kernel's name without its namespaces, template and argument
    lists: the function's own name, and the first functor named inside its
    template arguments (elementwise kernels differ only there)."""
    if name.startswith(("_Z", "Memcpy", "Memset")):
        return name[:80]
    stem = name.replace("(anonymous namespace)::", "")
    stem = stem[5:] if stem.startswith("void ") else stem
    cut = min([i for i in (stem.find("<"), stem.find("(")) if i >= 0], default=len(stem))
    base = stem[:cut].split("::")[-1] or stem[:80]
    inner = (re.findall(r"\w+(?:Functor|_functor)\w*", stem[cut:])
             or re.findall(r"\w+_kernel\w*", stem[cut:]))
    return f"{base}[{inner[-1]}]" if inner and inner[-1] != base else base


def label_at(ranges: List[Tuple[str, int, int]], t_ns: int) -> str:
    """The names of the host ranges open at `t_ns`, joined with '+', or
    'none'."""
    names = sorted({n for n, s, e in ranges if s <= t_ns < e})
    return "+".join(names) if names else "none"


def breakdown(trace: TraceData, host: HostRanges, n: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps with the host range open in each."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, sec in trace.seconds_by_name().items():
        by_name[short_name(name)] += sec
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:n]
    return {
        "device_ops": [[name, sec] for name, sec in ops],
        "idle_gaps": [[label_at(host.ranges, (s + e) // 2), (e - s) / 1e9] for s, e in gaps],
    }


class Profile:
    """torch.profiler over a part of the window (start, then stop)."""

    def __init__(self, device_type: str):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if device_type == "cuda" else [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self.start_ns = self.end_ns = 0
        self._offset_ns = 0  # wall-clock ns minus perf_counter ns

    def start(self) -> None:
        self._prof.__enter__()
        self.start_ns = time.perf_counter_ns()
        self._offset_ns = time.time_ns() - self.start_ns

    def stop(self) -> None:
        if self.start_ns and not self.end_ns:
            self.end_ns = time.perf_counter_ns()
            self._prof.__exit__(None, None, None)

    def reduce(self) -> TraceData:
        data = TraceData(self.start_ns, self.end_ns)
        for e in self._prof.profiler.kineto_results.events():
            if not str(e.device_type()).endswith("CUDA"):
                continue
            kind = device_kind(e.name())
            s = e.start_ns() - self._offset_ns
            data.intervals.append((s, s + e.duration_ns(), kind, e.name()))
        return data


def device_kind(name: str) -> str:
    """"gpu_memcpy", "gpu_memset" or "kernel", from a device event's name
    (the profiler names copies "Memcpy ..." and sets "Memset ...")."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"
