"""What the readers of the program's own spans share.

The port records spans while a torch profiler runs (v2e_tpu_torch/tracing.py),
so a --trace 1 run has them for its traced window.  `program_spans` drains
them once per run and keeps them on the run.  A request is a conversion
chunk (its spans share the chunk's id) or a training step; the readers
take the requests whose root span (`submit`, `step`) started inside the
traced window and whose spans all closed.  A program without the module, or
a run without the spans, gives the readers nothing to read: they return
None.

Idle attribution: each idle gap of the device (TraceData.gaps) goes to the
innermost span open at its middle on the thread that feeds the card (the
thread of the root spans named), or to "none".
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from portbench.readers import mean

KEY = "program_spans"


def program_spans(run) -> list:
    """The program's spans of the run, drained on the first call."""
    if KEY not in run.records:
        try:
            from v2e_tpu_torch import tracing
        except ImportError:
            run.records[KEY] = []
        else:
            run.records[KEY] = tracing.drain()
    return run.records[KEY]


def requests(run, root: str) -> List[list]:
    """The spans of each request whose `root` span started inside the
    traced window and whose spans all closed."""
    if run.trace_data is None:
        return []
    ws, we = run.trace_data.start_ns, run.trace_data.end_ns
    by_request: Dict[object, list] = defaultdict(list)
    for sp in program_spans(run):
        by_request[sp.request].append(sp)
    return [group for group in by_request.values()
            if any(sp.name == root and sp.parent is None and ws <= sp.start_ns < we
                   for sp in group)
            and all(sp.end_ns is not None for sp in group)]


def span_ms(sp, device: bool) -> Optional[float]:
    return sp.device_ms if device else (sp.end_ns - sp.start_ns) / 1e6


def per_request_ms(run, root: str, names: Sequence[str], device: bool = False) -> Optional[float]:
    """Mean over the requests of the summed ms (host, or with `device` the
    device time) of their spans named in `names`; None where no request has
    one."""
    sums = []
    for group in requests(run, root):
        got = [span_ms(sp, device) for sp in group if sp.name in names]
        if got and all(v is not None for v in got):
            sums.append(sum(got))
    return mean(sums)


def per_request_count(run, root: str, name: str, key: str) -> Optional[float]:
    """Mean over the requests of the count `key` of their spans `name`."""
    sums = [sum(sp.counts.get(key, 0) for sp in group if sp.name == name)
            for group in requests(run, root)
            if any(sp.name == name for sp in group)]
    return mean(sums)


def feeding_threads(run, roots: Sequence[str]) -> set:
    return {sp.thread for sp in program_spans(run) if sp.name in roots and sp.parent is None}


def top(sp):
    while sp.parent is not None:
        sp = sp.parent
    return sp


def idle_by_span(run, roots: Sequence[str]) -> Dict[str, float]:
    """Seconds of the traced window's idle gaps by the innermost span open
    at each gap's middle on the threads that open `roots` ("none" where no
    span is open)."""
    threads = feeding_threads(run, roots)
    trees: Dict[int, list] = defaultdict(list)  # a top-level span's id -> it and its spans
    for sp in program_spans(run):
        if sp.thread in threads and sp.end_ns is not None:
            trees[id(top(sp))].append(sp)
    tops = sorted((top(t[0]) for t in trees.values()), key=lambda sp: sp.start_ns)
    starts = [sp.start_ns for sp in tops]
    out: Dict[str, float] = defaultdict(float)
    for s, e in run.trace_data.gaps():
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        tree = trees[id(tops[i])] if i >= 0 else []
        open_ = [sp for sp in tree if sp.start_ns <= mid < sp.end_ns]
        name = open_[-1].name if open_ else "none"  # spans come in the order they opened
        out[name] += (e - s) / 1e9
    return dict(out)


def idle_unattributed_pct(run, roots: Sequence[str]) -> Optional[float]:
    """100 x the share of the idle time that no span explains."""
    if run.trace_data is None or not feeding_threads(run, roots):
        return None
    idle = idle_by_span(run, roots)
    total = sum(idle.values())
    return 100.0 * idle.get("none", 0.0) / total if total > 0 else 0.0
