"""What the metric readers (metrics/<name>.py) share: the window's chunks
and steps, host ranges, and the traced kernels."""
from __future__ import annotations

from typing import List, Optional

SCAN_KERNELS = ("refr_persistent", "scan_persistent")  # K1, K2: one launch per chunk


def mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def window_done(run) -> List[int]:
    """Chunks (or steps) done inside the window."""
    ws, we = run.window_start_ns, run.window_end_ns
    return [i for i, t in enumerate(run.records.get("done_ns", [])) if ws <= t <= we]


def host_mean_ms(run, name: str) -> Optional[float]:
    return mean(run.host.durations_ms(name, run.window_start_ns, run.window_end_ns))


def traced_chunks(run) -> int:
    """Chunks whose core scan (K1 or K2, one launch per chunk) ran inside
    the traced window."""
    if run.trace_data is None:
        return 0
    return sum(len(run.trace_data.kernels(k)) for k in SCAN_KERNELS)


def kernel_roofline_pct(run, name: str, bound_s_per_launch) -> Optional[float]:
    """100 x the kernel's bound over its device time, summed over its
    launches inside the traced window; None where it did not run."""
    if run.trace_data is None:
        return None
    ks = run.trace_data.kernels(name)
    t = sum(e - s for s, e, _ in ks) / 1e9
    if not ks or t <= 0:
        return None
    return 100.0 * len(ks) * bound_s_per_launch / t


def idle_pct(run) -> Optional[float]:
    if run.trace_data is None or run.trace_data.window_s <= 0 or not run.trace_data.intervals:
        return None
    return 100.0 * (1.0 - run.trace_data.busy_s() / run.trace_data.window_s)
