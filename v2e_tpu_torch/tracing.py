"""Spans and counters of the port's own work.

A span is one named interval of host time on one thread: its start and
end on `time.perf_counter_ns()`, the span it nests in on that thread, the
request it serves (a conversion chunk's index in the emulator's submission
order, or a training step) and a few counts.  Three kinds:

* HOST: host work;
* WAIT: host time blocked on the device (a copy to or from it, a value
  the host needs);
* DEVICE: also a pair of CUDA events on the current stream, whose elapsed
  time (`device_ms`) is read at `drain`, once the work has completed: the
  device time of the work enqueued inside the span, with any time the
  stream waited for the host inside it.  On the CPU it is the host time.

Spans record only while a torch profiler runs (torch's global flag
`torch.autograd.profiler._is_profiler_enabled`, seen on every thread), so
`python -m v2e_tpu_torch --profile` and any `torch.profiler.profile` block
get them, and a run without a profiler pays one flag read per span.  A
root span (`root`) decides when it opens; the spans inside it (`span`)
follow their thread's open root, whether or not the profiler still runs.
A conversion chunk carries its decision in its collect handle to the
fetch and finalize threads, so a chunk is traced whole or not at all.

The spans, by thread, and what each times:

  submitting thread (the thread that calls the emulator's submit):
    submit                 root of a chunk: EventEmulator.submit_batch,
                           submit_batch_fused
    submit.upload          WAIT: frames and times to the device (through
                           pinned memory: the host copy, no wait for the
                           stream)
    slomo.resize.upload    WAIT: a resize's weight matrix to the device, on
                           a miss of its device cache only (a pageable
                           copy: it waits for the stream)
    slomo.flow_unet        DEVICE: the flow UNet
    slomo.refine_unet      DEVICE: one group's refinement UNet
    emulator.precore       DEVICE: the noise draws, lin-log, lowpass,
                           leak and shot noise up to K1/K2's inputs
    emulator.compact       DEVICE: the sparse compaction (pack_chunk)
    pipeline.drain         WAIT, root: ChunkPipeline waits for the oldest
                           chunk's events
  fetch thread:
    collect.fetch          root: the chunk's copy to the host
    collect.fetch.wait     WAIT: the copy of its scalars, which waits on
                           the chunk's own event (recorded in submit after
                           its last device work), not on the stream
  finalize thread:
    collect.finalize       root, count `events`: materialize and write
    collect.materialize    the events from the compacted cells, shuffled
    collect.write          one sink's pack and write
  training thread:
    sampler                root of a step's batch: TripletSampler
    step                   root: train_step
    step.upload            WAIT: the batch to the device
    step.forward, step.backward, step.adam
                           DEVICE: the loss, its backward, the update

Counters (`count`, `counters`) are plain integers, always on: kernel
launches (`launch.k1` ... `launch.k6`, `launch.k8`, `launch.k1_strips`,
`launch.k3_vjp`, `launch.k6_vjp`), K5's calls by shape
(`shape.k5.<N>x<H>x<W>x<Ci>.<Co>`), the host library's calls by path
(`native.<function>`, `numpy.<function>`), the resize weight matrices
copied to a device (`resize.upload`, one per sizes, method, device and
dtype) and the chunks recompacted in the fetch at a larger capacity
(`compact.recompact`).

`drain()` returns the recorded spans and forgets them.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

HOST, WAIT, DEVICE = "host", "wait", "device"

_lock = threading.Lock()
_spans: List["Span"] = []
_live = 0  # recording spans open in the process
_local = threading.local()
_counters: Dict[str, int] = {}


class Span:
    """A recording span (see the module note); a context manager."""

    __slots__ = ("name", "kind", "thread", "start_ns", "end_ns", "parent", "request",
                 "counts", "device_ms", "_events")
    recording = True

    def __init__(self, name: str, kind: str, request, parent: Optional["Span"], device):
        self.name, self.kind, self.request, self.parent = name, kind, request, parent
        self.thread = threading.get_ident()
        self.counts: Dict[str, int] = {}
        self.device_ms: Optional[float] = None
        self.end_ns: Optional[int] = None
        self._events = None
        if kind == DEVICE and device is not None and device.type == "cuda":
            import torch

            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), device)
            self._events[0].record(torch.cuda.current_stream(device))
        self.start_ns = time.perf_counter_ns()

    def add(self, key: str, n: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + int(n)

    def close(self) -> None:
        global _live
        if self.end_ns is not None:
            return
        if self._events is not None:
            import torch

            _, end, device = self._events
            end.record(torch.cuda.current_stream(device))
        self.end_ns = time.perf_counter_ns()
        stack = _stack()
        if self in stack:
            stack.remove(self)
        with _lock:
            _live -= 1

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _settle(self) -> None:
        """Read the device time (the work is complete or waited for)."""
        if self.end_ns is None or self.device_ms is not None or self.kind != DEVICE:
            return
        if self._events is None:
            self.device_ms = (self.end_ns - self.start_ns) / 1e6
        else:
            start, end, _ = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self._events = None

    def as_dict(self, index: Dict[int, int]) -> dict:
        """The span as JSON, its parent by index in the drained list."""
        return {"name": self.name, "kind": self.kind, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "parent": None if self.parent is None else index.get(id(self.parent)),
                "request": self.request, "counts": self.counts, "device_ms": self.device_ms}


class _NoSpan:
    """The span returned when nothing records: does nothing."""

    recording = False

    def add(self, key: str, n: int) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NO_SPAN = _NoSpan()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open(name: str, kind: str, request, parent: Optional[Span], device) -> Span:
    global _live
    sp = Span(name, kind, request, parent, device)
    _stack().append(sp)
    with _lock:
        _live += 1
        _spans.append(sp)
    return sp


def root(name: str, request=None, kind: str = HOST, device=None, traced: Optional[bool] = None):
    """A span that starts a request's spans on this thread.  It records when
    `traced` says so, or (None) when a torch profiler is running."""
    if not (_profiler._is_profiler_enabled if traced is None else traced):
        return NO_SPAN
    stack = _stack()
    return _open(name, kind, request, stack[-1] if stack else None, device)


def span(name: str, kind: str = HOST, device=None):
    """A span inside the thread's open span; it records when that one does."""
    if not _live:
        return NO_SPAN
    stack = _stack()
    if not stack:
        return NO_SPAN
    parent = stack[-1]
    return _open(name, kind, parent.request, parent, device)


def drain() -> List[Span]:
    """The spans recorded so far, in the order they opened, with their device
    times read (waiting for the device where a span's work is not done);
    they are forgotten here.  A span still open has no end."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    for sp in out:
        sp._settle()
    return out


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counters)


def export(spans: List[Span]) -> dict:
    """Spans and counters as JSON, with one reading of both clocks, so
    that the spans (perf_counter ns) can be laid on a trace's wall-clock
    timeline (time_ns)."""
    index = {id(sp): i for i, sp in enumerate(spans)}
    return {"clock": {"perf_counter_ns": time.perf_counter_ns(), "time_ns": time.time_ns()},
            "spans": [sp.as_dict(index) for sp in spans], "counters": counters()}
