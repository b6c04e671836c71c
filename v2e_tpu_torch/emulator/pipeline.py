"""Depth-N pipelined chunk runner around the emulator's submit/collect API
(port of v2e_tpu/emulator/pipeline.py).

The device runs ahead of the host by up to `depth` chunks, and collection
is a two-stage ordered pipeline: a fetcher thread waits for each chunk and
copies its compacted cells to the host (`collect_fetch`) while a finalizer
thread materializes the previous chunk's events and writes the sinks
(`collect_finalize`).  Event callbacks fire in submission order on the
caller's thread.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from v2e_tpu_torch import tracing


class ChunkPipeline:
    def __init__(
        self,
        emulator,
        on_events: Callable[[np.ndarray, Optional[np.ndarray], np.ndarray], None],
        depth: int = 6,
    ):
        self.emulator = emulator
        self.on_events = on_events
        self.depth = depth
        self._fetcher = ThreadPoolExecutor(1)
        self._finalizer = ThreadPoolExecutor(1)
        self._pending: deque = deque()

    def push(self, frames, times) -> None:
        self.push_handle(self.emulator.submit_batch(frames, times))

    def push_handle(self, handle, on_collected: Optional[Callable] = None) -> None:
        """Queue a submitted chunk's collection (None, a pure-init chunk, is
        skipped).  `on_collected(handle)` runs on the caller's thread when
        the chunk is drained, before its events are handed on."""
        if handle is None:
            return
        ffut = self._fetcher.submit(self.emulator.collect_fetch, handle)
        self._pending.append(
            (self._finalizer.submit(self._finalize, handle, ffut), handle, on_collected)
        )
        if len(self._pending) > self.depth:
            self._drain_one()

    def _finalize(self, handle, ffut):
        return self.emulator.collect_finalize(handle, ffut.result())

    def _drain_one(self) -> None:
        fut, handle, on_collected = self._pending.popleft()
        with tracing.root("pipeline.drain", handle["chunk"], tracing.WAIT):
            events, labels, offsets = fut.result()
        if on_collected is not None:
            on_collected(handle)
        if events.shape[0]:
            self.on_events(events, labels, offsets)

    def flush(self) -> None:
        while self._pending:
            self._drain_one()

    def close(self) -> None:
        """Drain every pending chunk, then stop the threads (also when a
        chunk failed: its exception is raised after the shutdown)."""
        try:
            self.flush()
        finally:
            self._fetcher.shutdown()
            self._finalizer.shutdown()
