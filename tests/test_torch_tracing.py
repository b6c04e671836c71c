"""The port's spans and counters (v2e_tpu_torch/tracing.py) on the CPU:
nothing records without a profiler; under one a small SloMo conversion
gives each chunk its submit, fetch and finalize spans under one id, nested
on their threads, and event counts that add up to the AEDAT-2 file, with
the resize weights copied to the device once per process (in the staged
first chunk) and no host wait inside compaction; a chunk
submitted under the profiler is traced whole after it stops; a training
step gives its four stages.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from v2e_tpu_torch import tracing
from v2e_tpu_torch.emulator import EventEmulator
from v2e_tpu_torch.emulator.pipeline import ChunkPipeline
from v2e_tpu_torch.fused import FusedConverter
from v2e_tpu_torch.models.resize import device_weight_matrix
from v2e_tpu_torch.models.slomo import SuperSloMo
from v2e_tpu_torch.synthetic import make_source_frames

H, W, B, U = 180, 240, 2, 2  # a size the AEDAT-2 sink takes
CHUNKS = 4  # the staged first chunk, then three fused ones
SUBMIT_CHILDREN = {"submit.upload", "slomo.flow_unet", "slomo.refine_unet",
                   "emulator.precore", "emulator.compact"}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def converter(tmp_path):
    slomo = SuperSloMo(None, upsampling_factor=U, batch_size=B, allow_random=True,
                       device="cpu", base=8, compute_dtype="float32")
    em = EventEmulator(dvs_aedat2="e.aedat", output_folder=str(tmp_path), output_width=W,
                       output_height=H, device="cpu", seed=3)
    return FusedConverter(slomo, em), em


def windows(n_chunks):
    src = make_source_frames(B * n_chunks + 1, H, W, seed=1).astype(np.float32)
    return [(src[B * c: B * c + B + 1], B * c) for c in range(n_chunks)]


def file_events(path) -> int:
    data = open(path, "rb").read()
    pos = 0
    while data[pos:pos + 1] == b"#":
        pos = data.index(b"\n", pos) + 1
    return (len(data) - pos) // 8


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_nothing_records_without_a_profiler(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
    tracing.drain()
    assert not torch.autograd.profiler._is_profiler_enabled
    with tracing.root("submit", 0, tracing.DEVICE, torch.device("cuda")) as sp:
        assert sp is tracing.NO_SPAN and not sp.recording
        with tracing.span("emulator.compact", tracing.DEVICE, torch.device("cuda")) as child:
            assert child is tracing.NO_SPAN
            child.add("events", 3)
    assert made == [] and tracing.drain() == []


def test_counters_are_plain_integers():
    before = tracing.counters().get("test.counter", 0)
    tracing.count("test.counter")
    tracing.count("test.counter", 4)
    assert tracing.counters()["test.counter"] == before + 5


def test_conversion_spans_per_chunk(tmp_path):
    fc, em = converter(tmp_path)
    tracing.drain()
    device_weight_matrix.cache_clear()
    uploads = tracing.counters().get("resize.upload", 0)
    with cpu_profile():
        pipe = ChunkPipeline(em, lambda *a: None, depth=2)
        try:
            for frames, pair in windows(CHUNKS):
                handle, _, _ = fc.submit_window(frames, pair, 1 / 30)
                pipe.push_handle(handle, fc.note_collected)
        finally:
            pipe.close()
    em.cleanup()
    spans = tracing.drain()
    assert fc.n_staged == 1
    for root in ("submit", "collect.fetch", "collect.finalize"):
        assert sorted(s.request for s in by_name(spans, root)) == list(range(CHUNKS)), root
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)
    for s in spans:
        if s.parent is not None:
            p = s.parent
            assert p.thread == s.thread and p.request == s.request
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    submit_threads = {s.thread for s in by_name(spans, "submit")}
    assert len(submit_threads) == 1
    assert {s.thread for s in by_name(spans, "collect.fetch")}.isdisjoint(submit_threads)
    fused = [s for s in by_name(spans, "submit") if s.request > 0]
    for sub in fused:
        names = {s.name for s in spans if s.parent is sub}
        assert SUBMIT_CHILDREN <= names, names
        compact = [s for s in spans if s.parent is sub and s.name == "emulator.compact"]
        assert [c.name for c in spans if c.parent is compact[0]] == []
    for s in spans:  # a device span's time on the CPU is its host time
        if s.kind == tracing.DEVICE:
            assert s.device_ms == pytest.approx((s.end_ns - s.start_ns) / 1e6)
    waits = {s.name for s in spans if s.kind == tracing.WAIT}
    assert {"submit.upload", "collect.fetch.wait"} <= waits
    # four matrices (two sizes each way), copied in the staged chunk's
    # interpolation, before its submit opens: no fused chunk copies one
    assert tracing.counters()["resize.upload"] == uploads + 4
    assert by_name(spans, "slomo.resize.upload") == []
    assert by_name(spans, "emulator.compact.sync") == []
    fin = by_name(spans, "collect.finalize")
    assert all({c.name for c in spans if c.parent is f} == {"collect.materialize", "collect.write"}
               for f in fin if f.counts["events"])
    total = sum(f.counts["events"] for f in fin)
    assert total > 0 and total == file_events(tmp_path / "e.aedat") == em.num_events_total


def test_a_chunk_is_traced_whole_after_the_profiler_stops(tmp_path):
    fc, em = converter(tmp_path)
    tracing.drain()
    (w0, p0), (w1, p1), (w2, p2) = windows(3)
    first, _, _ = fc.submit_window(w0, p0, 1 / 30)  # before the profiler: untraced
    with cpu_profile():
        in_flight = [fc.submit_window(w, p, 1 / 30)[0] for w, p in ((w1, p1), (w2, p2))]
        em.collect(first)  # collected under the profiler, still untraced
    for h in in_flight:  # collected after it stopped, still traced
        em.collect(h)
    em.cleanup()
    spans = tracing.drain()
    assert not first["traced"] and all(h["traced"] for h in in_flight)
    for root in ("submit", "collect.fetch", "collect.finalize"):
        assert sorted(s.request for s in by_name(spans, root)) == [1, 2], root
    for name in ("collect.fetch.wait", "collect.materialize", "collect.write"):
        assert {s.request for s in by_name(spans, name)} <= {1, 2}


def test_train_step_spans():
    from v2e_tpu_torch.models.train import create_train_state, make_train_step

    state = create_train_state(0, 1e-4, 8, "cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(-0.4, 0.6, (2, 1, 32, 32)).astype(np.float32)
             for k in ("I0", "I1", "It")}
    batch["t"] = np.array([0.25, 0.5], np.float32)
    step = make_train_step()
    tracing.drain()
    with cpu_profile():
        state, _ = step(state, batch)
    spans = tracing.drain()
    (root,) = by_name(spans, "step")
    assert root.request == 0 and root.parent is None
    children = [s for s in spans if s.parent is root]
    assert [s.name for s in children] == ["step.upload", "step.forward", "step.backward",
                                          "step.adam"]
    assert children[0].kind == tracing.WAIT
    assert all(s.kind == tracing.DEVICE and s.device_ms > 0 for s in children[1:])
