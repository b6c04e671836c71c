"""The readers of the program's spans (portbench/spans.py and the metrics
that use it) on planted spans and a planted TraceData: per-request sums over
the requests whose root started in the traced window, device times, the
events count, and the idle gaps put down to the innermost span open on the
feeding thread."""
from types import SimpleNamespace

import pytest

from portbench import bench, spans
from portbench.trace import HostRanges, TraceData

MS = 1_000_000
SUBMITTER, FETCHER = 1, 2


def span(name, request, start_ms, end_ms, parent=None, thread=SUBMITTER, device_ms=None,
         **counts):
    thread = parent.thread if parent is not None else thread
    return SimpleNamespace(name=name, request=request, thread=thread, parent=parent,
                           start_ns=int(start_ms * MS),
                           end_ns=None if end_ms is None else int(end_ms * MS),
                           device_ms=device_ms, counts=counts)


def chunk(c, t0):
    """Chunk c submitted at t0 ms: submit 0-10 ms with its children, then
    fetch and finalize on their threads."""
    sub = span("submit", c, t0, t0 + 10)
    compact = span("emulator.compact", c, t0 + 6, t0 + 9, sub, device_ms=1.5)
    fetch = span("collect.fetch", c, t0 + 9, t0 + 12, thread=FETCHER)
    fin = span("collect.finalize", c, t0 + 12, t0 + 15, thread=FETCHER, events=100 * (c + 1))
    return [sub,
            span("submit.upload", c, t0, t0 + 1, sub),
            span("slomo.flow_unet", c, t0 + 1, t0 + 3, sub, device_ms=4.0),
            span("slomo.refine_unet", c, t0 + 3, t0 + 5, sub, device_ms=6.0),
            span("emulator.precore", c, t0 + 5, t0 + 6, sub, device_ms=0.5),
            span("slomo.resize.upload", c, t0 + 5.5, t0 + 5.75, sub),
            compact,
            span("emulator.compact.sync", c, t0 + 7, t0 + 9, compact),
            fetch, span("collect.fetch.wait", c, t0 + 9, t0 + 11, fetch),
            fin, span("collect.materialize", c, t0 + 12, t0 + 14, fin),
            span("collect.write", c, t0 + 14, t0 + 15, fin)]


def planted_run(program, gaps=()):
    """A traced window [20, 60) ms whose device is busy but for `gaps`."""
    run = bench.Run("c", {}, {}, 1, 1.0, True, "cpu", "/nonexistent", 0, host=HostRanges())
    edges = [20 * MS] + [int(x * MS) for g in gaps for x in g] + [60 * MS]
    busy = [(a, b, "kernel", "k") for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    run.trace_data = TraceData(20 * MS, 60 * MS, busy)
    run.records[spans.KEY] = program
    return run


def read(name, run):
    return bench.metric_reader(name)(run)


def conversion():
    # chunk 0 submitted before the window (left out), 1-3 inside it, chunk 4
    # inside it but still open (left out)
    program = [sp for c, t0 in ((0, 5), (1, 20), (2, 35), (3, 45)) for sp in chunk(c, t0)]
    program.append(span("pipeline.drain", 0, 30, 31))
    program.append(span("submit", 4, 55, None))
    return program


def test_per_chunk_readers():
    run = planted_run(conversion())
    # upload 1 + the resize's weights 0.25 + sync 2
    assert read("submit_wait_ms.convert", run) == pytest.approx(3.25)
    assert read("fetch_wait_ms.convert", run) == pytest.approx(2.0)
    assert read("materialize_ms.convert", run) == pytest.approx(2.0)
    assert read("sink_write_ms.convert", run) == pytest.approx(1.0)
    assert read("events_per_chunk.convert", run) == pytest.approx((200 + 300 + 400) / 3)
    assert read("flow_unet_ms.convert", run) == pytest.approx(4.0)
    assert read("refine_unet_ms.convert", run) == pytest.approx(6.0)
    assert read("precore_ms.convert", run) == pytest.approx(0.5)
    assert read("compact_ms.convert", run) == pytest.approx(1.5)


def test_idle_attribution():
    # gaps: in chunk 1's sync (27-29: compact.sync, innermost), in the drain
    # (30-31), between chunks 1's submit and 2's (31.5-34: none) and in
    # chunk 2's upload (35-35.5)
    run = planted_run(conversion(), gaps=((27, 29), (30, 31), (31.5, 34), (35, 35.5)))
    idle = spans.idle_by_span(run, ("submit",))
    assert idle == pytest.approx({"emulator.compact.sync": 2e-3, "pipeline.drain": 1e-3,
                                  "none": 2.5e-3, "submit.upload": 0.5e-3})
    assert read("idle_unattributed_pct.convert", run) == pytest.approx(100 * 2.5 / 6.0)
    # the fetch thread's spans explain nothing: it does not feed the card
    assert spans.feeding_threads(run, ("submit",)) == {SUBMITTER}


def test_training_readers():
    program = []
    for s, t0 in enumerate((10, 25, 40)):
        step = span("step", s, t0 + 2, t0 + 14)
        program += [span("sampler", s, t0, t0 + 2), step,
                    span("step.upload", s, t0 + 2, t0 + 3, step),
                    span("step.forward", s, t0 + 3, t0 + 6, step, device_ms=10.0),
                    span("step.backward", s, t0 + 6, t0 + 9, step, device_ms=20.0),
                    span("step.adam", s, t0 + 9, t0 + 14, step, device_ms=2.0)]
    run = planted_run(program, gaps=((25.5, 26.5), (38, 40)))
    assert read("batch_upload_ms.train", run) == pytest.approx(1.0)  # steps 1 and 2
    assert read("forward_ms.train", run) == pytest.approx(10.0)
    assert read("backward_ms.train", run) == pytest.approx(20.0)
    assert read("adam_ms.train", run) == pytest.approx(2.0)
    # 1 ms in step 1's sampler, 2 ms between step 1 and step 2's sampler
    assert read("idle_unattributed_pct.train", run) == pytest.approx(100 * 2 / 3)


NEW = ("submit_wait_ms.convert", "fetch_wait_ms.convert", "materialize_ms.convert",
       "sink_write_ms.convert", "events_per_chunk.convert", "flow_unet_ms.convert",
       "refine_unet_ms.convert", "precore_ms.convert", "compact_ms.convert",
       "idle_unattributed_pct.convert", "batch_upload_ms.train", "forward_ms.train",
       "backward_ms.train", "adam_ms.train", "idle_unattributed_pct.train")


@pytest.mark.parametrize("name", NEW)
def test_no_spans_read_nothing(name):
    """A program without spans (or a run without a trace) leaves the
    metric out of the line, and does not raise."""
    assert read(name, planted_run([])) is None
    untraced = planted_run([])
    untraced.trace_data = None
    assert read(name, untraced) is None


def test_spans_are_drained_from_the_program_once():
    from v2e_tpu_torch import tracing

    tracing.drain()
    run = planted_run([])
    del run.records[spans.KEY]
    assert spans.program_spans(run) == [] and spans.program_spans(run) is run.records[spans.KEY]


def test_every_new_metric_is_declared():
    declared = {m["name"]: m for m in bench.spec()["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] in ("program_span", "program_counter")
        assert m["moves"] == ("realtime_x" if name.endswith(".convert") else "train_samples_per_s")
