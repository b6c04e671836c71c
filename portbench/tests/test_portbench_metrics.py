"""realtime_x and chunk_ms_p95 on synthetic timestamps: a steady window,
then the same window with a stall inside, which must move both."""
import pytest

from portbench import bench
from portbench.trace import HostRanges, TraceData, breakdown, short_name

MS = 1_000_000


def fake_run(period_ms: float, n: int, stall_at=None, stall_ms: float = 0.0, latency_ms=30.0):
    """Chunks handed over every `period_ms` from t = 0, each done
    `latency_ms` later; from chunk `stall_at` on everything is `stall_ms`
    late.  The window is [0, 1 s]."""
    run = bench.Run("c", {}, {}, 1, 1.0, False, "cpu", "/nonexistent", -5000 * MS, host=HostRanges())
    run.window_start_ns, run.window_end_ns = 0, 1000 * MS
    hand, done = [], []
    for c in range(n):
        h = c * period_ms
        d = h + latency_ms
        if stall_at is not None and c >= stall_at:
            d += stall_ms
            h += stall_ms if c > stall_at else 0
        hand.append(int(h * MS))
        done.append(int(d * MS))
    run.records = {"handover_ns": hand, "done_ns": done}
    run.counts["chunk_source_s"] = 0.25
    return run


def read(name, run):
    return bench.metric_reader(name)(run)


def test_steady_window():
    run = fake_run(100.0, 12)
    # chunks done at 30, 130, ..., 930 ms: 10 inside [0, 1000] ms
    assert read("realtime_x", run) == pytest.approx(10 * 0.25 / 1.0)
    assert read("chunk_ms_p95", run) == pytest.approx(30.0)
    assert read("setup_s", run) == pytest.approx(5.0)


def test_a_stall_moves_both():
    steady = fake_run(100.0, 12)
    stalled = fake_run(100.0, 12, stall_at=4, stall_ms=300.0)
    assert read("realtime_x", stalled) < read("realtime_x", steady)
    assert read("chunk_ms_p95", stalled) > read("chunk_ms_p95", steady)
    assert read("chunk_ms_p95", stalled) > 200.0  # the stalled chunk waited 330 ms


def test_a_chunk_that_never_arrives_is_late():
    run = fake_run(100.0, 12)
    run.records["done_ns"] = run.records["done_ns"][:5]
    assert read("chunk_ms_p95", run) is None


def test_trace_union_gaps_and_labels():
    host = HostRanges()
    host.add("submit", 0, 40)
    host.add("collect_finalize", 60, 100)
    t = TraceData(0, 100, [(10, 30, "kernel", "void a::k1<int>(int)"), (20, 50, "kernel", "b"),
                           (70, 80, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)")])
    assert t.busy_s() == pytest.approx(50e-9)
    assert t.gaps() == [(0, 10), (50, 70), (80, 100)]
    bd = breakdown(t, host)
    assert bd["idle_gaps"][0] == ["collect_finalize", 20e-9] or bd["idle_gaps"][0][1] == 20e-9
    assert ["submit", 10e-9] in bd["idle_gaps"]
    assert bd["device_ops"][0][0] in ("b", "k1")
    assert short_name("void at::native::(anonymous namespace)::upsample_bilinear2d_out_frame"
                      "<float, float>(int)") == "upsample_bilinear2d_out_frame"
