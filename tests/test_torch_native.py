"""The port's native AER library (v2e_tpu_torch/native, built here with
g++) against the port's numpy versions and v2e_tpu's: each of its six
functions on the same seeded inputs, three ways.

* against the port's numpy version: bit for bit;
* against v2e_tpu's numpy path (its library hidden): bit for bit;
* against v2e_tpu's own g++ library: bit for bit, except event times,
  which may differ by one float64 ulp: that library is built without
  -ffp-contract=off, so ``t0 + (it + 1) * s`` can become one fused
  multiply-add.
"""
import types

import numpy as np
import pytest

import v2e_tpu.emulator.events as jax_events
import v2e_tpu.io.aedat2 as jax_aedat2
import v2e_tpu.native as jax_native
import v2e_tpu.render.renderer as jax_renderer
from v2e_tpu_torch import native, tracing
from v2e_tpu_torch.emulator import events
from v2e_tpu_torch.io.aedat2 import AEDat2Output, pack_aedat2_numpy
from v2e_tpu_torch.render.renderer import accumulate_histogram_numpy, area_count_scan_numpy

H, W, F = 24, 32, 5
T_ORIGIN = 1.2345


@pytest.fixture(scope="module")
def libs():
    port, ref = native.get_lib(), jax_native.get_lib()
    assert port is not None, "the port's native library did not build"
    assert ref is not None, "v2e_tpu's native library did not build"
    return port, ref


@pytest.fixture
def no_jax_lib(monkeypatch):
    """v2e_tpu's callers with its library hidden: its numpy paths."""
    for mod in (jax_events, jax_renderer):
        monkeypatch.setattr(mod, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.max(np.abs(a.view(np.int64) - b.view(np.int64)), initial=0))


def sparse_chunk(seed=0):
    """A compacted chunk: cells sorted by flat index, signed counts, first
    iterations that keep every event on its frame's grid, shot bits (also
    on cells with no signal event), and float32 chunk-relative times."""
    rng = np.random.default_rng(seed)
    stride = rng.integers(1, 3, F).astype(np.int32)
    K = rng.integers(6, 10, F).astype(np.int32)
    idx = np.sort(rng.choice(F * H * W, 900, replace=False)).astype(np.int32)
    fr = idx // (H * W)
    count = (rng.integers(1, 4, idx.size) * rng.choice([-1, 1], idx.size)).astype(np.int16)
    count[rng.random(idx.size) < 0.1] = 0
    room = K[fr] - (np.abs(count).astype(np.int32) - 1) * stride[fr]
    i0 = (rng.random(idx.size) * np.maximum(room, 1)).astype(np.int16)
    shot = (rng.random(idx.size) < 0.15).astype(np.uint8) | (
        (rng.random(idx.size) < 0.1).astype(np.uint8) << 1)
    shot[count == 0] |= 1
    t_prev = (np.arange(F) / 300.0).astype(np.float32)
    t_frame = (np.arange(1, F + 1) / 300.0).astype(np.float32)
    return idx, count, i0, shot, stride, K, t_prev, t_frame


def grid(K, t_prev, t_frame):
    t0 = T_ORIGIN + t_prev.astype(np.float64)
    tf = T_ORIGIN + t_frame.astype(np.float64)
    s = (t_frame.astype(np.float64) - t_prev.astype(np.float64)) / np.maximum(K.astype(np.int64), 1)
    return t0, tf, s


def event_list(seed=1, n=4000):
    rng = np.random.default_rng(seed)
    ev = np.empty((n, 4))
    ev[:, 0] = np.sort(rng.uniform(0.0, 0.05, n))
    ev[:, 1] = rng.integers(-2, W + 2, n)  # a few off the sensor
    ev[:, 2] = rng.integers(-2, H + 2, n)
    ev[:, 3] = rng.choice([-1.0, 1.0], n)
    return ev


def frame_maps(seed=2, K=9, stride=2):
    rng = np.random.default_rng(seed)
    count = (rng.integers(0, 4, (H, W)) * rng.choice([-1, 1], (H, W))).astype(np.int16)
    i0 = (rng.random((H, W)) * (K - (np.abs(count) - 1) * stride).clip(1)).astype(np.int16)
    on = rng.random((H, W)) < 0.05
    off = (rng.random((H, W)) < 0.05) & ~on
    return count, i0, on, off


def case_materialize_sparse(port, ref, no_jax_lib):
    idx, count, i0, shot, stride, K, t_prev, t_frame = sparse_chunk()
    t0, tf, s = grid(K, t_prev, t_frame)
    for seed in (None, 7):  # in order, and shuffled within iterations
        rng = lambda: None if seed is None else np.random.default_rng(seed)
        args = (idx, count, i0, shot, stride, K, t0, tf, s, H, W)
        ev, lab, off = native.materialize_sparse(*args, rng(), True)
        ev_np, lab_np, off_np = events.materialize_events_sparse_numpy(*args, rng(), True)
        assert ev.shape[0] == int(np.abs(count.astype(np.int64)).sum()) + int(
            np.count_nonzero(shot & 1) + np.count_nonzero(shot & 2))
        np.testing.assert_array_equal(ev, ev_np)
        np.testing.assert_array_equal(lab, lab_np)
        np.testing.assert_array_equal(off, off_np)
        jax_args = (idx, count, i0, shot, stride, K, t_prev, t_frame, H, W, T_ORIGIN)
        ev_j, lab_j, off_j = jax_events.materialize_events_sparse(
            *jax_args, rng=rng(), label_signal_noise=True)
        np.testing.assert_array_equal(ev, ev_j)
        np.testing.assert_array_equal(lab, lab_j)
        np.testing.assert_array_equal(off, off_j)
        # v2e_tpu's own library, called as its native branch calls it
        ref_ev = np.empty_like(ev)
        ref_lab = np.empty(ev.shape[0], np.uint8)
        ref_off = np.zeros(F + 1, np.int64)
        keys = rng()
        keys = keys.random(ev.shape[0]) if keys is not None else None
        ref.materialize_sparse(
            idx, count, i0, shot.ctypes.data, idx.shape[0], stride.astype(np.int64),
            K.astype(np.int64), t0, tf, s, F, H, W,
            keys.ctypes.data if keys is not None else None,
            ref_ev.reshape(-1), ref_lab.ctypes.data, ref_off)
        np.testing.assert_array_equal(ev[:, 1:], ref_ev[:, 1:])
        np.testing.assert_array_equal(lab, ref_lab.astype(bool))
        np.testing.assert_array_equal(off, ref_off)
        assert ulps(ev[:, 0].copy(), ref_ev[:, 0].copy()) <= 1


def case_materialize_frame(port, ref, no_jax_lib):
    K, stride = 9, 2
    count, i0, on, off = frame_maps(K=K, stride=stride)
    t_prev, t_frame = T_ORIGIN, T_ORIGIN + 1 / 300.0
    s = (t_frame - t_prev) / K
    ev, lab = native.materialize_frame(count, i0, stride, K, t_prev, s, t_frame, on, off, True)
    ev_np, lab_np = events.materialize_frame_numpy(count, i0, stride, K, t_prev, t_frame,
                                                   on, off, None, True)
    np.testing.assert_array_equal(ev, ev_np)
    np.testing.assert_array_equal(lab, lab_np)
    ev_j, lab_j = jax_events.materialize_frame(count, i0, stride, K, t_prev, t_frame,
                                               on, off, None, True)
    np.testing.assert_array_equal(ev, ev_j)
    np.testing.assert_array_equal(lab, lab_j)
    ev_r, lab_r = jax_events._materialize_frame_native(
        ref, count, i0, stride, K, t_prev, s, t_frame, on, off, True)
    np.testing.assert_array_equal(ev[:, 1:], ev_r[:, 1:])
    np.testing.assert_array_equal(lab, lab_r)
    assert ulps(ev[:, 0].copy(), ev_r[:, 0].copy()) <= 1
    # the public function takes the native path here, the dense frames of a
    # chunk through materialize_events too
    before = tracing.counters().get("native.materialize_frame", 0)
    ev_p, _ = events.materialize_frame(count, i0, stride, K, t_prev, t_frame, on, off)
    np.testing.assert_array_equal(ev_p, ev)
    assert tracing.counters()["native.materialize_frame"] == before + 1


def case_count_frame_events(port, ref, no_jax_lib):
    count, _, on, off = frame_maps(seed=3)
    want = int(np.abs(count.astype(np.int64)).sum() + on.sum() + off.sum())
    assert native.count_frame_events(count, on, off) == want
    assert native.count_frame_events(count) == int(np.abs(count.astype(np.int64)).sum())
    assert events.materialize_frame_numpy(count, np.zeros_like(count), 1, 4, 0.0, 1.0,
                                          on, off)[0].shape[0] == want
    c = np.ascontiguousarray(count).reshape(-1)
    o, f = on.astype(np.uint8).reshape(-1), off.astype(np.uint8).reshape(-1)
    assert ref.count_frame_events(c, c.size, o.ctypes.data, f.ctypes.data) == want


def case_pack_aedat2(port, ref, no_jax_lib, tmp_path):
    ev = event_list()
    ev[:, 1] %= W
    ev[:, 2] %= H
    label = np.random.default_rng(5).random(ev.shape[0]) < 0.8
    sink = AEDat2Output(str(tmp_path / "p.aedat"), 346, 260, label_signal_noise=True)
    shifts = (346, 260, sink.xShiftBits, sink.yShiftBits, sink.polShiftBits)
    sink.close()
    for mask in (None, label):
        words = native.pack_aedat2(ev, *shifts, True, mask)
        np.testing.assert_array_equal(words, pack_aedat2_numpy(ev, *shifts, True, True, mask))
        out = np.empty_like(words)
        m = mask.astype(np.uint8) if mask is not None else None
        ref.pack_aedat2(ev, ev.shape[0], *shifts, 1, m.ctypes.data if m is not None else None, out)
        np.testing.assert_array_equal(words, out)
    # v2e_tpu's writer (its numpy path here) and the port's (native) write
    # the same payload after their headers
    payload = []
    for mod, name in ((jax_aedat2, "j.aedat"), (None, "p.aedat")):
        cls = AEDat2Output if mod is None else mod.AEDat2Output
        w = cls(str(tmp_path / name), 346, 260, label_signal_noise=True)
        w.appendEvents(ev, signnoise_label=label)
        w.close()
        data = (tmp_path / name).read_bytes()
        head = 0
        while data[head:head + 1] == b"#":
            head = data.index(b"\r\n", head) + 2
        payload.append(data[head:])
    assert payload[0] == payload[1] and len(payload[0]) == 8 * ev.shape[0]


def case_hist2d_accumulate(port, ref, no_jax_lib):
    ev = event_list()
    start = np.random.default_rng(4).integers(-2, 3, (H, W)).astype(np.float32)
    frames = [start.copy() for _ in range(4)]
    native.hist2d_accumulate(frames[0], ev, 2.0)
    accumulate_histogram_numpy(frames[1], ev, 2.0)
    jax_renderer.accumulate_histogram(frames[2], ev, 2.0)
    ref.hist2d_accumulate(ev, ev.shape[0], H, W, 2.0, frames[3])
    for other in frames[1:]:
        np.testing.assert_array_equal(frames[0], other)
    assert np.abs(frames[0]).max() == 2.0


def case_area_count_scan(port, ref, no_jax_lib):
    # events past the sensor's far edges only: at x or y in (-dim, 0) the C
    # scan truncates to area 0 where numpy floors to -1 and skips, in
    # v2e_tpu as in the port; the emulator emits no negative coordinate
    ev = event_list(n=3000)
    ev[:, 1:3] = np.abs(ev[:, 1:3])
    dim, limit = 8, 12
    nw, nh = -(-W // dim), -(-H // dim)

    def scan(fn):
        counts = np.zeros((nw, nh), np.int64)
        ends, start = [], 0
        while start < ev.shape[0]:
            end = fn(counts, start)
            ends.append(end)
            start = end + 1
        return ends, counts

    got = scan(lambda c, s: native.area_count_scan(ev, s, dim, limit, c))
    plain = scan(lambda c, s: area_count_scan_numpy(ev, s, dim, limit, c))
    jax_np = scan(lambda c, s: jax_renderer.EventRenderer._area_count_scan(
        types.SimpleNamespace(area_counts=c, area_dimension=dim, area_count=limit), ev, s))
    ref_lib = scan(lambda c, s: ref.area_count_scan(ev, ev.shape[0], s, dim, limit, c, nw, nh))
    assert len(got[0]) > 10
    for other in (plain, jax_np, ref_lib):
        assert got[0] == other[0]
        np.testing.assert_array_equal(got[1], other[1])


CASES = {
    "materialize_sparse": case_materialize_sparse,
    "materialize_frame": case_materialize_frame,
    "count_frame_events": case_count_frame_events,
    "pack_aedat2": case_pack_aedat2,
    "hist2d_accumulate": case_hist2d_accumulate,
    "area_count_scan": case_area_count_scan,
}


@pytest.mark.parametrize("name", list(CASES))
def test_native_function_three_ways(name, libs, no_jax_lib, tmp_path):
    """Port native == port numpy == v2e_tpu numpy, and == v2e_tpu's
    library within one ulp of event time."""
    kwargs = {"tmp_path": tmp_path} if name == "pack_aedat2" else {}
    CASES[name](*libs, no_jax_lib, **kwargs)


def test_callers_take_the_native_path(libs, tmp_path):
    """The sparse materialization, the AEDAT-2 sink and the renderer's
    histogram go through the library and count their calls."""
    idx, count, i0, shot, stride, K, t_prev, t_frame = sparse_chunk(seed=9)
    before = tracing.counters()
    ev, _, _ = events.materialize_events_sparse(idx, count, i0, shot, stride, K, t_prev,
                                                t_frame, H, W, T_ORIGIN)
    sink = AEDat2Output(str(tmp_path / "e.aedat"), 346, 260)
    sink.appendEvents(ev)
    sink.close()
    frame = np.zeros((H, W), np.float32)
    from v2e_tpu_torch.render.renderer import accumulate_histogram

    accumulate_histogram(frame, ev, 3.0)
    for name in ("materialize_sparse", "pack_aedat2", "hist2d_accumulate"):
        assert tracing.counters()[f"native.{name}"] == before.get(f"native.{name}", 0) + 1, name


def test_library_builds_into_the_port(libs):
    assert native.LIBRARY.endswith("v2e_tpu_torch/_build/libaer_kernels.so")
    assert "-ffp-contract=off" in native.GXX_FLAGS
    assert libs[0]._name == native.LIBRARY
