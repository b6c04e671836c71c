"""The port's native host library (aer_kernels.cpp), built with g++ at
first use and bound with ctypes.

It holds the host half of the event pipeline that the JAX package runs in
its own g++ library (v2e_tpu/native/): AER materialization from the
compacted count maps (`materialize_sparse`, `materialize_frame`,
`count_frame_events`), AEDAT-2 packing (`pack_aedat2`), and the DVS
video's histogram and AREA_COUNT scan (`hist2d_accumulate`,
`area_count_scan`).  Each function here validates its arrays, calls the C
function and counts the call in tracing's counter "native.<function>"
(the callers count their numpy fallbacks in "numpy.<function>"); the
numpy version of each stays beside its caller (emulator/events.py,
io/aedat2.py, render/renderer.py) as the plain version, which equals the
library bit for bit: the build passes -ffp-contract=off, so no
multiply-add is fused.

The library is built into ``v2e_tpu_torch/_build/`` (git-ignored) and
rebuilt when the source is newer.  A host without g++, or where the build
fails, gets None from `get_lib` (logged once at WARNING) and the callers
take their numpy versions.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from v2e_tpu_torch import tracing

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "aer_kernels.cpp")
LIBRARY = os.path.join(os.path.dirname(_HERE), "_build", "libaer_kernels.so")
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"  # concurrent builders never share a file
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning(f"native AER library did not build ({e} {detail.decode()[-400:]}); "
                       "using the numpy versions")
        return False
    os.replace(tmp, LIBRARY)
    return True


def _bind(lib: ctypes.CDLL) -> None:
    i64, f32, f64, vp = ctypes.c_int64, ctypes.c_float, ctypes.c_double, ctypes.c_void_p
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    sigs = {
        "hist2d_accumulate": ([p_f64, i64, i64, i64, f32, p_f32], None),
        "area_count_scan": ([p_f64, i64, i64, i64, i64, p_i64, i64, i64], i64),
        "materialize_frame": ([p_i16, p_i16, i64, i64, i64, f64, f64, f64,
                               vp, vp, i64, p_f64, vp, i64], i64),
        "count_frame_events": ([p_i16, i64, vp, vp], i64),
        "materialize_sparse": ([p_i32, p_i16, p_i16, vp, i64,
                                p_i64, p_i64, p_f64, p_f64, p_f64,
                                i64, i64, i64, vp, p_f64, vp, p_i64], i64),
        "pack_aedat2": ([p_f64, i64, i64, i64, i64, i64, i64, ctypes.c_int32,
                         vp, p_i32], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if missing or older than its
    source; None when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if (not os.path.isfile(LIBRARY)
                or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            logger.warning(f"could not load {LIBRARY} ({e}); using the numpy versions")
            return None
        _bind(lib)
        _lib = lib
        logger.info(f"native AER library loaded from {LIBRARY}")
        return _lib


def have_native() -> bool:
    return get_lib() is not None


def _events(events: np.ndarray) -> np.ndarray:
    ev = np.ascontiguousarray(events, dtype=np.float64)
    if ev.ndim != 2 or ev.shape[1] != 4:
        raise ValueError(f"events must be [N,4], got {ev.shape}")
    return ev


def _u8(mask: Optional[np.ndarray], n: int) -> Optional[np.ndarray]:
    if mask is None:
        return None
    m = np.ascontiguousarray(mask, dtype=np.uint8).reshape(-1)
    if m.shape[0] != n:
        raise ValueError(f"mask of {m.shape[0]} entries for {n}")
    return m


def _ptr(a: Optional[np.ndarray]):
    return a.ctypes.data if a is not None else None


def hist2d_accumulate(frame: np.ndarray, events: np.ndarray, full_scale: float) -> None:
    """Add the events' signed ON-OFF histogram into `frame` (f32 [H,W],
    C-contiguous, in place), then clip it to +-full_scale."""
    if frame.dtype != np.float32 or not frame.flags.c_contiguous or frame.ndim != 2:
        raise ValueError("frame must be a C-contiguous float32 [H,W] array")
    ev = _events(events)
    H, W = frame.shape
    get_lib().hist2d_accumulate(ev, ev.shape[0], H, W, float(full_scale), frame)
    tracing.count("native.hist2d_accumulate")


def area_count_scan(events: np.ndarray, start: int, area_dimension: int,
                    area_count: int, counts: np.ndarray) -> int:
    """Count events from `start` into `counts` (int64 [nw,nh], in place) by
    area until one reaches `area_count`; returns that event's index (counts
    reset to 0) or N."""
    if counts.dtype != np.int64 or not counts.flags.c_contiguous or counts.ndim != 2:
        raise ValueError("counts must be a C-contiguous int64 [nw,nh] array")
    ev = _events(events)
    nw, nh = counts.shape
    i = get_lib().area_count_scan(ev, ev.shape[0], int(start), int(area_dimension),
                                  int(area_count), counts, nw, nh)
    tracing.count("native.area_count_scan")
    return int(i)


def count_frame_events(ev_count: np.ndarray, shot_on: Optional[np.ndarray] = None,
                       shot_off: Optional[np.ndarray] = None) -> int:
    """Events one frame materializes: sum |count| plus its shot pixels."""
    c = np.ascontiguousarray(ev_count, dtype=np.int16).reshape(-1)
    on, off = _u8(shot_on, c.shape[0]), _u8(shot_off, c.shape[0])
    if (on is None) != (off is None):
        raise ValueError("shot_on and shot_off go together")
    n = get_lib().count_frame_events(c, c.shape[0], _ptr(on), _ptr(off))
    tracing.count("native.count_frame_events")
    return int(n)


def materialize_frame(
    ev_count: np.ndarray, i0: np.ndarray, stride: int, K: int,
    t_prev: float, s: float, t_frame: float,
    shot_on: Optional[np.ndarray] = None, shot_off: Optional[np.ndarray] = None,
    label_signal_noise: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One frame's events f64[N,4] in iteration-major, raster order (times
    t_prev + (it+1)*s), then the shot events at t_frame (ON then OFF), and
    the signal(1)/noise(0) labels when asked."""
    H, W = ev_count.shape
    c = np.ascontiguousarray(ev_count, dtype=np.int16).reshape(-1)
    first = np.ascontiguousarray(i0, dtype=np.int16).reshape(-1)
    if first.shape[0] != c.shape[0]:
        raise ValueError(f"i0 of shape {i0.shape} for counts {ev_count.shape}")
    on, off = _u8(shot_on, c.shape[0]), _u8(shot_off, c.shape[0])
    if (on is None) != (off is None):
        raise ValueError("shot_on and shot_off go together")
    total = count_frame_events(c, on, off)
    out = np.empty((total, 4), dtype=np.float64)
    lab = np.empty(total, dtype=np.uint8) if label_signal_noise else None
    written = get_lib().materialize_frame(
        c, first, int(stride), H, W, float(t_prev), float(s), float(t_frame),
        _ptr(on), _ptr(off), int(K), out.reshape(-1), _ptr(lab), total,
    )
    tracing.count("native.materialize_frame")
    if written < 0:
        raise RuntimeError("native materialize_frame overflowed its buffer")
    return out[:written], (lab[:written].astype(bool) if lab is not None else None)


def pack_aedat2(events: np.ndarray, sizex: int, sizey: int, xshift: int, yshift: int,
                polshift: int, flip: bool, noise_mask: Optional[np.ndarray] = None
                ) -> np.ndarray:
    """AEDAT-2 (address, timestamp) int32 pairs [2N] in native byte order;
    x and y mirrored when `flip`; an event whose `noise_mask` entry is 0
    gets address bit 10."""
    ev = _events(events)
    n = ev.shape[0]
    mask = _u8(noise_mask, n)
    out = np.empty(2 * n, dtype=np.int32)
    get_lib().pack_aedat2(ev, n, int(sizex), int(sizey), int(xshift), int(yshift),
                          int(polshift), 1 if flip else 0, _ptr(mask), out)
    tracing.count("native.pack_aedat2")
    return out


def materialize_sparse(
    idx: np.ndarray, count: np.ndarray, i0: np.ndarray, shot: Optional[np.ndarray],
    stride: np.ndarray, K: np.ndarray, t0: np.ndarray, tf: np.ndarray, s: np.ndarray,
    H: int, W: int, rng: Optional[np.random.Generator] = None,
    label_signal_noise: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """A chunk's events from its compacted cells, ordered by (frame,
    iteration, kind[, a random key from `rng`]), with the labels and the
    frame offsets [F+1]; `t0`, `tf` and `s` are each frame's absolute start
    and end times and its grid step."""
    n_entries = idx.shape[0]
    idx32 = np.ascontiguousarray(idx, dtype=np.int32)
    c16 = np.ascontiguousarray(count, dtype=np.int16)
    i16 = np.ascontiguousarray(i0, dtype=np.int16)
    shot8 = _u8(shot, n_entries)
    if c16.shape[0] != n_entries or i16.shape[0] != n_entries:
        raise ValueError("idx, count and i0 must have one entry per cell")
    F = K.shape[0]
    per_frame = [np.ascontiguousarray(a, dtype=dt) for a, dt in
                 ((stride, np.int64), (K, np.int64), (t0, np.float64),
                  (tf, np.float64), (s, np.float64))]
    if any(a.shape != (F,) for a in per_frame):
        raise ValueError("stride, K, t0, tf and s must each have one entry per frame")
    total = int(np.abs(c16.astype(np.int64)).sum())
    if shot8 is not None:
        total += int(np.count_nonzero(shot8 & 1)) + int(np.count_nonzero(shot8 & 2))
    rand_keys = rng.random(total) if rng is not None else None
    events = np.empty((total, 4), dtype=np.float64)
    lab = np.empty(total, dtype=np.uint8) if label_signal_noise else None
    offsets = np.zeros(F + 1, dtype=np.int64)
    n = get_lib().materialize_sparse(
        idx32, c16, i16, _ptr(shot8), n_entries, *per_frame, F, int(H), int(W),
        _ptr(rand_keys), events.reshape(-1), _ptr(lab), offsets,
    )
    tracing.count("native.materialize_sparse")
    if n != total:
        raise RuntimeError(f"native materialize_sparse wrote {n} of {total} events")
    return events, (lab.astype(bool) if lab is not None else None), offsets
