"""Host-side AER event materialization (port of the numpy path of
v2e_tpu/emulator/events.py::materialize_events_sparse).

Each compacted cell expands into |count| events at iterations
``i0 + j*stride`` of its frame's sub-frame timestamp grid
``t_prev + (i+1) * dt/K``; the chunk is ordered by (frame, iteration[,
random tie-break]), with shot-noise events after the signal events of
their frame at the frame's end time.  Timestamps are float64.  The JAX
package's g++ fast path is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def materialize_events_sparse(
    idx: np.ndarray,
    count: np.ndarray,
    i0: np.ndarray,
    shot: Optional[np.ndarray],
    stride: np.ndarray,
    K: np.ndarray,
    t_prev: np.ndarray,
    t_frame: np.ndarray,
    H: int,
    W: int,
    t_origin: float,
    rng: Optional[np.random.Generator] = None,
    label_signal_noise: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Materialize a whole chunk from device-compacted sparse entries.

    Inputs are the (host-fetched, fill-trimmed) outputs of
    `core.compact_chunk` plus the per-frame scalar arrays [F].  Events are
    produced fully vectorized across all frames in one pass: each entry
    expands into |count| events at iterations i0 + j*stride of its frame's
    timestamp grid, then a single lexsort orders the chunk by (frame,
    iteration[, random within ties]); shot-noise events sort after the
    signal events of their frame via a one-past-the-end iteration key.

    Returns (events f64[N,4], labels, frame_offsets i64[F+1]).
    """
    F = len(K)
    HW = H * W
    Kf = np.maximum(K.astype(np.int64), 1)
    dt64 = t_frame.astype(np.float64) - t_prev.astype(np.float64)
    s64 = dt64 / Kf
    t0_64 = t_origin + t_prev.astype(np.float64)
    tf_64 = t_origin + t_frame.astype(np.float64)

    frame_of = idx // HW
    pix = idx % HW
    cc = np.abs(count.astype(np.int64))

    # --- expand signal events ---
    total = int(cc.sum())
    parts_t = []
    parts_x = []
    parts_y = []
    parts_p = []
    parts_f = []
    parts_it = []
    parts_sub = []  # 0 signal, 1 shot-on, 2 shot-off (orders ties)
    if total:
        nz = np.flatnonzero(cc)
        cce = cc[nz]
        rep = np.repeat(nz, cce)
        offsets = np.zeros(len(nz) + 1, dtype=np.int64)
        np.cumsum(cce, out=offsets[1:])
        j = np.arange(total, dtype=np.int64) - offsets[
            np.repeat(np.arange(len(nz)), cce)
        ]
        fr = frame_of[rep]
        it = i0[rep].astype(np.int64) + j * stride[fr].astype(np.int64)
        parts_t.append(t0_64[fr] + (it + 1) * s64[fr])
        parts_x.append(pix[rep] % W)
        parts_y.append(pix[rep] // W)
        parts_p.append(np.where(count[rep] > 0, 1.0, -1.0))
        parts_f.append(fr)
        parts_it.append(it)
        parts_sub.append(np.zeros(total, dtype=np.int8))

    if shot is not None:
        for bit, pol, sub in ((1, 1.0, 1), (2, -1.0, 2)):
            sel = np.flatnonzero(shot & bit)
            if sel.size:
                fr = frame_of[sel]
                parts_t.append(tf_64[fr])
                parts_x.append(pix[sel] % W)
                parts_y.append(pix[sel] // W)
                parts_p.append(np.full(sel.size, pol))
                parts_f.append(fr)
                parts_it.append(Kf[fr])  # one past the signal grid
                parts_sub.append(np.full(sel.size, sub, dtype=np.int8))

    if not parts_t:
        empty = np.empty((0, 4), dtype=np.float64)
        lab = np.empty(0, dtype=bool) if label_signal_noise else None
        return empty, lab, np.zeros(F + 1, dtype=np.int64)

    t = np.concatenate(parts_t)
    x = np.concatenate(parts_x)
    y = np.concatenate(parts_y)
    p = np.concatenate(parts_p)
    fr = np.concatenate(parts_f)
    it = np.concatenate(parts_it)
    sub = np.concatenate(parts_sub)

    keys = [sub, it, fr] if rng is None else [rng.random(t.shape[0]), sub, it, fr]
    order = np.lexsort(tuple(keys))
    events = np.empty((t.shape[0], 4), dtype=np.float64)
    events[:, 0] = t[order]
    events[:, 1] = x[order]
    events[:, 2] = y[order]
    events[:, 3] = p[order]
    lab = None
    if label_signal_noise:
        lab = (sub[order] == 0)

    frame_offsets = np.searchsorted(fr[order], np.arange(F + 1), side="left")
    return events, lab, frame_offsets.astype(np.int64)
