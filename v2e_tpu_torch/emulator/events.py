"""Host-side AER event materialization (port of
v2e_tpu/emulator/events.py).

Each compacted cell expands into |count| events at iterations
``i0 + j*stride`` of its frame's sub-frame timestamp grid
``t_prev + (i+1) * dt/K``; the chunk is ordered by (frame, iteration[,
random tie-break]), with shot-noise events after the signal events of
their frame at the frame's end time.  Timestamps are float64.

Each function runs in the port's native library (v2e_tpu_torch/native)
when it builds, and otherwise in numpy; the numpy versions
(`materialize_events_sparse_numpy`, `materialize_frame_numpy`) are the
plain versions, equal to the library bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from v2e_tpu_torch import native, tracing


def materialize_frame(
    ev_count: np.ndarray,
    i0: np.ndarray,
    stride: int,
    K: int,
    t_prev: float,
    t_frame: float,
    shot_on: Optional[np.ndarray] = None,
    shot_off: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
    label_signal_noise: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Materialize one frame's events (the dense per-frame path).

    Args:
      ev_count: i16[H,W] signed final counts (+ON / -OFF).
      i0: i16[H,W] first emitted iteration per pixel.
      stride: iteration stride between a pixel's successive events.
      K: sub-frame timestamp grid size (max candidate count).
      t_prev, t_frame: absolute interval bounds in float64 seconds.
      shot_on, shot_off: optional bool[H,W] shot-noise maps.
      rng: numpy Generator for the within-iteration shuffle (None = no
        shuffle).  As in the JAX package, the native path shuffles events
        of equal time after materializing (shot events included) and the
        numpy path shuffles the signal events within iterations, so the
        two draw differently.
      label_signal_noise: also return a bool[N] signal(1)/noise(0) array.

    Returns:
      (events f64[N,4], labels bool[N] or None)
    """
    s = (t_frame - t_prev) / max(int(K), 1)
    if not native.have_native():
        tracing.count("numpy.materialize_frame")
        return materialize_frame_numpy(ev_count, i0, stride, K, t_prev, t_frame,
                                       shot_on, shot_off, rng, label_signal_noise)
    if shot_on is not None and shot_on.shape != ev_count.shape:
        raise ValueError(
            f"shot map shape {shot_on.shape} != count map shape {ev_count.shape}"
        )
    ev, lab = native.materialize_frame(
        ev_count, i0, stride, K, t_prev, s, t_frame, shot_on, shot_off,
        label_signal_noise,
    )
    if rng is not None and ev.shape[0] > 1:
        # random within equal timestamps, stable in time
        order = np.lexsort((rng.random(ev.shape[0]), ev[:, 0]))
        ev = ev[order]
        if lab is not None:
            lab = lab[order]
    return ev, lab


def materialize_frame_numpy(
    ev_count: np.ndarray,
    i0: np.ndarray,
    stride: int,
    K: int,
    t_prev: float,
    t_frame: float,
    shot_on: Optional[np.ndarray] = None,
    shot_off: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
    label_signal_noise: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The numpy version of `materialize_frame`."""
    H, W = ev_count.shape
    s = (t_frame - t_prev) / max(int(K), 1)
    c = ev_count.ravel().astype(np.int64)
    nz = np.flatnonzero(c)
    parts = []
    labels = []

    if nz.size:
        cc = np.abs(c[nz])
        pol = np.where(c[nz] > 0, 1.0, -1.0)
        i0f = i0.ravel()[nz].astype(np.int64)
        tot = int(cc.sum())
        rep = np.repeat(np.arange(nz.size), cc)
        offsets = np.concatenate(([0], np.cumsum(cc)))
        j = np.arange(tot, dtype=np.int64) - offsets[rep]
        iteration = i0f[rep] + j * int(stride)
        if rng is not None:
            order = np.lexsort((rng.random(tot), iteration))
        else:
            order = np.argsort(iteration, kind="stable")
        pix = nz[rep][order]
        it = iteration[order]
        ev = np.empty((tot, 4), dtype=np.float64)
        ev[:, 0] = t_prev + (it + 1) * s
        ev[:, 1] = pix % W
        ev[:, 2] = pix // W
        ev[:, 3] = pol[rep][order]
        parts.append(ev)
        if label_signal_noise:
            labels.append(np.ones(tot, dtype=bool))

    if shot_on is not None:
        on_pix = np.flatnonzero(shot_on.ravel())
        off_pix = np.flatnonzero(shot_off.ravel())
        n_shot = on_pix.size + off_pix.size
        if n_shot:
            ev = np.empty((n_shot, 4), dtype=np.float64)
            ev[:, 0] = t_frame
            ev[: on_pix.size, 1] = on_pix % W
            ev[: on_pix.size, 2] = on_pix // W
            ev[: on_pix.size, 3] = 1.0
            ev[on_pix.size:, 1] = off_pix % W
            ev[on_pix.size:, 2] = off_pix // W
            ev[on_pix.size:, 3] = -1.0
            parts.append(ev)
            if label_signal_noise:
                labels.append(np.zeros(n_shot, dtype=bool))

    if not parts:
        empty = np.empty((0, 4), dtype=np.float64)
        return empty, (np.empty(0, dtype=bool) if label_signal_noise else None)
    events = np.concatenate(parts) if len(parts) > 1 else parts[0]
    lab = None
    if label_signal_noise:
        lab = np.concatenate(labels) if len(labels) > 1 else labels[0]
    return events, lab


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
    """Materialize a whole chunk from device-compacted sparse entries: the
    outputs of `core.compact_chunk` (fetched to the host, trimmed to the
    occupied cells) and the per-frame arrays [F].

    Runs in the native library when it builds, else in numpy
    (`materialize_events_sparse_numpy`); both give the same events, the
    shuffled case included (the random tie-break keys are drawn from `rng`
    in the same order).

    Returns (events f64[N,4], labels, frame_offsets i64[F+1]).
    """
    # each frame's absolute start and end times and grid step, in float64
    t0 = t_origin + t_prev.astype(np.float64)
    tf = t_origin + t_frame.astype(np.float64)
    s = (t_frame.astype(np.float64) - t_prev.astype(np.float64)) / np.maximum(
        K.astype(np.int64), 1)
    args = (idx, count, i0, shot, stride, K, t0, tf, s, H, W, rng, label_signal_noise)
    if native.have_native():
        return native.materialize_sparse(*args)
    tracing.count("numpy.materialize_sparse")
    return materialize_events_sparse_numpy(*args)


def materialize_events_sparse_numpy(
    idx: np.ndarray,
    count: np.ndarray,
    i0: np.ndarray,
    shot: Optional[np.ndarray],
    stride: np.ndarray,
    K: np.ndarray,
    t0_64: np.ndarray,
    tf_64: np.ndarray,
    s64: np.ndarray,
    H: int,
    W: int,
    rng: Optional[np.random.Generator] = None,
    label_signal_noise: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """The numpy version of `native.materialize_sparse` (the same
    arguments: each frame's absolute start and end times and grid step in
    float64).  Events are
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


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def materialize_events(
    outs: Dict[str, np.ndarray],
    t_origin: float,
    rng: Optional[np.random.Generator] = None,
    label_signal_noise: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Materialize a whole chunk of frames from its dense per-frame maps,
    frame by frame (`materialize_frame`).

    Args:
      outs: the per-frame outputs of `emulate_chunk` (leading axis F), as
        numpy arrays or tensors.
      t_origin: absolute float64 time of the chunk origin, added to the
        chunk-relative times.

    Returns:
      (events f64[N,4], labels bool[N] or None, frame_offsets i64[F+1]):
      ``events[frame_offsets[f]:frame_offsets[f+1]]`` are frame ``f``'s.
    """
    outs = {k: _host(v) for k, v in outs.items() if k != "states"}
    F = outs["ev_count"].shape[0]
    has_shot = "shot_on" in outs
    parts = []
    labels = []
    offsets = np.zeros(F + 1, dtype=np.int64)
    for f in range(F):
        ev, lab = materialize_frame(
            outs["ev_count"][f],
            outs["i0"][f],
            int(outs["stride"][f]),
            int(outs["K"][f]),
            t_origin + float(outs["t_prev"][f]),
            t_origin + float(outs["t_frame"][f]),
            shot_on=outs["shot_on"][f] if has_shot else None,
            shot_off=outs["shot_off"][f] if has_shot else None,
            rng=rng,
            label_signal_noise=label_signal_noise,
        )
        offsets[f + 1] = offsets[f] + ev.shape[0]
        parts.append(ev)
        if label_signal_noise:
            labels.append(lab)
    events = np.concatenate(parts) if parts else np.empty((0, 4), dtype=np.float64)
    lab = np.concatenate(labels) if (label_signal_noise and labels) else None
    return events, lab, offsets
