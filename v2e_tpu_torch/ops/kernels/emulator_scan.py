"""K1 and K2: the emulator's sequential core, with and without the
refractory filter.

K1 replaces v2e_tpu/ops/pallas/emulator_scan.py::emulator_scan_refractory_pallas.
`refractory_scan` launches the CUDA kernel (csrc/emulator_scan.cu) for CUDA
tensors and runs `refractory_scan_plain`, the same math as a loop over
frames in PyTorch, for CPU tensors.  Design (see the source's note): one
cooperative, persistent launch per call, its grid no larger than what can
be resident; each thread owns a grid-strided set of pixels and keeps their
state in registers (in L2-resident global memory on planes too large for
that), and per frame reduces the largest count K across the grid in a
barrier whose slots carry each block's maximum, then applies the filter.  Bound by
memory bytes, 13 B per pixel per frame (lp and leak f32, shot u8, counts
and i0 i16), and at the CLI's planes by the F grid barriers.  The TPU sent
planes above 256K pixels to the XLA scan; this kernel has no size limit.

K2 replaces v2e_tpu/ops/pallas/emulator_scan.py::emulator_scan_pallas, the
core of every configuration with R <= 0.  `scan` launches its kernel (same
source) for CUDA tensors and runs `scan_plain` for CPU tensors.  One launch
per chunk: a thread per pixel loops over the frames with base in a
register.  Bound by memory bytes: 11 B per pixel per frame (lp and leak
f32, shot u8, counts i16).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from v2e_tpu_torch.device import scalar
from v2e_tpu_torch.ops.core import I32_MAX_F, compute_event_map, fma_f32
from v2e_tpu_torch.ops.kernels import build

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def refractory_scan_plain(
    lp: torch.Tensor,
    leak_delta: Optional[torch.Tensor],
    shot_any: Optional[torch.Tensor],
    pos_thres: torch.Tensor,
    neg_thres: torch.Tensor,
    base: torch.Tensor,
    timestamp_mem: torch.Tensor,
    dts: torch.Tensor,
    t_prevs: torch.Tensor,
    refractory_period_s: float,
) -> Result:
    """The scan body of v2e_tpu emulator/core.py:931 as a loop over frames.

    Returns (new_base f32[H,W], new_mem f32[H,W], signed counts i16[F,H,W],
    i0 i16[F,H,W], K i32[F]).
    """
    F = lp.shape[0]
    R = scalar(refractory_period_s, lp)
    tiny = scalar(1e-12, lp)
    counts = torch.empty(lp.shape, dtype=torch.int16, device=lp.device)
    i0s = torch.empty_like(counts)
    Ks = torch.empty(F, dtype=torch.int32, device=lp.device)
    mem = timestamp_mem
    for f in range(F):
        if leak_delta is not None:
            base = base - leak_delta[f]
        pos, neg = compute_event_map(lp[f] - base, pos_thres, neg_thres)
        count = pos + neg
        K = count.max()
        ts_step = torch.maximum(dts[f], tiny) / torch.clamp(K, min=1).to(torch.float32)
        active = R > ts_step

        q = (mem + R - t_prevs[f]) / ts_step
        i0 = torch.clamp(torch.floor(q), 0.0, I32_MAX_F).to(torch.int32)
        m = torch.clamp(torch.floor(R / ts_step) + 1.0, max=I32_MAX_F).to(torch.int32)
        has = (count > 0) & (i0 <= count - 1)
        n_emit = torch.where(
            has,
            torch.div(count - 1 - i0, torch.clamp(m, min=1), rounding_mode="floor") + 1,
            0,
        )
        i_last = i0 + (n_emit - 1) * m
        t_last = fma_f32(i_last.to(torch.float32) + 1.0, ts_step, t_prevs[f])
        new_mem = torch.where(n_emit > 0, t_last, mem)
        n_emit = torch.where(active, n_emit, count)
        i0 = torch.where(active & has, i0, 0)
        mem = torch.where(active, new_mem, mem)

        final_pos = torch.where(pos > 0, n_emit, 0)
        final_neg = torch.where(neg > 0, n_emit, 0)
        base = fma_f32(final_pos.to(torch.float32), pos_thres, base)
        base = fma_f32(-final_neg.to(torch.float32), neg_thres, base)
        if shot_any is not None:
            base = torch.where(shot_any[f] != 0, lp[f], base)
        counts[f] = (final_pos - final_neg).to(torch.int16)
        i0s[f] = i0.to(torch.int16)
        Ks[f] = K
    return base, mem, counts, i0s, Ks


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def refractory_scan(
    lp: torch.Tensor,
    leak_delta: Optional[torch.Tensor],
    shot_any: Optional[torch.Tensor],
    pos_thres: torch.Tensor,
    neg_thres: torch.Tensor,
    base: torch.Tensor,
    timestamp_mem: torch.Tensor,
    dts: torch.Tensor,
    t_prevs: torch.Tensor,
    refractory_period_s: float,
) -> Result:
    """K1 wrapper: the kernel for CUDA tensors, the plain version for CPU.

    lp and leak_delta f32[F,H,W]; shot_any u8[F,H,W] (nonzero where shot
    noise fired); thresholds, base and timestamp_mem f32[H,W]; dts and
    t_prevs f32[F].  Leak and shot may be None.  Inputs are not modified.
    """
    if not lp.is_cuda:
        return refractory_scan_plain(
            lp, leak_delta, shot_any, pos_thres, neg_thres, base,
            timestamp_mem, dts, t_prevs, refractory_period_s,
        )
    F, H, W = lp.shape
    dev = lp.device
    f32 = torch.float32
    _check("lp", lp, f32, (F, H, W), dev)
    if leak_delta is not None:
        _check("leak_delta", leak_delta, f32, (F, H, W), dev)
    if shot_any is not None:
        _check("shot_any", shot_any, torch.uint8, (F, H, W), dev)
    for name, t in (("pos_thres", pos_thres), ("neg_thres", neg_thres),
                    ("base", base), ("timestamp_mem", timestamp_mem)):
        _check(name, t, f32, (H, W), dev)
    _check("dts", dts, f32, (F,), dev)
    _check("t_prevs", t_prevs, f32, (F,), dev)

    new_base = base.clone()
    new_mem = timestamp_mem.clone()
    counts = torch.empty((F, H, W), dtype=torch.int16, device=dev)
    i0 = torch.empty_like(counts)
    grid = refractory_grid(H * W, dev)
    # K, then the grid barrier's 2 x blocks 64-bit slots, zeroed
    k_buf = torch.zeros(F + F % 2 + 4 * grid[0], dtype=torch.int32, device=dev)
    lib = build.load("emulator_scan")
    fn = lib.v2e_refractory_scan
    fn.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _ptr(lp), _ptr(leak_delta), _ptr(shot_any), _ptr(pos_thres),
            _ptr(neg_thres), _ptr(new_base), _ptr(new_mem), _ptr(dts),
            _ptr(t_prevs), _ptr(k_buf), _ptr(counts), _ptr(i0),
            F, H * W, float(refractory_period_s), ctypes.c_void_p(stream),
        )
    build.check(err, "refractory_scan")
    refractory_scan.launches += 1
    refractory_scan.last_call = ((F, H, W), grid)
    return new_base, new_mem, counts, i0, k_buf[:F]


def refractory_grid(npix: int, device: torch.device) -> Tuple[int, int, int]:
    """(blocks, threads per block, pixels per thread held in registers, 0
    for the global-state form) of K1's cooperative launch for `npix`
    pixels on `device`."""
    key = (npix, device.index)
    if key in _GRIDS:
        return _GRIDS[key]
    fn = build.load("emulator_scan").v2e_refractory_scan_grid
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = fn(npix, *(ctypes.byref(v) for v in out))
    build.check(err, "refractory_grid")
    _GRIDS[key] = tuple(v.value for v in out)
    return _GRIDS[key]


_GRIDS = {}


# kernel launches made by `refractory_scan` (one per call), and the last
# call's ([F,H,W], (blocks, threads, pixels per thread in registers))
refractory_scan.launches = 0
refractory_scan.last_call = None


def scan_plain(
    lp: torch.Tensor,
    leak_delta: Optional[torch.Tensor],
    shot_any: Optional[torch.Tensor],
    pos_thres: torch.Tensor,
    neg_thres: torch.Tensor,
    base: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The refractory-free core (v2e_tpu emulator_scan.py::_kernel, and the
    scan body of emulator/core.py:931 at R <= 0) as a loop over frames.

    Returns (new_base f32[H,W], signed counts i16[F,H,W]).
    """
    counts = torch.empty(lp.shape, dtype=torch.int16, device=lp.device)
    for f in range(lp.shape[0]):
        if leak_delta is not None:
            base = base - leak_delta[f]
        pos, neg = compute_event_map(lp[f] - base, pos_thres, neg_thres)
        base = fma_f32(pos.to(torch.float32), pos_thres, base)
        base = fma_f32(-neg.to(torch.float32), neg_thres, base)
        if shot_any is not None:
            base = torch.where(shot_any[f] != 0, lp[f], base)
        counts[f] = (pos - neg).to(torch.int16)
    return base, counts


def scan(
    lp: torch.Tensor,
    leak_delta: Optional[torch.Tensor],
    shot_any: Optional[torch.Tensor],
    pos_thres: torch.Tensor,
    neg_thres: torch.Tensor,
    base: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 wrapper: the kernel for CUDA tensors, the plain version for CPU.

    lp and leak_delta f32[F,H,W]; shot_any u8[F,H,W] (nonzero where shot
    noise fired); thresholds and base f32[H,W].  Leak and shot may be None.
    Inputs are not modified.  Returns (new_base, signed counts i16[F,H,W]).
    """
    scan.last_call = tuple(lp.shape)
    if not lp.is_cuda:
        return scan_plain(lp, leak_delta, shot_any, pos_thres, neg_thres, base)
    F, H, W = lp.shape
    dev = lp.device
    f32 = torch.float32
    _check("lp", lp, f32, (F, H, W), dev)
    if leak_delta is not None:
        _check("leak_delta", leak_delta, f32, (F, H, W), dev)
    if shot_any is not None:
        _check("shot_any", shot_any, torch.uint8, (F, H, W), dev)
    for name, t in (("pos_thres", pos_thres), ("neg_thres", neg_thres), ("base", base)):
        _check(name, t, f32, (H, W), dev)

    new_base = base.clone()
    counts = torch.empty((F, H, W), dtype=torch.int16, device=dev)
    fn = build.load("emulator_scan").v2e_scan
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _ptr(lp), _ptr(leak_delta), _ptr(shot_any), _ptr(pos_thres),
            _ptr(neg_thres), _ptr(new_base), _ptr(counts), F, H * W,
            ctypes.c_void_p(stream),
        )
    build.check(err, "scan")
    scan.launches += 1
    return new_base, counts


# kernel launches made by `scan` (one per chunk), and the last call's [F,H,W]
scan.launches = 0
scan.last_call = None
