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

K1's two halves, `refractory_count` and `refractory_apply`, compute what K1
computes with its per-frame reduction of K lifted out of the kernel, for
pixel strips on several devices (parallel/mesh.py): a grid barrier cannot
span cards.  `refractory_count` is K1's step 1 for one frame (leak, counts,
the strip's largest count, by atomicMax), `refractory_apply` its step 3
(the filter constants from K, the filter, base update, shot reset, counts
and i0 stored), fused with the next frame's step 1, so a chunk of F frames
takes F + 1 launches per strip.  Each is an ordinary (not cooperative)
launch, a thread per pixel over a grid-stride loop, and rounds every
operation as K1 does, so strips equal K1 on the whole plane bit for bit.
Both update their state in place.  Bound by memory bytes: the count reads
lp, leak, base and the thresholds and writes base, the apply reads lp,
shot, base, memory and the thresholds and writes base, memory, counts and
i0 (57 B per pixel-frame in all, against K1's 13 B), and at the CLI's
planes by the 2 launches and the host's cross-strip reduction per frame.

K2 replaces v2e_tpu/ops/pallas/emulator_scan.py::emulator_scan_pallas, the
core of every configuration with R <= 0.  `scan` launches its kernel (same
source) for CUDA tensors and runs `scan_plain` for CPU tensors.  One launch
per chunk, bound by memory bytes: 11 B per pixel per frame (lp and leak
f32, shot u8, counts i16).  Design (see the source's note): one persistent
block per SM owns a strip of whole 16-pixel units, walked in tiles of at
most 992 pixels with a thread per pixel and its base in a register; one
producer thread keeps a ring of 6 stages of 4 frames each of the tile's
lp, leak and shot in flight in shared memory with bulk copies (1-D TMA),
so the loads of the coming frames overlap the arithmetic of this one.
`scan_plan` decides in Python everything that says which bytes a copy
moves (the tiles, each tile's interior frames, each stream's pointer
offset, its step per frame and its aligned interior), and the kernel reads
it from the plan.  tests/test_torch_scan_plan.py holds the plan on the
CPU, beside a model of the kernel's few lines that turn it into copies.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
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


def refractory_count_plain(lp, leak_delta, pos_thres, neg_thres, base, kmax, f) -> None:
    """K1's step 1 for frame f, in place: base -= leak[f]; kmax[f] = the
    largest count of the plane's pixels."""
    if leak_delta is not None:
        base.sub_(leak_delta[f])
    pos, neg = compute_event_map(lp[f] - base, pos_thres, neg_thres)
    kmax[f] = (pos + neg).max()


def refractory_apply_plain(lp, leak_delta, shot_any, pos_thres, neg_thres, base, mem, dts,
                           t_prevs, refractory_period_s, K, f, counts, i0s, kmax) -> None:
    """K1's step 3 for frame f given the frame's K (a 0-d int32 tensor), in
    place: the filter, base and memory updates, counts[f] and i0s[f]; then
    step 1 of frame f + 1 when there is one (`refractory_count_plain`)."""
    R = scalar(refractory_period_s, lp)
    pos, neg = compute_event_map(lp[f] - base, pos_thres, neg_thres)
    count = pos + neg
    ts_step = torch.maximum(dts[f], scalar(1e-12, lp)) / torch.clamp(K, min=1).to(torch.float32)
    active = R > ts_step
    q = (mem + R - t_prevs[f]) / ts_step
    i0 = torch.clamp(torch.floor(q), 0.0, I32_MAX_F).to(torch.int32)
    m = torch.clamp(torch.floor(R / ts_step) + 1.0, max=I32_MAX_F).to(torch.int32)
    has = (count > 0) & (i0 <= count - 1)
    n_emit = torch.where(
        has, torch.div(count - 1 - i0, torch.clamp(m, min=1), rounding_mode="floor") + 1, 0)
    i_last = i0 + (n_emit - 1) * m
    t_last = fma_f32(i_last.to(torch.float32) + 1.0, ts_step, t_prevs[f])
    new_mem = torch.where(n_emit > 0, t_last, mem)
    n_emit = torch.where(active, n_emit, count)
    i0 = torch.where(active & has, i0, 0)
    mem.copy_(torch.where(active, new_mem, mem))
    final_pos = torch.where(pos > 0, n_emit, 0)
    final_neg = torch.where(neg > 0, n_emit, 0)
    b = fma_f32(final_pos.to(torch.float32), pos_thres, base)
    b = fma_f32(-final_neg.to(torch.float32), neg_thres, b)
    if shot_any is not None:
        b = torch.where(shot_any[f] != 0, lp[f], b)
    base.copy_(b)
    counts[f] = (final_pos - final_neg).to(torch.int16)
    i0s[f] = i0.to(torch.int16)
    if f + 1 < lp.shape[0]:
        refractory_count_plain(lp, leak_delta, pos_thres, neg_thres, base, kmax, f + 1)


def _check_split(lp, leak_delta, shot_any, planes, f) -> None:
    F, H, W = lp.shape
    dev = lp.device
    _check("lp", lp, torch.float32, (F, H, W), dev)
    if leak_delta is not None:
        _check("leak_delta", leak_delta, torch.float32, (F, H, W), dev)
    if shot_any is not None:
        _check("shot_any", shot_any, torch.uint8, (F, H, W), dev)
    for name, t in planes:
        _check(name, t, torch.float32, (H, W), dev)
    if not 0 <= f < F:
        raise ValueError(f"frame {f} outside the chunk's {F} frames")


def refractory_count(lp, leak_delta, pos_thres, neg_thres, base, kmax, f: int) -> None:
    """K1's step 1 for frame f (see the module note), in place: the kernel
    for CUDA tensors, `refractory_count_plain` for CPU ones.

    lp and leak_delta f32[F,H,W] (leak may be None); thresholds and base
    f32[H,W]; kmax i32[F], its entry f zero before the call.
    """
    if not lp.is_cuda:
        return refractory_count_plain(lp, leak_delta, pos_thres, neg_thres, base, kmax, f)
    F, H, W = lp.shape
    _check_split(lp, leak_delta, None, (("pos_thres", pos_thres), ("neg_thres", neg_thres),
                                        ("base", base)), f)
    _check("kmax", kmax, torch.int32, (F,), lp.device)
    fn = _split_fn("v2e_refractory_count", 6, 2)
    with torch.cuda.device(lp.device):
        err = fn(_ptr(lp), _ptr(leak_delta), _ptr(pos_thres), _ptr(neg_thres), _ptr(base),
                 _ptr(kmax), f, H * W, torch.cuda.current_stream(lp.device).cuda_stream)
    build.check(err, "refractory_count")
    refractory_count.launches += 1


def refractory_apply(lp, leak_delta, shot_any, pos_thres, neg_thres, base, mem, dts, t_prevs,
                     refractory_period_s: float, K, f: int, counts, i0, kmax) -> None:
    """K1's step 3 for frame f, fused with step 1 of frame f + 1 (see the
    module note), in place: the kernel for CUDA tensors,
    `refractory_apply_plain` for CPU ones.

    K: the frame's largest count over every strip, a 0-d int32 tensor on
    lp's device; shot_any u8[F,H,W] or None; mem f32[H,W]; dts and
    t_prevs f32[F]; counts and i0 i16[F,H,W], frame f written; kmax i32[F],
    entry f + 1 zero before the call.
    """
    if not lp.is_cuda:
        return refractory_apply_plain(lp, leak_delta, shot_any, pos_thres, neg_thres, base, mem,
                                      dts, t_prevs, refractory_period_s, K, f, counts, i0, kmax)
    F, H, W = lp.shape
    dev = lp.device
    _check_split(lp, leak_delta, shot_any, (("pos_thres", pos_thres), ("neg_thres", neg_thres),
                                            ("base", base), ("mem", mem)), f)
    for name, t, dtype, shape in (("dts", dts, torch.float32, (F,)),
                                  ("t_prevs", t_prevs, torch.float32, (F,)),
                                  ("K", K, torch.int32, ()), ("kmax", kmax, torch.int32, (F,)),
                                  ("counts", counts, torch.int16, (F, H, W)),
                                  ("i0", i0, torch.int16, (F, H, W))):
        _check(name, t, dtype, shape, dev)
    fn = _split_fn("v2e_refractory_apply", 13, 3, with_r=True)
    with torch.cuda.device(dev):
        err = fn(_ptr(lp), _ptr(leak_delta), _ptr(shot_any), _ptr(pos_thres), _ptr(neg_thres),
                 _ptr(base), _ptr(mem), _ptr(dts), _ptr(t_prevs), _ptr(K), _ptr(kmax),
                 _ptr(counts), _ptr(i0), f, F, H * W, float(refractory_period_s),
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "refractory_apply")
    refractory_apply.launches += 1


@functools.cache
def _split_fn(name: str, n_ptrs: int, n_ints: int, with_r: bool = False):
    """The C entry point `name` of a K1 half: n_ptrs pointers, n_ints ints,
    the refractory period (a float) for the apply, then the stream."""
    fn = getattr(build.load("emulator_scan"), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * with_r + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# kernel launches made by each half (refractory_apply: one per frame and
# strip; refractory_count: one per chunk and strip)
refractory_count.launches = 0
refractory_apply.launches = 0


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


# K2's plan.  Strips and tiles start at multiples of UNIT_PX pixels, so
# every tile's slice of frame 0 starts, in each stream, at that stream's
# data pointer mod 16 bytes.  A tile has at most MAX_TILE_PX pixels, one
# per consumer thread, beside one producer warp (1024 threads).  The ring
# is RING stages of GROUP frames each, compile-time constants of the kernel
# (kScanRing, kScanGroup), behind BAR_BYTES of mbarriers; it fits the
# shared memory a block may have (SMEM_PER_BLOCK on an H100) at the largest
# tile.  Chosen on an H100 (PERF.md): 4 frames per stage over 1, 2 and 8;
# rings of 8 to 64 frames took the same time.
UNIT_PX = 16
MAX_TILE_PX = 992
GROUP = 4
RING = 6
BAR_BYTES = 128
MAX_BLOCKS = 512
SMEM_PER_BLOCK = 232_448


def _up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ScanPlan:
    """K2's launch plan (see `scan_plan`); the kernel reads every field
    (csrc/emulator_scan.cu, ScanPlan and its tile table).

    tiles: (t0, t1, f_lo, f_hi) per tile, block by block: pixels [t0, t1)
    and the interior frames [f_lo, f_hi], whose slices lie, in every
    stream, inside the tensor's aligned interior (their copies are the
    slices' whole granules, unclipped, and every element is staged);
    block_tiles: blocks + 1 indices, block b running tiles block_tiles[b]
    to block_tiles[b + 1] - 1; tile: the most pixels of a tile (a multiple
    of UNIT_PX), one per consumer thread.  Per stream (lp, leak, shot;
    None where absent): elem_sizes, bytes per element; offsets, the data
    pointer mod 16; steps, how far a slice's offset in its granule moves
    per frame; regions, the byte offset in a frame's part of a stage;
    bounds, (lo, hi) the tensor's aligned interior in bytes from the
    pointer's granule; staged, (first, end) the elements wholly inside it.
    frame_bytes: a frame's part of a stage.
    """

    npix: int
    n_frames: int
    tiles: Tuple[Tuple[int, int, int, int], ...]
    block_tiles: Tuple[int, ...]
    tile: int
    elem_sizes: Tuple[Optional[int], ...]
    offsets: Tuple[Optional[int], ...]
    steps: Tuple[Optional[int], ...]
    regions: Tuple[Optional[int], ...]
    bounds: Tuple[Optional[Tuple[int, int]], ...]
    staged: Tuple[Optional[Tuple[int, int]], ...]
    frame_bytes: int

    @property
    def blocks(self) -> int:
        return len(self.block_tiles) - 1

    @property
    def threads(self) -> int:
        return _up(self.tile, 32) + 32

    @property
    def smem_bytes(self) -> int:
        return BAR_BYTES + RING * GROUP * self.frame_bytes

    @property
    def strips(self) -> Tuple[int, ...]:
        """Block b owns pixels [strips[b], strips[b + 1])."""
        return tuple(self.tiles[k][0] for k in self.block_tiles[:-1]) + (self.npix,)


def scan_plan(
    npix: int,
    n_frames: int,
    sms: int,
    elem_sizes: Tuple[Optional[int], ...] = (4, 4, 1),
    ptr_offsets: Tuple[Optional[int], ...] = (0, 0, 0),
) -> ScanPlan:
    """K2's launch plan for `n_frames` frames of `npix` pixels on a card
    with `sms` SMs.

    elem_sizes: bytes per element of lp, leak and shot, None for a stream
    that is absent; ptr_offsets: each present stream's data pointer mod 16.
    One block per SM (fewer for a plane of fewer 16-pixel units), each
    owning a strip of whole units, the sizes differing by at most one
    unit: block b starts at unit floor(b * units / blocks), so the last
    block, whose last unit may be partial, has the most units.  A strip is
    cut into the fewest tiles of at most MAX_TILE_PX pixels, all but its
    last of equal size.
    """
    if npix < 1 or n_frames < 1 or sms < 1:
        raise ValueError(f"scan_plan: npix {npix}, n_frames {n_frames}, sms {sms}")
    if [e is None for e in elem_sizes] != [o is None for o in ptr_offsets] or elem_sizes[0] is None:
        raise ValueError(f"scan_plan: streams {elem_sizes} with offsets {ptr_offsets}")
    units = -(-npix // UNIT_PX)
    blocks = min(sms, units, MAX_BLOCKS)
    strips = [min(UNIT_PX * (b * units // blocks), npix) for b in range(blocks)] + [npix]
    longest = max(b - a for a, b in zip(strips, strips[1:]))
    tile = _up(-(-longest // -(-longest // MAX_TILE_PX)), UNIT_PX)
    steps, regions, bounds, staged = [], [], [], []
    off = 0
    for e, o in zip(elem_sizes, ptr_offsets):
        if e is None:
            for v in (steps, regions, bounds, staged):
                v.append(None)
            continue
        if not 0 <= o < 16 or o % e:
            raise ValueError(f"scan_plan: offset {o} for {e}-byte elements")
        steps.append(e * npix % 16)
        regions.append(off)
        # the granules of a slice of `tile` elements starting anywhere in one
        off += _up(tile * e + 15, 16)
        lo, hi = _up(o, 16), (o + e * n_frames * npix) & ~15
        bounds.append((lo, hi))
        staged.append((-(-(lo - o) // e), max((hi - o) // e, 0)))
    tiles, block_tiles = [], [0]
    for s0, s1 in zip(strips, strips[1:]):
        for t0 in range(s0, s1, tile):
            t1 = min(t0 + tile, s1)
            # the frames whose slice [r, r + n) lies in [lo, hi) in every stream
            f_lo, f_hi = 0, n_frames - 1
            for e, o, (lo, hi) in ((e, o, b) for e, o, b in zip(elem_sizes, ptr_offsets, bounds)
                                   if e is not None):
                f_lo = max(f_lo, -(-(lo - o - e * t0) // (e * npix)))
                f_hi = min(f_hi, (hi - o - e * t1) // (e * npix))
            tiles.append((t0, t1, f_lo, f_hi))
        block_tiles.append(len(tiles))
    return ScanPlan(npix, n_frames, tuple(tiles), tuple(block_tiles), tile, tuple(elem_sizes),
                    tuple(ptr_offsets), tuple(steps), tuple(regions), tuple(bounds),
                    tuple(staged), off)


class _CPlan(ctypes.Structure):
    """The kernel's ScanPlan (csrc/emulator_scan.cu)."""

    _fields_ = (
        [(n, ctypes.c_longlong * 3) for n in ("lo", "hi", "first", "end")]
        + [(n, ctypes.c_int) for n in (
            "npix", "n_frames", "blocks", "threads", "tile", "frame_bytes", "smem_bytes")]
        + [(n, ctypes.c_int * 3) for n in ("region", "offset", "step")]
        + [("block_tiles", ctypes.c_int * (MAX_BLOCKS + 1))]
    )


def c_plan(plan: ScanPlan) -> _CPlan:
    """The plan as the kernel takes it (absent streams: region -1, the
    rest 0)."""
    c = _CPlan(npix=plan.npix, n_frames=plan.n_frames, blocks=plan.blocks,
               threads=plan.threads, tile=plan.tile, frame_bytes=plan.frame_bytes,
               smem_bytes=plan.smem_bytes)
    for s in range(3):
        present = plan.elem_sizes[s] is not None
        c.region[s] = plan.regions[s] if present else -1
        c.offset[s] = plan.offsets[s] if present else 0
        c.step[s] = plan.steps[s] if present else 0
        c.lo[s], c.hi[s] = plan.bounds[s] if present else (0, 0)
        c.first[s], c.end[s] = plan.staged[s] if present else (0, 0)
    c.block_tiles[: plan.blocks + 1] = plan.block_tiles
    return c


def stream_layout(
    lp: torch.Tensor, leak_delta: Optional[torch.Tensor], shot_any: Optional[torch.Tensor],
) -> Tuple[Tuple[Optional[int], ...], Tuple[Optional[int], ...]]:
    """scan_plan's elem_sizes and ptr_offsets for these inputs."""
    ts = (lp, leak_delta, shot_any)
    return (tuple(None if t is None else t.element_size() for t in ts),
            tuple(None if t is None else t.data_ptr() % 16 for t in ts))


@functools.cache
def _device_plan(npix: int, n_frames: int, device_index: int, elem_sizes, ptr_offsets):
    """The plan, its C struct and its tile table on the device, made once
    for each plane, frame count, card, streams and pointer offsets: a call
    must not spend its time planning."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    plan = scan_plan(npix, n_frames, sms, elem_sizes, ptr_offsets)
    tiles = torch.tensor(plan.tiles, dtype=torch.int32, device=torch.device("cuda", device_index))
    return plan, c_plan(plan), tiles


@functools.cache
def _scan_fn():
    lib = build.load("emulator_scan")
    lib.v2e_scan_plan_bytes.restype = ctypes.c_int
    if lib.v2e_scan_plan_bytes() != ctypes.sizeof(_CPlan):
        raise RuntimeError(f"scan: the kernel's ScanPlan is {lib.v2e_scan_plan_bytes()} "
                           f"bytes, _CPlan {ctypes.sizeof(_CPlan)}")
    fn = lib.v2e_scan
    fn.argtypes = [ctypes.POINTER(_CPlan)] + [ctypes.c_void_p] * 10
    fn.restype = ctypes.c_int
    return fn


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
    A shared memory request the card refuses, or a failed launch, raises.
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

    counts = torch.empty((F, H, W), dtype=torch.int16, device=dev)
    if F == 0 or H * W == 0:
        return base.clone(), counts
    plan, cplan, tiles = _device_plan(
        H * W, F, dev.index, *stream_layout(lp, leak_delta, shot_any))
    new_base = torch.empty_like(base)
    with torch.cuda.device(dev):
        err = _scan_fn()(
            ctypes.byref(cplan), tiles.data_ptr(), lp.data_ptr(),
            _ptr(leak_delta), _ptr(shot_any), pos_thres.data_ptr(), neg_thres.data_ptr(),
            base.data_ptr(), new_base.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "scan")
    scan.launches += 1
    scan.last_plan = plan
    return new_base, counts


# kernel launches made by `scan` (one per chunk), the last call's [F,H,W]
# and the last launch's plan
scan.launches = 0
scan.last_call = None
scan.last_plan = None
