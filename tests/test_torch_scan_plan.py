"""K2's launch plan (v2e_tpu_torch/ops/kernels/emulator_scan.py::scan_plan)
and the copies it decides, on the CPU.

The plan holds every number that says which bytes the kernel's bulk copies
move: the tiles, each tile's interior frames, and per stream its data
pointer's offset mod 16, that offset's step per frame and the tensor's
aligned interior.  The kernel reads them from the plan; what it computes
itself is copy_range (a slice's granules, clipped outside the interior
frames) and the running offsets, modelled here by `copy_range` and
`plan_copy`.  So these tests hold the plan the kernel is given, and a
Python model of the few lines that turn it into copies, not the kernel;
the kernel itself runs only on the card (tests/test_torch_kernels_gpu.py).

At the planes the port runs (260x346, 37x301, 720x1280) and at 1 and 17
pixels, with each stream's data pointer 0, 1 or 3 elements past a 512-byte
boundary: every pixel of every frame read exactly once, every copy 16-byte
aligned, a multiple of 16 bytes and inside its tensor, the interior frames
exact, strips even to one 16-pixel unit, and the ring inside the 227 KB of
shared memory a block may have.  F = 17 frames reach every offset a
frame's slice can have mod 16 bytes.
"""
import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import pytest
import torch

from v2e_tpu_torch.ops.kernels.emulator_scan import (
    BAR_BYTES,
    GROUP,
    MAX_TILE_PX,
    RING,
    SMEM_PER_BLOCK,
    UNIT_PX,
    c_plan,
    scan_plan,
    stream_layout,
)

SMS = 132  # an H100's SMs
F = 17
PLANES = [(260, 346), (37, 301), (720, 1280), (1, 1), (1, 17)]
PLANE_IDS = [f"{h}x{w}" for h, w in PLANES]
ALL_STREAMS = (4, 4, 1)  # lp f32, leak f32, shot u8
STREAM_SETS = {"noisy": (4, 4, 1), "clean": (4, None, None),
               "leak_only": (4, 4, None), "shot_only": (4, None, 1)}
# each tensor at its own 512-byte-aligned allocation, as the caching
# allocator hands them out
BASES = (0x7F00_0000_0000, 0x7F10_0000_0000, 0x7F20_0000_0000)


def copy_range(r: int, n: int, interior: bool, lo: int, hi: int) -> Tuple[int, int, int]:
    """The kernel's copy_range: one stream's copy for one frame of a tile,
    in bytes from the stream's granule (its data pointer rounded down to
    16): the 16-byte granules that hold the slice [r, r + n), clipped to
    the tensor's aligned interior [lo, hi) unless the frame is interior.
    Returns (src, size, dst): the first byte, the bytes (a multiple of 16,
    0 for none), and the copy's offset in the stream's stage region."""
    g = r & ~15
    src, end = g, (r + n + 15) & ~15
    if not interior:
        src, end = max(src, lo), min(end, hi)
    return src, max(end - src, 0), src - g


class Copy(NamedTuple):
    """One stream's copy for one frame of a tile: copy_range's (src, size,
    dst), and the elements of the tile's slice the kernel reads from
    global memory before and after the staged ones (head, tail)."""

    src: int
    size: int
    dst: int
    head: int
    tail: int


def plan_copy(plan, stream: int, f: int, k: int) -> Copy:
    """Stream `stream`'s copy for frame f of tile k, as the kernel's
    producer issues it from the plan (bytes from the stream's granule)."""
    e = plan.elem_sizes[stream]
    t0, t1, f_lo, f_hi = plan.tiles[k]
    r = plan.offsets[stream] + e * (f * plan.npix + t0)
    src, size, dst = copy_range(r, e * (t1 - t0), f_lo <= f <= f_hi, *plan.bounds[stream])
    first, end = plan.staged[stream]
    x0, x1 = f * plan.npix + t0, f * plan.npix + t1
    head = min(max(first - x0, 0), t1 - t0)
    tail = min(max(x1 - end, 0), t1 - t0 - head)
    return Copy(src, size, dst, head, tail)


def block_tiles(plan, b):
    """The indices of block b's tiles, in order."""
    return range(plan.block_tiles[b], plan.block_tiles[b + 1])


def pointers(offset_elems, elem_sizes=ALL_STREAMS):
    return [None if e is None else b + offset_elems * e for b, e in zip(BASES, elem_sizes)]


def plan_at(npix, n_frames, sms, elem_sizes, ptrs):
    return scan_plan(npix, n_frames, sms, elem_sizes,
                     tuple(None if p is None else p % 16 for p in ptrs))


def region_caps(plan):
    """Each present stream's region size in a stage."""
    present = sorted((off, s) for s, off in enumerate(plan.regions) if off is not None)
    ends = [off for off, _ in present[1:]] + [plan.frame_bytes]
    return {s: end - off for (off, s), end in zip(present, ends)}


@pytest.mark.parametrize("offset", [0, 1, 3], ids=lambda o: f"off{o}")
@pytest.mark.parametrize("hw", PLANES, ids=PLANE_IDS)
def test_copies_cover_every_pixel_frame_once(hw, offset):
    npix = hw[0] * hw[1]
    ptrs = pointers(offset)
    plan = plan_at(npix, F, SMS, ALL_STREAMS, ptrs)
    caps = region_caps(plan)
    owner = np.zeros(npix, np.int32)  # tiles per pixel
    n_copies = 0
    from_global = np.zeros(3, np.int64)  # per stream: elements read from global memory
    for k, (t0, t1, f_lo, f_hi) in enumerate(plan.tiles):
        assert 0 < t1 - t0 <= plan.tile and t0 % UNIT_PX == 0
        owner[t0:t1] += 1
        for f in range(F):
            outside = False  # some stream's slice leaves its aligned interior
            for s, ptr in enumerate(ptrs):
                e = plan.elem_sizes[s]
                nbytes = e * F * npix
                lo, hi = (ptr + 15) & ~15, (ptr + nbytes) & ~15
                a = ptr + e * (f * npix + t0)  # the slice's first byte
                n = e * (t1 - t0)
                outside |= a < lo or a + n > hi
                # the kernel's running offset finds the slice in its granule
                assert (plan.offsets[s] + f * plan.steps[s]) % 16 == a % 16
                c = plan_copy(plan, s, f, k)
                src = (ptr & ~15) + c.src
                staged = (t1 - t0) - c.head - c.tail
                assert staged >= 0 and c.head >= 0 and c.tail >= 0
                assert src % 16 == 0 and c.size % 16 == 0 and c.dst % 16 == 0
                if f_lo <= f <= f_hi:
                    # the slice's whole granules, every element staged
                    assert (src, c.size, c.head, c.tail) == (
                        a & ~15, ((a + n + 15) & ~15) - (a & ~15), 0, 0)
                if c.size:
                    n_copies += 1
                    # inside the tensor, and inside the stream's region
                    assert ptr <= src and src + c.size <= ptr + nbytes
                    assert c.dst + c.size <= caps[s]
                    assert src - c.dst == a & ~15
                if staged:
                    # the staged elements lie in the copied bytes
                    assert src <= a + e * c.head and a + e * (t1 - t0 - c.tail) <= src + c.size
                from_global[s] += c.head + c.tail
            # the interior frames are exact: every other frame needs the clip
            assert (f_lo <= f <= f_hi) == (not outside)
    assert (owner == 1).all()  # each pixel in one tile, so once per frame
    for s, ptr in enumerate(ptrs):
        e = plan.elem_sizes[s]
        end = ptr + e * F * npix
        lo, hi = min((ptr + 15) & ~15, end), end & ~15
        # only the elements in the tensor's partial first and last granules
        n_inside = max(0, (hi - lo) // e) if hi > lo else 0
        assert from_global[s] == F * npix - n_inside
        assert from_global[s] <= 30
    assert n_copies > 0 or npix * 4 < 32


@pytest.mark.parametrize("hw", PLANES, ids=PLANE_IDS)
def test_strips_even_to_one_unit(hw):
    npix = hw[0] * hw[1]
    plan = scan_plan(npix, F, SMS)
    units = -(-npix // UNIT_PX)
    assert plan.blocks == min(SMS, units)
    assert plan.strips[0] == 0 and plan.strips[-1] == npix
    sizes = np.diff(plan.strips)
    assert (sizes > 0).all()
    assert all(s % UNIT_PX == 0 for s in plan.strips[:-1])
    assert sizes.max() - sizes.min() <= UNIT_PX
    # in whole units (the last one partial) they differ by at most one
    unit_counts = -(-sizes // UNIT_PX)
    assert unit_counts.max() - unit_counts.min() <= 1
    assert plan.tile % UNIT_PX == 0 and plan.tile <= MAX_TILE_PX
    assert plan.threads <= 1024 and plan.threads >= plan.tile + 32
    # each block's tiles run through its strip in order, all but the last
    # of the plan's tile size
    for b in range(plan.blocks):
        ts = [plan.tiles[k] for k in block_tiles(plan, b)]
        assert ts[0][0] == plan.strips[b] and ts[-1][1] == plan.strips[b + 1]
        assert all(u[0] == t[1] for t, u in zip(ts, ts[1:]))
        assert all(t[1] - t[0] == plan.tile for t in ts[:-1])
    assert max(len(block_tiles(plan, b)) for b in range(plan.blocks)) == -(-sizes.max() // plan.tile)


@pytest.mark.parametrize("streams", list(STREAM_SETS), ids=list(STREAM_SETS))
@pytest.mark.parametrize("hw", PLANES, ids=PLANE_IDS)
def test_ring_fits_shared_memory(hw, streams):
    elem_sizes = STREAM_SETS[streams]
    plan = scan_plan(hw[0] * hw[1], F, SMS, elem_sizes,
                     tuple(None if e is None else 0 for e in elem_sizes))
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert RING * GROUP >= 8 and RING >= 2
    assert BAR_BYTES >= 16 * RING and BAR_BYTES % 128 == 0
    assert plan.smem_bytes == BAR_BYTES + RING * GROUP * plan.frame_bytes
    assert plan.frame_bytes % 16 == 0
    for s, e in enumerate(elem_sizes):
        assert (plan.regions[s] is not None) == (e is not None)
        if e is not None:
            # a tile's slice starting anywhere in a granule fits
            assert plan.regions[s] % 16 == 0
            assert region_caps(plan)[s] >= 16 + (plan.tile * e + 15) // 16 * 16


def test_largest_tile_fits_shared_memory():
    """A plane of 992 pixels per SM takes the largest tile; its ring of all
    three streams still fits."""
    plan = scan_plan(MAX_TILE_PX * SMS, 96, SMS)
    assert plan.tile == MAX_TILE_PX and plan.threads == 1024
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert len(plan.tiles) == SMS


@pytest.mark.parametrize("n_frames", [1, 19], ids=lambda n: f"F{n}")
@pytest.mark.parametrize("offset", [0, 1, 3], ids=lambda o: f"off{o}")
@pytest.mark.parametrize("streams", list(STREAM_SETS), ids=list(STREAM_SETS))
def test_ring_reads_reproduce_the_streams(streams, offset, n_frames):
    """The kernel's data path in numpy: tensors at their addresses in one
    byte heap, a producer running RING stages ahead that copies each
    stage's granules (plan_copy) into its slot, consumers that read
    each element at the running offset of its stream in the slot, or,
    outside the interior frames and outside the plan's staged elements,
    from the heap.  Every element read equals the tensor's.  Two blocks of
    two tiles each (2400 px, 2 SMs)."""
    elem_sizes = STREAM_SETS[streams]
    h, w = 40, 60
    npix = h * w
    rng = np.random.default_rng(offset)
    dtypes = (np.float32, np.float32, np.uint8)
    data = [None if e is None else
            (rng.standard_normal((n_frames, npix)).astype(np.float32) if e == 4
             else rng.integers(0, 256, (n_frames, npix), dtype=np.uint8))
            for e in elem_sizes]
    # a heap of 512-aligned allocations, each tensor `offset` elements in
    heap_base = 0x7000
    heap = np.zeros(3 * (4 * n_frames * npix + 1024), np.uint8)
    ptrs = []
    cursor = heap_base
    for s, arr in enumerate(data):
        if arr is None:
            ptrs.append(None)
            continue
        ptr = cursor + offset * elem_sizes[s]
        raw = arr.reshape(-1).view(np.uint8)
        heap[ptr - heap_base: ptr - heap_base + raw.size] = raw
        ptrs.append(ptr)
        cursor = (ptr + raw.size + 511) // 512 * 512
    plan = plan_at(npix, n_frames, 2, elem_sizes, ptrs)
    assert plan.blocks == 2 and len(block_tiles(plan, 0)) == 2
    slots = np.full((RING, GROUP * plan.frame_bytes), 0xAB, np.uint8)
    for blk in range(plan.blocks):
        # the block's stages in order: each tile's frames in groups
        order = [(k, tuple(range(f0, min(f0 + GROUP, n_frames))))
                 for k in block_tiles(plan, blk) for f0 in range(0, n_frames, GROUP)]
        got = [None if a is None else np.zeros_like(a) for a in data]

        def produce(i):
            k, frames = order[i]
            for g, f in enumerate(frames):
                for s, ptr in enumerate(ptrs):
                    if ptr is None:
                        continue
                    c = plan_copy(plan, s, f, k)
                    src = (ptr & ~15) + c.src - heap_base
                    r = g * plan.frame_bytes + plan.regions[s] + c.dst
                    slots[i % RING, r: r + c.size] = heap[src: src + c.size]

        for i in range(min(RING, len(order))):
            produce(i)
        for i, (k, frames) in enumerate(order):
            t0, t1, f_lo, f_hi = plan.tiles[k]
            for g, f in enumerate(frames):
                for s, ptr in enumerate(ptrs):
                    if ptr is None:
                        continue
                    e = elem_sizes[s]
                    m = (plan.offsets[s] + f * plan.steps[s]) % 16
                    first, end = plan.staged[s]
                    for c in range(t1 - t0):
                        x = f * npix + t0 + c
                        if f_lo <= f <= f_hi or first <= x < end:
                            off = g * plan.frame_bytes + plan.regions[s] + m + e * c
                            raw = slots[i % RING, off: off + e]
                        else:
                            assert not f_lo <= f <= f_hi
                            y = ptr + e * x - heap_base
                            raw = heap[y: y + e]
                        got[s][f, t0 + c] = raw.view(dtypes[s])[0]
            if i + RING < len(order):  # the slot is released, refilled
                produce(i + RING)
        for s, arr in enumerate(data):
            if arr is not None:
                s0, s1 = plan.strips[blk], plan.strips[blk + 1]
                assert np.array_equal(got[s][:, s0:s1], arr[:, s0:s1])


@pytest.mark.parametrize("r,n,interior,lo,hi,want", [
    (0, 64, False, 0, 0x1000, (0, 64, 0)),          # aligned
    (4, 64, True, 16, 0x1000, (0, 80, 0)),          # interior: whole granules, no clip
    (4, 64, False, 16, 0x1000, (16, 64, 16)),       # the tensor starts mid-granule
    (0xff8, 4, False, 0, 0xff0, (0xff0, 0, 8)),     # only the tensor's last granule
    (3, 1, False, 16, 0, (16, 0, 16)),              # a tensor inside one granule
])
def test_copy_range_cases(r, n, interior, lo, hi, want):
    src, size, dst = copy_range(r, n, interior, lo, hi)
    assert (src, size) == want[:2]
    if size:
        assert dst == want[2]


@pytest.mark.parametrize("offset", [0, 1, 3], ids=lambda o: f"off{o}")
def test_plan_follows_the_tensors(offset):
    """The plan scan launches for tensors whose data pointers are `offset`
    elements past an allocation's start, and the struct the kernel is
    given: the pointers' offsets mod 16, and every field as planned."""
    n_frames, h, w = 5, 37, 301
    npix = h * w

    def view(dtype):
        flat = torch.zeros(n_frames * npix + 16, dtype=dtype)
        return flat[offset: offset + n_frames * npix].view(n_frames, h, w)

    lp, leak, shot = view(torch.float32), view(torch.float32), view(torch.uint8)
    sizes, offsets = stream_layout(lp, leak, shot)
    assert sizes == (4, 4, 1)
    assert offsets == tuple(t.data_ptr() % 16 for t in (lp, leak, shot))
    assert stream_layout(lp, None, None) == ((4, None, None), (offsets[0], None, None))
    plan = scan_plan(npix, n_frames, SMS, sizes, offsets)
    c = c_plan(plan)
    assert ctypes.sizeof(c) == 4 * 3 * 8 + (7 + 3 * 3 + 513) * 4 + 4  # padded to 8
    assert (c.npix, c.n_frames, c.blocks, c.threads, c.tile, c.frame_bytes, c.smem_bytes) == (
        npix, n_frames, plan.blocks, plan.threads, plan.tile, plan.frame_bytes, plan.smem_bytes)
    assert list(c.offset) == list(offsets) and list(c.step) == list(plan.steps)
    assert list(c.region) == list(plan.regions)
    assert [(c.lo[s], c.hi[s]) for s in range(3)] == list(plan.bounds)
    assert [(c.first[s], c.end[s]) for s in range(3)] == list(plan.staged)
    assert list(c.block_tiles[: plan.blocks + 1]) == list(plan.block_tiles)
    clean = c_plan(scan_plan(npix, n_frames, SMS, (4, None, None), (offsets[0], None, None)))
    assert list(clean.region) == [0, -1, -1] and list(clean.offset)[1:] == [0, 0]


def test_quotient_below_threshold_floors_to_zero():
    """The kernel skips the division where 0 < d < t: the float quotient
    of the largest d below t still rounds below 1, for thresholds across
    the float range, subnormal ones included."""
    rng = np.random.default_rng(0)
    t = np.concatenate([
        rng.uniform(0.01, 2.0, 20000).astype(np.float32),
        np.float32(2.0) ** np.arange(-149, 128, dtype=np.float32),
        np.nextafter(np.float32(2.0) ** np.arange(-125, 128, dtype=np.float32), np.float32(0)),
    ])
    t = t[t > 0]
    d = np.nextafter(t, np.float32(0))
    with np.errstate(divide="ignore", invalid="ignore"):
        q = d / t
    assert q.dtype == np.float32 and (np.floor(q) == 0).all()
    assert (np.floor(t / t) == 1).all()
