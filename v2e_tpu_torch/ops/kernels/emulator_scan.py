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

`refractory_scan_strips` runs K1 on pixel strips (parallel/mesh.py):
each strip's rows with each frame's K the largest count over every strip,
so the strips together equal K1 on the whole plane bit for bit.  One
cooperative launch per strip and chunk (`refr_strips`, same source), all S
launched before anything waits, each strip on its own stream where strips
share a device; inside, K1's tagged-slot barrier reduces the strip's
maximum, and block 0 of each strip exchanges it with the other strips
through slots in mapped pinned host memory, at system scope, which every
card reaches.  Its launch plan (`strips_plan`: strips on one device share
its SMs) is made in Python.  Every wait in the kernel has a time limit;
the wrapper raises when one expired.  Bound as K1: 13 B per pixel-frame,
and at the CLI's planes the latency of F two-level barriers.  The plain
version, `refractory_scan_strips_plain`, is K1's plain loop per frame
split at its maximum: each strip's count (`refractory_count_plain`), the
largest over the strips, each strip's apply (`refractory_apply_plain`).

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from v2e_tpu_torch import tracing
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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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
    build.call("v2e_refractory_scan", dev, lp, leak_delta, shot_any, pos_thres, neg_thres,
               new_base, new_mem, dts, t_prevs, k_buf, counts, i0, F, H * W,
               float(refractory_period_s), counter="launch.k1")
    return new_base, new_mem, counts, i0, k_buf[:F]


def refractory_grid(npix: int, device: torch.device) -> Tuple[int, int, int]:
    """(blocks, threads per block, pixels per thread held in registers, 0
    for the global-state form) of K1's cooperative launch for `npix`
    pixels on `device`."""
    key = (npix, device.index)
    if key in _GRIDS:
        return _GRIDS[key]
    out = [ctypes.c_int(0) for _ in range(3)]
    build.call("v2e_refractory_scan_grid", device, npix, *(ctypes.byref(v) for v in out))
    _GRIDS[key] = tuple(v.value for v in out)
    return _GRIDS[key]


_GRIDS = {}


def refractory_count_plain(lp, leak_delta, pos_thres, neg_thres, base, f) -> torch.Tensor:
    """K1's step 1 for frame f: base -= leak[f] in place; returns the
    largest count of the plane's pixels (0-d int32)."""
    if leak_delta is not None:
        base.sub_(leak_delta[f])
    pos, neg = compute_event_map(lp[f] - base, pos_thres, neg_thres)
    return (pos + neg).max()


def refractory_apply_plain(lp, shot_any, pos_thres, neg_thres, base, mem, dts, t_prevs,
                           refractory_period_s, K, f, counts, i0s) -> None:
    """K1's step 3 for frame f given the frame's K (a 0-d int32 tensor), on
    the base step 1 left, in place: the filter, base and memory updates,
    counts[f] and i0s[f]."""
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


def _strips_frames(strips) -> int:
    """The strips' common frame count; raises unless every strip has the
    same frames and refractory period."""
    if not strips:
        raise ValueError("refractory_scan_strips: no strips")
    F, R = strips[0][0].shape[0], float(strips[0][9])
    for s, args in enumerate(strips):
        if len(args) != 10:
            raise ValueError(f"strip {s}: {len(args)} arguments, want refractory_scan's 10")
        if args[0].shape[0] != F or float(args[9]) != R:
            raise ValueError(f"strip {s}: {args[0].shape[0]} frames at R {args[9]}, strip 0 "
                             f"{F} at R {R}")
    return F


def refractory_scan_strips_plain(strips: Sequence[tuple]) -> List[Result]:
    """K1 on row strips with each frame's K the largest count over all of
    them, as a loop over frames: each strip's count, the maximum over the
    strips, each strip's apply.  Takes and returns what
    `refractory_scan_strips` does."""
    F = _strips_frames(strips)
    out = [dict(base=args[5].clone(), mem=args[6].clone(),
                counts=torch.empty(args[0].shape, dtype=torch.int16, device=args[0].device),
                i0=torch.empty(args[0].shape, dtype=torch.int16, device=args[0].device))
           for args in strips]
    lead = strips[0][0].device
    Ks = torch.zeros(F, dtype=torch.int32, device=lead)
    for f in range(F):
        Ks[f] = torch.stack([
            refractory_count_plain(lp, leak, pos, neg, o["base"], f).to(lead)
            for (lp, leak, _, pos, neg, *_), o in zip(strips, out)]).amax()
        for (lp, _, shot, pos, neg, _, _, dts, t_prevs, R), o in zip(strips, out):
            refractory_apply_plain(lp, shot, pos, neg, o["base"], o["mem"], dts, t_prevs, R,
                                   Ks[f].to(lp.device), f, o["counts"], o["i0"])
    return [(o["base"], o["mem"], o["counts"], o["i0"], Ks.to(args[0].device))
            for o, args in zip(out, strips)]


# K1 on strips: the most threads and blocks of a strip's grid (the kernel's
# kRefrMaxThreads and kMaxBlocks) and the most strips (kMaxStrips: one
# exchange slot per lane of the warp that polls them)
STRIP_MAX_THREADS = 1024
STRIP_MAX_BLOCKS = 512
MAX_STRIPS = 32
# the default time limit of each wait in the kernel
STRIP_TIMEOUT_S = 2.0


@dataclass(frozen=True)
class StripGrid:
    """One strip's cooperative grid: blocks x threads, and the form (regs:
    one pixel per thread with its state in registers, else the global-state
    form)."""

    blocks: int
    threads: int
    regs: bool


def strips_plan(npixs: Sequence[int], devices: Sequence[int], sms: Dict[int, int],
                occupancy: Callable[[int, bool, int], int]) -> Tuple[StripGrid, ...]:
    """The grid of each strip of `npixs` pixels on device `devices[i]`.

    sms: SMs per device; occupancy(device, regs, threads): blocks of that
    form and width one SM holds.  The strips on a device share its SMs, so
    that their grids are resident together: each takes `share` = SMs // n
    of them (n its device's strips).  In the register form (when every
    strip of the device fits one pixel per thread in `share` blocks) a
    strip takes one block per SM of its share, fewer on a small strip, and
    threads just enough for its pixels: the blocks together are at most
    the SMs, each fits an SM alone, so all are resident at once.  Else
    every strip of the device takes the global-state form, 1024 threads a
    block and occupancy x share blocks.  A strip alone on its device gets
    K1's grid.  Raises when a device cannot hold one block per strip.
    """
    if not 1 <= len(npixs) <= MAX_STRIPS or len(devices) != len(npixs):
        raise ValueError(f"strips_plan: {len(npixs)} strips on {len(devices)} devices "
                         f"(1 to {MAX_STRIPS})")
    if min(npixs) < 1:
        raise ValueError(f"strips_plan: an empty strip in {list(npixs)}")
    count = {d: list(devices).count(d) for d in devices}
    share = {d: min(sms[d] // n, STRIP_MAX_BLOCKS) for d, n in count.items()}
    for d, n in count.items():
        if share[d] < 1:
            raise ValueError(f"strips_plan: device {d} has {sms[d]} SMs for {n} strips: it "
                             "cannot hold one block per strip")
    regs = {d: all(p <= share[d] * STRIP_MAX_THREADS
                   for p, e in zip(npixs, devices) if e == d) for d in count}
    grids = []
    for p, d in zip(npixs, devices):
        if regs[d]:
            blocks = min(-(-p // 32), share[d])
            threads = _up(-(-p // blocks), 32)
        else:
            blocks, threads = None, STRIP_MAX_THREADS
        occ = occupancy(d, regs[d], threads)
        if occ < 1:
            raise ValueError(f"strips_plan: a block of {threads} threads does not fit an SM "
                             f"of device {d}")
        if blocks is None:
            blocks = min(occ * share[d], STRIP_MAX_BLOCKS)
        grids.append(StripGrid(blocks, threads, regs[d]))
    return tuple(grids)


def _occupancy(device: int, regs: bool, threads: int) -> int:
    out = ctypes.c_int(0)
    build.call("v2e_refractory_strips_occupancy", device, int(regs), threads, ctypes.byref(out))
    return out.value


@functools.cache
def _device_grids(npixs: Tuple[int, ...], devices: Tuple[int, ...]) -> Tuple[StripGrid, ...]:
    sms = {d: torch.cuda.get_device_properties(d).multi_processor_count for d in set(devices)}
    return strips_plan(npixs, devices, sms, _occupancy)


class _Exchange:
    """The strips' exchange: 2 x n slots and the error word, 64-bit words of
    pinned host memory (kept for the process: a kernel may still read them
    when a call raises), each device's address of them, and the count of
    frames tagged so far, which keeps every frame's tag unique across calls
    (tags are 32-bit; 2^32 - 1 is the abort tag)."""

    def __init__(self, n: int):
        self.n = n
        self.words = torch.zeros(2 * n + 1, dtype=torch.int64, pin_memory=True)
        self.addr: Dict[int, int] = {}
        self.tagged = 0

    def address(self, device: int) -> int:
        if device not in self.addr:
            out = ctypes.c_void_p(0)
            with torch.cuda.device(device):
                err = build.entry("v2e_host_device_ptr")(self.words.data_ptr(),
                                                         ctypes.byref(out))
            if err or not out.value:
                raise RuntimeError(f"refractory_scan_strips: the exchange's pinned memory has "
                                   f"no address on cuda:{device} (CUDA error {err})")
            self.addr[device] = out.value
        return self.addr[device]

    def take_tags(self, n_frames: int) -> int:
        """tag0 of a call of n_frames frames, with the error word cleared.
        Near 2^32 the count restarts at 0 and the slots are cleared: every
        earlier call has waited for its kernels, so none reads them."""
        if self.tagged + n_frames + 1 >= 0xFFFFFFFF:
            self.words.zero_()
            self.tagged = 0
        self.words[2 * self.n] = 0
        tag0 = self.tagged
        self.tagged += n_frames
        return tag0


_EXCHANGES: Dict[int, _Exchange] = {}
_STREAMS: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}
_ERRORS = {1: "a block of the strip did not reach the strip's barrier",
           2: "a strip did not reach the exchange",
           3: "block 0's K did not arrive"}


def _check_strip(s: int, args, dev: torch.device) -> None:
    lp, leak, shot, pos, neg, base, mem, dts, t_prevs, _ = args
    F, h, w = lp.shape
    _check(f"strip {s} lp", lp, torch.float32, (F, h, w), dev)
    if leak is not None:
        _check(f"strip {s} leak_delta", leak, torch.float32, (F, h, w), dev)
    if shot is not None:
        _check(f"strip {s} shot_any", shot, torch.uint8, (F, h, w), dev)
    for name, t in (("pos_thres", pos), ("neg_thres", neg), ("base", base),
                    ("timestamp_mem", mem)):
        _check(f"strip {s} {name}", t, torch.float32, (h, w), dev)
    _check(f"strip {s} dts", dts, torch.float32, (F,), dev)
    _check(f"strip {s} t_prevs", t_prevs, torch.float32, (F,), dev)


def refractory_scan_strips(strips: Sequence[tuple], timeout_s: float = STRIP_TIMEOUT_S,
                           n_strips: Optional[int] = None) -> List[Result]:
    """K1 on row strips (see the module note): the kernel for CUDA tensors,
    `refractory_scan_strips_plain` for CPU ones.

    strips: per strip, the arguments of `refractory_scan` (lp, leak_delta,
    shot_any, pos_thres, neg_thres, base, timestamp_mem, dts, t_prevs,
    refractory_period_s) for its rows, each strip on its device; the same
    frames and refractory period in all.  Returns, per strip, what
    `refractory_scan` returns for those rows, K the whole plane's.  Inputs
    are not modified.  Every wait in the kernel gives up after timeout_s,
    and the call then raises.  n_strips: the exchange's participants,
    len(strips) by default; a larger number launches only the first
    len(strips), and the others never arrive (the time limit's test).
    """
    F = _strips_frames(strips)
    n = len(strips) if n_strips is None else n_strips
    on_card = [args[0].is_cuda for args in strips]
    if not any(on_card):
        if n != len(strips):
            raise ValueError("refractory_scan_strips: n_strips applies to the kernel only")
        return refractory_scan_strips_plain(strips)
    if not all(on_card):
        raise ValueError("refractory_scan_strips: strips on CUDA and on the CPU at once")
    devs = [args[0].device for args in strips]
    for s, (args, dev) in enumerate(zip(strips, devs)):
        _check_strip(s, args, dev)
    if not len(strips) <= n <= MAX_STRIPS:
        raise ValueError(f"refractory_scan_strips: {len(strips)} strips of {n} (at most "
                         f"{MAX_STRIPS})")
    npixs = [args[0].shape[1] * args[0].shape[2] for args in strips]
    outs = []
    for args, dev in zip(strips, devs):
        lp, base, mem = args[0], args[5], args[6]
        outs.append((base.clone(), mem.clone(),
                     torch.empty(lp.shape, dtype=torch.int16, device=dev),
                     torch.empty(lp.shape, dtype=torch.int16, device=dev)))
    if F == 0:
        return [o + (torch.zeros(0, dtype=torch.int32, device=d),) for o, d in zip(outs, devs)]
    index = [d.index for d in devs]
    grids = _device_grids(tuple(npixs), tuple(index))
    x = _EXCHANGES.get(n)
    if x is None:
        x = _EXCHANGES[n] = _Exchange(n)
    tag0 = x.take_tags(F)
    # K, then the strip barrier's blocks + 1 64-bit slots, zeroed
    kbufs = [torch.zeros(F + F % 2 + 2 * (g.blocks + 1), dtype=torch.int32, device=d)
             for g, d in zip(grids, devs)]
    shared = {i for i in index if index.count(i) > 1}
    current = {i: torch.cuda.current_stream(i) for i in set(index)}
    launch = build.entry("v2e_refractory_scan_strips")
    launched, err = [], 0
    for s, (args, g, i) in enumerate(zip(strips, grids, index)):
        stream = current[i]
        if i in shared:  # strips sharing a device run on streams of their own
            if (i, s) not in _STREAMS:
                _STREAMS[(i, s)] = torch.cuda.Stream(i)
            stream = _STREAMS[(i, s)]
            stream.wait_stream(current[i])
        lp, leak, shot, pos, neg, _, _, dts, t_prevs, R = args
        new_base, new_mem, counts, i0 = outs[s]
        with torch.cuda.device(i):
            err = launch(
                _ptr(lp), _ptr(leak), _ptr(shot), _ptr(pos), _ptr(neg), _ptr(new_base),
                _ptr(new_mem), _ptr(dts), _ptr(t_prevs), _ptr(kbufs[s]), _ptr(counts),
                _ptr(i0), x.address(i), s, n, tag0,
                int(timeout_s * 1e9), F, npixs[s], float(R), g.blocks, g.threads, int(g.regs),
                stream.cuda_stream)
        if err:
            break
        tracing.count("launch.k1_strips")
        launched.append(stream)
    for i, stream in zip(index, launched):
        if stream is not current[i]:
            current[i].wait_stream(stream)
    # the error word is read once every launched strip has finished
    for stream in current.values():
        stream.synchronize()
    build.check(err, "refractory_scan_strips")
    word = int(x.words[2 * n])
    if word:
        code, strip, frame = word >> 56, (word >> 32) & 0xFFFFFF, word & 0xFFFFFFFF
        raise RuntimeError(f"refractory_scan_strips: {_ERRORS.get(code, code)} within "
                           f"{timeout_s} s (strip {strip}, frame {frame})")
    return [o + (k[:F],) for o, k in zip(outs, kbufs)]


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
def _check_plan_bytes() -> None:
    """Raise unless the kernel's ScanPlan and `_CPlan` have one size."""
    n = build.entry("v2e_scan_plan_bytes")()
    if n != ctypes.sizeof(_CPlan):
        raise RuntimeError(f"scan: the kernel's ScanPlan is {n} bytes, _CPlan "
                           f"{ctypes.sizeof(_CPlan)}")


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
    _, cplan, tiles = _device_plan(
        H * W, F, dev.index, *stream_layout(lp, leak_delta, shot_any))
    new_base = torch.empty_like(base)
    _check_plan_bytes()
    build.call("v2e_scan", dev, ctypes.byref(cplan), tiles, lp, leak_delta, shot_any, pos_thres,
               neg_thres, base, new_base, counts, counter="launch.k2")
    return new_base, counts
