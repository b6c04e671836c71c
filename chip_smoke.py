#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (v2e_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line with its seconds:
  0. the card's name and power limit (nvidia-smi);
  1. build of the CUDA kernels with nvcc (sm_90a) into v2e_tpu_torch/_build;
  2. K1 (refractory scan) against its plain PyTorch version at the main
     path's shape and frame interval (160 frames of 260x346 at 1/300 s,
     leak and shot noise on, R=0.5 ms), with a high-contrast moving bar so
     that the filter is active (R > dt/K) in every frame after the first:
     counts, i0 and K equal, base and spike-time memory within 1e-6, and
     the filter seen to act (i0 > 0 somewhere, spike times updated);
  3. K3 (bilinear warp) against its plain version at 160 planes of 256x320
     with flows up to +-32 px: max abs difference <= 1e-5; F.grid_sample is
     timed beside it as a yardstick;
  4. the fused conversion chunk at the bench workload (346x260 source,
     10x SloMo, 16 pairs per chunk, base=32 random weights in bf16, the
     bench's emulator parameters): one staged chunk, one warm chunk, then
     measured chunks with both kernels' launch counters read; plus the
     same path at a small size on the card and on the CPU, noise off,
     which must agree;
  5. the measured chunks' events written to AEDAT-2 and text files in a
     temporary directory.

Then one JSON line with every kernel's numbers, the nvidia-smi line again,
and last {"ok": true, "device": {...}}.  Exits non-zero, with no result,
when CUDA is unavailable, a kernel does not build or disagrees, or any
check fails.
"""
from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

TIME_LIMIT_S = 1100  # a hang becomes a traceback and a non-zero exit

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) ops/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

H, W = 260, 346
U, B = 10, 16
SRC_FPS = 30.0
N_MEAS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_k1(torch, dev):
    from v2e_tpu_torch.ops.kernels.emulator_scan import (
        refractory_scan, refractory_scan_plain,
    )

    F, R = U * B, 0.0005
    g = torch.Generator(device=dev).manual_seed(1)
    f32 = torch.float32
    yy = torch.arange(H, device=dev, dtype=f32)[:, None]
    xx = torch.arange(W, device=dev, dtype=f32)[None, :]
    tt = torch.arange(F, device=dev, dtype=f32)[:, None, None]
    # drifting log-intensity texture, a bar 2.5 log units bright moving 3 px
    # per frame (its edges give K of about 12-33, so R > dt/K: the filter
    # acts), plus per-frame noise
    bar = (torch.remainder(xx + 0.5 * yy - 3.0 * tt, 96.0) < 10.0).to(f32)
    lp = (4.6 + 0.6 * torch.sin((xx + 0.2 * tt) / 17.0) * torch.cos(yy / 13.0)
          + 2.5 * bar + 0.02 * torch.randn((F, H, W), generator=g, device=dev))
    pos = torch.clamp(0.2 + 0.03 * torch.randn((H, W), generator=g, device=dev), min=0.01)
    neg = torch.clamp(0.2 + 0.03 * torch.randn((H, W), generator=g, device=dev), min=0.01)
    base = lp[0] + 0.05 * torch.randn((H, W), generator=g, device=dev)
    mem = torch.full((H, W), -R, device=dev)
    dts = torch.full((F,), 1.0 / (SRC_FPS * U), device=dev)
    t_prevs = torch.cumsum(dts, 0) - dts
    leak = 1e-3 * torch.rand((F, H, W), generator=g, device=dev)
    shot = (torch.rand((F, H, W), generator=g, device=dev) < 1e-3).to(torch.uint8)
    args = (lp, leak, shot, pos, neg, base, mem, dts, t_prevs, R)

    before = refractory_scan.launches
    got = refractory_scan(*args)
    want = refractory_scan_plain(*args)
    torch.cuda.synchronize()
    names = ("base", "mem", "counts", "i0", "K")
    for name, a, b in zip(names[2:], got[2:], want[2:]):
        n_bad = int((a != b).sum())
        if n_bad:
            raise AssertionError(f"K1 {name}: {n_bad} entries differ from the plain version")
    err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1))
    if err > 1e-6:
        raise AssertionError(f"K1 base/mem differ by {err} > 1e-6")
    n_active = int((got[4].to(f32) * R > dts).sum())
    i0_max = int(got[3].max())
    mem_moved = int((got[1] != mem).sum())
    if n_active < F - 1 or i0_max <= 0 or mem_moved == 0:
        raise AssertionError(
            f"K1 test data leaves the refractory filter idle: active in {n_active}/{F} "
            f"frames, i0 max {i0_max}, {mem_moved} spike times updated")
    ms = time_ms(torch, lambda: refractory_scan(*args), reps=10)
    plain_ms = time_ms(torch, lambda: refractory_scan_plain(*args), reps=2)
    refractory_scan.launches = before  # comparison launches do not count
    npix = H * W
    nbytes = F * npix * (4 + 4 + 1 + 2 + 2) + npix * (4 * 4 + 2 * 4) + F * 12
    b_ms, b_by = bound(nbytes, F * npix * 40)
    events = int(got[2].abs().sum())
    log(f"[k1] refractory scan F={F} {H}x{W}: counts/i0/K equal, base/mem max abs "
        f"err {err:.3g}; filter active in {n_active}/{F} frames (K {int(got[4].min())}"
        f"-{int(got[4].max())}), i0 max {i0_max} at {int((got[3] > 0).sum())} "
        f"pixel-frames, {mem_moved}/{H * W} spike times updated; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); {events} events in "
        f"the test chunk")
    return {
        "name": "refractory_scan", "route": "cuda",
        "source": "v2e_tpu_torch/csrc/emulator_scan.cu",
        "replaces": "v2e_tpu/ops/pallas/emulator_scan.py:247",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def phase_k3(torch, dev):
    import torch.nn.functional as Fn

    from v2e_tpu_torch.ops.kernels.warp import bilinear_warp, warp_plain

    N, h, w = U * B, 256, 320
    g = torch.Generator(device=dev).manual_seed(2)
    img = torch.rand((N, h, w), generator=g, device=dev) - 0.428
    # smooth flow fields reaching +-32 px
    coarse = torch.rand((N, 2, 9, 11), generator=g, device=dev) * 64.0 - 32.0
    flow = Fn.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True).contiguous()
    u, v = flow[:, 0], flow[:, 1]

    before = bilinear_warp.launches
    got = bilinear_warp(img, u, v, 32)
    want = warp_plain(img, u, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"K3 differs from the plain version by {err} > 1e-5")

    # yardstick: grid_sample(align_corners=False, zeros) on the same inputs
    gx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    gy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    grid = torch.stack([2.0 * ((gx + u) / w - 0.5), 2.0 * ((gy + v) / h - 0.5)], dim=-1)
    img4 = img[:, None]

    def lib():
        return Fn.grid_sample(img4, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False)

    lib_err = float((lib()[:, 0] - want).abs().max())
    ms = time_ms(torch, lambda: bilinear_warp(img, u, v, 32), reps=20)
    plain_ms = time_ms(torch, lambda: warp_plain(img, u, v), reps=5)
    library_ms = time_ms(torch, lib, reps=20)
    bilinear_warp.launches = before  # comparison launches do not count
    b_ms, b_by = bound(N * h * w * 16, N * h * w * 30)
    log(f"[k3] bilinear warp N={N} {h}x{w}: max abs err {err:.3g} (grid_sample "
        f"{lib_err:.3g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"grid_sample {library_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {
        "name": "bilinear_warp", "route": "cuda",
        "source": "v2e_tpu_torch/csrc/warp.cu",
        "replaces": "v2e_tpu/ops/pallas/warp.py:134",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


def check_events(np, ev, w, h, t_lo, t_hi):
    """Finite [N,4] events on the sensor, with times inside the chunk (the
    device keeps chunk-relative float32 times: 1e-5 s of slack)."""
    if ev.shape[1:] != (4,) or not np.isfinite(ev).all():
        raise AssertionError("events are not finite [N,4]")
    if len(ev) and not (
        (ev[:, 1] >= 0).all() and (ev[:, 1] < w).all()
        and (ev[:, 2] >= 0).all() and (ev[:, 2] < h).all()
        and np.isin(ev[:, 3], (-1.0, 1.0)).all()
        and (ev[:, 0] >= t_lo - 1e-5).all() and (ev[:, 0] <= t_hi + 1e-5).all()
    ):
        raise AssertionError("events out of range")


def run_chunks(np, fc, em, src, chunks, b, u, split=None):
    """Submit and collect chunks; returns [(events, handle)].  `split`
    collects (submit s, collect s) per chunk: submit runs the device work
    (compaction waits for it), collect fetches and materializes on the host."""
    out = []
    for c in chunks:
        times = (c * b + np.arange(b * u, dtype=np.float64) / u) / SRC_FPS
        t0 = time.perf_counter()
        handle = fc.submit(src[c * b: c * b + b + 1], times)
        if handle is None:
            continue
        t1 = time.perf_counter()
        ev, _, _ = em.collect(handle)
        if split is not None:
            split.append((t1 - t0, time.perf_counter() - t1))
        fc.note_collected(handle)
        check_events(np, ev, em.output_width, em.output_height, times[0] - 1.0 / SRC_FPS, times[-1])
        out.append((ev, handle))
    return out


def phase_profile(torch, np, fc, em, src, c, chunk_ms):
    """One more chunk under torch.profiler: device kernel time by name and
    the device's busy share of the (profiled, so slower) wall time.
    Informational: prints "not measured" where the profiler sees no device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_chunks(np, fc, em, src, [c], B, U)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        # device-side kernel events only (the aten ops repeat their times)
        if dev_us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key))
    if not rows:
        log("[profile] device time not measured (the profiler saw no device)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] one chunk: device kernel time {busy:.1f} ms in {len(rows)} kernels "
        f"(wall {wall_ms:.1f} ms with the profiler on; {busy / chunk_ms:.1%} of the "
        f"unprofiled {chunk_ms:.1f} ms chunk)")
    for ms, n, name in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms x{n:<5d} {name[:100]}")


def phase_small_reference(torch, np, devices=("cuda", "cpu")):
    """The fused path at a small size on the card and on the CPU (f32,
    noise and threshold mismatch off, so both are deterministic)."""
    from v2e_tpu_torch.emulator import EventEmulator
    from v2e_tpu_torch.fused import FusedConverter
    from v2e_tpu_torch.models.slomo import SuperSloMo
    from v2e_tpu_torch.synthetic import make_source_frames

    h, w, b, u = 64, 96, 2, 4
    src = make_source_frames(3 * b + 1, h, w, seed=3)
    results = []
    torch.backends.cudnn.allow_tf32 = False
    for device in devices:
        slomo = SuperSloMo(None, upsampling_factor=u, batch_size=b, compute_dtype="float32",
                           base=8, device=device, seed=5)
        em = EventEmulator(sigma_thres=0.0, cutoff_hz=300.0, leak_rate_hz=0.0,
                           refractory_period_s=0.0005, seed=9, device=device,
                           shuffle_events_within_iteration=False)
        runs = run_chunks(np, FusedConverter(slomo, em), em, src, range(3), b, u)
        frames = np.concatenate([hd["outs"]["dvs_frames"].cpu().numpy() for _, hd in runs[1:]])
        results.append((frames, sum(len(e) for e, _ in runs)))
    torch.backends.cudnn.allow_tf32 = True
    (fg, ng), (fc_, nc) = results[0], results[-1]
    same = float(np.mean(fg == fc_))
    diff = float(np.abs(fg - fc_).max())
    if same < 0.999 or diff > 1.0 or abs(ng - nc) > 0.01 * max(nc, 1):
        raise AssertionError(
            f"small fused chunk: card vs CPU frames {same:.5f} equal (max diff {diff}), "
            f"events {ng} vs {nc}")
    log(f"[fused-small] {h}x{w} U={u}: card vs CPU frames {same:.5f} equal "
        f"(max diff {diff} DN), events {ng} vs {nc}")


def main() -> int:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from v2e_tpu_torch.emulator import EventEmulator
    from v2e_tpu_torch.fused import FusedConverter
    from v2e_tpu_torch.io.aedat2 import AEDat2Output
    from v2e_tpu_torch.io.text import DVSTextOutput
    from v2e_tpu_torch.models.slomo import SuperSloMo
    from v2e_tpu_torch.ops.kernels import build
    from v2e_tpu_torch.ops.kernels.emulator_scan import refractory_scan
    from v2e_tpu_torch.ops.kernels.warp import bilinear_warp
    from v2e_tpu_torch.synthetic import make_source_frames

    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} x{torch.cuda.device_count()}")

    t = time.perf_counter()
    build_s = build.build()
    for name, out in build.BUILD_LOG.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        log(f"[build] {name}: " + " | ".join(regs))
    log(f"[build] nvcc wall {build_s:.2f} s ({time.perf_counter() - t:.2f} s)")

    t = time.perf_counter()
    k1 = phase_k1(torch, dev)
    log(f"[k1] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    k3 = phase_k3(torch, dev)
    log(f"[k3] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    slomo = SuperSloMo(None, upsampling_factor=U, batch_size=B,
                       compute_dtype="bfloat16", device="cuda", seed=0)
    em = EventEmulator(
        pos_thres=0.2, neg_thres=0.2, sigma_thres=0.03,
        cutoff_hz=300.0, leak_rate_hz=0.01, shot_noise_rate_hz=0.001,
        refractory_period_s=0.0005, seed=42,
        compaction_capacity_hint=160_000, device="cuda",
    )
    fc = FusedConverter(slomo, em)
    src = make_source_frames((3 + N_MEAS) * B + 1, H, W)
    run_chunks(np, fc, em, src, range(2), B, U)  # staged init chunk + warm chunk
    torch.cuda.synchronize()
    log(f"[fused] setup + staged + warm chunks {time.perf_counter() - t:.2f} s")

    refractory_scan.launches = 0
    bilinear_warp.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    split = []
    runs = run_chunks(np, fc, em, src, range(2, 2 + N_MEAS), B, U, split)
    wall = time.perf_counter() - t
    k1["launches"] = refractory_scan.launches
    k3["launches"] = bilinear_warp.launches
    if len(runs) != N_MEAS or not k1["launches"] or not k3["launches"]:
        raise AssertionError(
            f"main path ran {len(runs)} chunks, K1 launches {k1['launches']}, "
            f"K3 launches {k3['launches']}")
    for _, hd in runs:
        fr = hd["outs"]["dvs_frames"]
        if tuple(fr.shape) != (B * U, H, W) or not bool(torch.isfinite(fr).all()):
            raise AssertionError("interpolated frames are not finite [B*U,H,W]")
    n_ev = [len(e) for e, _ in runs]
    rtf = N_MEAS * B / SRC_FPS / wall
    log(f"[fused] {N_MEAS} measured chunks of {B * U} frames at {W}x{H}: "
        f"{wall:.3f} s, {wall / N_MEAS * 1e3:.1f} ms/chunk, realtime factor "
        f"{rtf:.4f}; events/chunk {n_ev}; K1 launches {k1['launches']}, "
        f"K3 launches {k3['launches']}; warp window {slomo.last_disp}/{fc._disp}")
    sub = [a for a, _ in split]
    col = [b for _, b in split]
    log(f"[fused] per chunk: submit (device work, waited for by compaction) "
        f"{np.mean(sub) * 1e3:.1f} ms, collect (fetch + host events) "
        f"{np.mean(col) * 1e3:.1f} ms")
    phase_profile(torch, np, fc, em, src, 2 + N_MEAS, wall / N_MEAS * 1e3)
    t = time.perf_counter()
    phase_small_reference(torch, np)
    log(f"[fused-small] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        aedat = AEDat2Output(os.path.join(tmp, "events.aedat"), W, H)
        text = DVSTextOutput(os.path.join(tmp, "events.txt"))
        header = (aedat.file.tell(), text.file.tell())
        for ev, _ in runs:
            aedat.appendEvents(ev)
            text.appendEvents(ev)
        aedat.close()
        text.close()
        sizes = (os.path.getsize(aedat.filepath), os.path.getsize(text.filepath))
        if sum(n_ev) == 0 or sizes[0] <= header[0] or sizes[1] <= header[1]:
            raise AssertionError(f"sinks hold no events: {sizes} vs headers {header}")
        if sizes[0] - header[0] != 8 * aedat.numEventsWritten:
            raise AssertionError("AEDAT-2 payload size != 8 bytes per event")
    log(f"[sinks] AEDAT-2 {sizes[0]} B, text {sizes[1]} B for {sum(n_ev)} events "
        f"({time.perf_counter() - t:.2f} s)")

    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [k1, k3]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
