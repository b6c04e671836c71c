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
     counts, i0 and K equal, base and spike-time memory within 1e-6, the
     filter seen to act (i0 > 0 somewhere, spike times updated) and one
     launch per call, with its cooperative grid printed; the same check and
     timing again after the CLI runs, at the shape run A launched K1 with;
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
     temporary directory;
  6. the CLI (v2e_tpu_torch.cli) in-process on the card, on a 346x260 PNG
     folder the script writes (33 frames at 30 fps, a bright bar moving
     40 px per frame), three times:
       A. the CLI defaults (video outputs on, so every chunk is staged) with
          auto-upsampling floored at U=67 (bucket 96 > 32): K4 and K1;
       B. --dvs_params noisy, fixed U=12, --skip_video_output (fused chunks
          after the first): K2 and K3;
       C. run B's flags and --unet_conv packedz: K2, K3 and K5 (the UNets'
          up4 and up5 conv pairs), with run B's random weights;
       D. run B's flags and --scidvs: K3 only (SciDVS never reaches K1 or
          K2: its core is a plain loop over the frames);
       E. run B's flags and the center-surround pixel (--cs_lambda_pixels 2
          --cs_tau_p_ms 3), the probe at (173,130) and every state video
          (--show_dvs_model_state all --save_dvs_model_state): the
          per-frame path, K3 only; one probe sample per emulated frame in
          pixel-states.dat and 8 non-empty state videos;
     each with the kernels' launch counters set to 0 before and read after,
     and its outputs checked (AEDAT-2 payload of 8 B per event, event times
     inside the input's span, non-empty videos in run A); then run A once
     more under torch.profiler for its device time (not counted); and runs
     A, B, B with --unet_conv packedz and B with --unet_conv packedfold45
     at 64x96 with the golden weights on the card and on the CPU, which
     must agree; then the emulator's variants: SciDVS, CSDVS exact and
     Euler and the per-frame path at 64x96 on the card against the CPU
     from one set of draws (the tolerances of tests/test_torch_variants.py),
     the SciDVS chunk and the per-frame path timed at 346x260 with the
     CSDVS surround's share, and a save, load and continue of
     EventEmulator at 346x260 (noisy, R = 0.5 ms: K1; and SciDVS) equal to
     the continuous run bit for bit;
  7. K2 (refractory-free scan) against its plain version at the shape run B
     launched it with (96 frames of 260x346), with the noisy preset's leak
     and shot noise, again at 96 frames of 720x1280 and in the clean form
     (no leak, no shot) at run B's shape: counts equal, base within 1e-6,
     one launch per call; each shape's grid, ring depth and share of its
     bound printed (a slow kernel is printed, not failed), its time also
     with the host's enqueue taken out; then emulate_chunk_apply, the
     function that calls K2, timed at run B's shape under the noisy
     preset, as it runs and with K2's call replaced by its result;
  8. K4 (tiled warp) against its plain version at the shape run A launched
     it with, flows with tile means of 33-120 px and a case where the
     residual clamp acts: max abs difference <= 1e-5; F.grid_sample is timed
     beside it;
  9. K5 (3x3 conv + bias + LeakyReLU, NHWC bf16) against its plain version
     (cuDNN's TF32 off) at the up4 and up5 shapes run C launched it with:
     every element within one bf16 ulp (1e-5 absolute near zero, where the
     two float32 sums' own rounding exceeds an ulp), at most 0.5 % of them
     differing; the weights packed once, as the UNet caches them, and
     the cached and freshly packed weights giving equal outputs; cuDNN's
     conv + bias and leaky_relu in bf16 channels_last is timed beside it,
     and each shape's share of its bound and ratio to cuDNN printed (a
     slow kernel is printed, not failed);
 10. the interp UNet's forward at the fused chunk's shape (80 x 12 channels
     of 256x320, bf16, base 32) in the conv forms dense, packedz, fold45,
     packedfold45 and fold: time and max abs difference from dense, and
     the device kernels of one dense and one fold45 forward, printed only.

Then a JSON line of the variant phases' numbers, one JSON line with every
kernel's numbers, the nvidia-smi line again,
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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) ops/s
# and dense bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12

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


def bound(nbytes: float, nops: float, peak_ops: float = PEAK_F32_OPS_S):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = nops / peak_ops * 1e3
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


def refr_inputs(torch, dev, F, dt, R, seed=1):
    """K1's test chunk: F frames of H x W at frame interval dt, leak and shot
    noise on, with a drifting texture and a bar 2.5 log units bright moving
    3 px per frame (its edges give K of about 12-33, so R > dt/K: the filter
    acts), plus per-frame noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    yy = torch.arange(H, device=dev, dtype=f32)[:, None]
    xx = torch.arange(W, device=dev, dtype=f32)[None, :]
    tt = torch.arange(F, device=dev, dtype=f32)[:, None, None]
    bar = (torch.remainder(xx + 0.5 * yy - 3.0 * tt, 96.0) < 10.0).to(f32)
    lp = (4.6 + 0.6 * torch.sin((xx + 0.2 * tt) / 17.0) * torch.cos(yy / 13.0)
          + 2.5 * bar + 0.02 * torch.randn((F, H, W), generator=g, device=dev))
    pos = torch.clamp(0.2 + 0.03 * torch.randn((H, W), generator=g, device=dev), min=0.01)
    neg = torch.clamp(0.2 + 0.03 * torch.randn((H, W), generator=g, device=dev), min=0.01)
    base = lp[0] + 0.05 * torch.randn((H, W), generator=g, device=dev)
    mem = torch.full((H, W), -R, device=dev)
    dts = torch.full((F,), dt, device=dev)
    t_prevs = torch.cumsum(dts, 0) - dts
    leak = 1e-3 * torch.rand((F, H, W), generator=g, device=dev)
    shot = (torch.rand((F, H, W), generator=g, device=dev) < 1e-3).to(torch.uint8)
    return (lp, leak, shot, pos, neg, base, mem, dts, t_prevs, R)


def check_k1(torch, F, dt, R, tag, plain_reps=2):
    """K1 against its plain version on refr_inputs: counts, i0 and K equal,
    base and spike-time memory within 1e-6, the filter seen to act (R >
    dt/K in every frame after the first, i0 > 0 somewhere, spike times
    updated), one launch; then both timed.  Returns the numbers."""
    from v2e_tpu_torch.ops.kernels.emulator_scan import (
        refractory_scan, refractory_scan_plain,
    )

    dev = torch.device("cuda")
    args = refr_inputs(torch, dev, F, dt, R)
    mem = args[6]
    before = refractory_scan.launches
    got = refractory_scan(*args)
    per_call = refractory_scan.launches - before
    grid = refractory_scan.last_call[1]
    want = refractory_scan_plain(*args)
    torch.cuda.synchronize()
    names = ("base", "mem", "counts", "i0", "K")
    for name, a, b in zip(names[2:], got[2:], want[2:]):
        n_bad = int((a != b).sum())
        if n_bad:
            raise AssertionError(f"K1 {tag} {name}: {n_bad} entries differ from the plain version")
    err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1))
    if err > 1e-6:
        raise AssertionError(f"K1 {tag} base/mem differ by {err} > 1e-6")
    n_active = int((got[4].to(torch.float32) * R > args[7]).sum())
    i0_max = int(got[3].max())
    mem_moved = int((got[1] != mem).sum())
    if n_active < F - 1 or i0_max <= 0 or mem_moved == 0:
        raise AssertionError(
            f"K1 {tag} test data leaves the refractory filter idle: active in {n_active}/{F} "
            f"frames, i0 max {i0_max}, {mem_moved} spike times updated")
    if per_call != 1:
        raise AssertionError(f"K1 {tag}: {per_call} launches per call, not 1")
    ms = time_ms(torch, lambda: refractory_scan(*args), reps=10)
    plain_ms = time_ms(torch, lambda: refractory_scan_plain(*args), reps=plain_reps,
                       warm=int(plain_reps > 1))
    refractory_scan.launches = before  # comparison launches do not count
    npix = H * W
    nbytes = F * npix * (4 + 4 + 1 + 2 + 2) + npix * (4 * 4 + 2 * 4) + F * 12
    b_ms, b_by = bound(nbytes, F * npix * 40)
    blocks, threads, regpix = grid
    log(f"[k1] {tag}: refractory scan F={F} {H}x{W}: counts/i0/K equal, base/mem max abs "
        f"err {err:.3g}; filter active in {n_active}/{F} frames (K {int(got[4].min())}"
        f"-{int(got[4].max())}), i0 max {i0_max} at {int((got[3] > 0).sum())} "
        f"pixel-frames, {mem_moved}/{npix} spike times updated; {per_call} launch per call, "
        f"cooperative grid {blocks} x {threads} threads "
        f"({'state in registers, up to %d px/thread' % regpix if regpix else 'state in global memory'}); "
        f"kernel {ms:.3f} ms ({ms / F * 1e3:.2f} us/frame), plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it); {int(got[2].abs().sum())} events "
        f"in the test chunk")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "grid": [blocks, threads, regpix], "frames": F}


def phase_k1(torch, dev):
    """K1 at the fused path's shape and frame interval (160 frames of
    260x346 at 1/300 s, R = 0.5 ms)."""
    r = check_k1(torch, U * B, 1.0 / (SRC_FPS * U), 0.0005, f"F={U * B} fused chunk")
    r.pop("frames")
    return {
        "name": "refractory_scan", "route": "cuda",
        "source": "v2e_tpu_torch/csrc/emulator_scan.cu",
        "replaces": "v2e_tpu/ops/pallas/emulator_scan.py:247",
        "library_ms": None, **r,
    }


def phase_k1_run_a(torch, shape, u, launches):
    """K1 at the shape and frame interval the CLI's run A launched it with
    (the CLI default R = 0.5 ms)."""
    F, h, w = shape
    if (h, w) != (H, W):
        raise AssertionError(f"run A launched K1 at {shape}, not at {H}x{W}")
    # one plain run (about a second at this shape) besides the check's
    r = check_k1(torch, F, 1.0 / (SRC_FPS * u), 0.0005, f"run A shape (U={u})", plain_reps=1)
    log(f"[k1] run A: {launches} launches (one per chunk)")
    return r


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


def k2_inputs(torch, dev, F, h, w, noisy=True, seed=4):
    """K2's inputs at F x h x w: the moving-bar log frames of refr_inputs,
    and with `noisy` the noisy preset's leak and shot noise drawn as
    emulate_chunk_apply draws them at run B's frame interval.  Returns the
    scan's arguments."""
    from v2e_tpu_torch.emulator.config import EmulatorConfig
    from v2e_tpu_torch.ops.core import generate_shot_noise, rescale_intensity_frame

    cfg = EmulatorConfig.noisy()
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    yy = torch.arange(h, device=dev, dtype=f32)[:, None]
    xx = torch.arange(w, device=dev, dtype=f32)[None, :]
    tt = torch.arange(F, device=dev, dtype=f32)[:, None, None]
    bar = (torch.remainder(xx + 0.5 * yy - 3.0 * tt, 96.0) < 10.0).to(f32)
    lp = (4.6 + 0.6 * torch.sin((xx + 0.2 * tt) / 17.0) * torch.cos(yy / 13.0)
          + 2.5 * bar + 0.02 * torch.randn((F, h, w), generator=g, device=dev))
    pos = torch.clamp(cfg.pos_thres + cfg.sigma_thres * torch.randn((h, w), generator=g, device=dev), min=0.01)
    neg = torch.clamp(cfg.neg_thres + cfg.sigma_thres * torch.randn((h, w), generator=g, device=dev), min=0.01)
    rate = torch.exp(2.302585 * cfg.noise_rate_cov_decades * torch.randn((h, w), generator=g, device=dev))
    dt = 1.0 / (SRC_FPS * RUN_B_U)
    leak = (dt * (cfg.leak_rate_hz * rate)
            * (1.0 - cfg.leak_jitter_fraction * torch.randn((F, h, w), generator=g, device=dev)) * pos)
    inten01 = rescale_intensity_frame(torch.exp(lp).clamp(max=255.0))
    on, off = generate_shot_noise(
        torch.rand((F, h, w), generator=g, device=dev), cfg.shot_noise_rate_hz, dt,
        cfg.shot_noise_inten_factor, inten01, 0.2 / pos, 0.2 / neg)
    shot = (on | off).to(torch.uint8)
    base = lp[0] + 0.05 * torch.randn((h, w), generator=g, device=dev)
    if not noisy:
        return lp, None, None, pos, neg, base
    return lp, leak.contiguous(), shot, pos, neg, base


def time_device_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """time_ms with the host's enqueue taken out: the stream first sleeps
    long enough for the host to queue all `reps` calls, so the events time
    the device's back-to-back run of them."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_k2(torch, dev, F, h, w, noisy, tag, plain_reps=2):
    """K2 against its plain version on k2_inputs: counts equal, base within
    1e-6, one launch per call; then both timed.  Returns the numbers."""
    from v2e_tpu_torch.ops.kernels.emulator_scan import GROUP, RING, scan, scan_plain

    args = k2_inputs(torch, dev, F, h, w, noisy)
    before = scan.launches
    got = scan(*args)
    per_call = scan.launches - before
    want = scan_plain(*args)
    torch.cuda.synchronize()
    n_bad = int((got[1] != want[1]).sum())
    if n_bad:
        raise AssertionError(f"K2 {tag}: {n_bad} counts differ from the plain version")
    err = float((got[0] - want[0]).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"K2 {tag}: base differs by {err} > 1e-6")
    if per_call != 1:
        raise AssertionError(f"K2 {tag}: {per_call} launches per call, not 1")
    plan = scan.last_plan
    ms = time_ms(torch, lambda: scan(*args), reps=20)
    dev_ms = time_device_ms(torch, lambda: scan(*args), reps=20)
    plain_ms = time_ms(torch, lambda: scan_plain(*args), reps=plain_reps)
    scan.launches = before  # comparison launches do not count
    npix = h * w
    nbytes = F * npix * (4 + (4 + 1 if noisy else 0) + 2) + npix * 4 * 4
    b_ms, b_by = bound(nbytes, F * npix * 15)
    grid = (f"grid {plan.blocks} x {plan.threads} threads, {len(plan.tiles)} tiles of up to "
            f"{plan.tile} px, ring {RING} stages x {GROUP} frames x {plan.frame_bytes} B "
            f"({plan.smem_bytes} B of shared memory)")
    noise = (f"noisy preset leak and shot, {int(args[2].sum())} shot resets" if noisy
             else "clean: no leak, no shot")
    log(f"[k2] {tag}: scan F={F} {h}x{w} ({noise}): "
        f"counts equal, base max abs err {err:.3g}; {per_call} launch per call, {grid}; "
        f"kernel {ms:.4f} ms (device only {dev_ms:.4f}), plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it ({b_ms / dev_ms:.1%} device only); "
        f"{int(got[1].abs().sum())} events")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "frames": F, "shape": [h, w],
            "ring_frames": RING * GROUP}


def time_chunk_apply(torch, dev, F, h, w):
    """emulate_chunk_apply (emulator/core.py), the function that calls K2,
    under the noisy preset (R = 0) on F frames of h x w: timed as it runs,
    and with K2's call replaced by its result, alternately 5 times each
    (the call is host-bound, so its wall spreads); then once under the
    profiler, which splits its device time by kernel.  Returns the two
    medians."""
    import v2e_tpu_torch.emulator.core as core
    from v2e_tpu_torch.emulator.config import EmulatorConfig
    from v2e_tpu_torch.emulator.state import init_state

    cfg = EmulatorConfig.noisy()
    g = torch.Generator(device=dev).manual_seed(5)
    frames = 255.0 * torch.rand((F + 1, h, w), generator=g, device=dev)
    params, state = init_state(cfg, frames[0], 0.0, g)
    times = torch.arange(1, F + 1, device=dev, dtype=torch.float32) / (SRC_FPS * RUN_B_U)
    draws = core.draw_chunk_noise(cfg, F, (h, w), g, dev)

    def run():
        return core.emulate_chunk_apply(cfg, params, state, frames[1:], times, draws)

    real = core.scan
    kept = []

    def record(*a):
        kept.append(real(*a))
        return kept[-1]

    with_k2, without = [], []
    try:
        core.scan = record
        run()
        for _ in range(5):
            core.scan = real
            with_k2.append(time_ms(torch, run, reps=4))
            core.scan = lambda *a: kept[0]
            without.append(time_ms(torch, run, reps=4))
    finally:
        core.scan = real
    ms, without_ms = sorted(with_k2)[2], sorted(without)[2]
    profile_device(torch, "k2", run, ms, "emulate_chunk_apply at run B's shape", top=6)
    return ms, without_ms


def phase_k2(torch, dev, shape, launches):
    """K2 at the shape the CLI's run B launched it with (the noisy preset's
    leak and shot noise), at 720x1280 with the same frames and noise, and in
    the clean form (no leak, no shot) at run B's shape; then
    emulate_chunk_apply, the function that calls K2, at run B's shape."""
    F, h, w = shape
    if (h, w) != (H, W):
        raise AssertionError(f"run B launched K2 at {shape}, not at {H}x{W}")
    main = check_k2(torch, dev, F, h, w, True, "run B shape")
    big = check_k2(torch, dev, F, 720, 1280, True, "720x1280", plain_reps=1)
    clean = check_k2(torch, dev, F, h, w, False, "clean form")
    apply_ms, without_ms = time_chunk_apply(torch, dev, F, h, w)
    log(f"[k2] emulate_chunk_apply at run B's shape (noisy): {apply_ms:.4f} ms per chunk "
        f"(median of 5), {without_ms:.4f} ms with K2's call replaced by its result; "
        f"{launches} K2 launches in run B")
    main.pop("frames")
    main.pop("shape")
    return {
        "name": "scan", "route": "cuda", "launches": launches,
        "source": "v2e_tpu_torch/csrc/emulator_scan.cu",
        "replaces": "v2e_tpu/ops/pallas/emulator_scan.py:72",
        "library_ms": None, **main,
        "at_720x1280": big, "clean": clean, "chunk_apply_ms": apply_ms,
        "chunk_apply_without_k2_ms": without_ms,
    }


def phase_k4(torch, dev, shape, max_base, launches):
    """K4 at the shape the CLI's run A launched it with."""
    import torch.nn.functional as Fn

    from v2e_tpu_torch.ops.kernels.warp_tiled import tile_bases, warp_tiled, warp_tiled_plain

    N, h, w = shape
    g = torch.Generator(device=dev).manual_seed(5)
    img = torch.rand((N, h, w), generator=g, device=dev) - 0.428
    # per plane a motion of 33-120 px in a random direction, plus smooth
    # variation of a few px: inside the residual envelope
    mag = 33.0 + 87.0 * torch.rand((N, 1, 1, 1), generator=g, device=dev)
    ang = 6.2831853 * torch.rand((N, 1, 1, 1), generator=g, device=dev)
    mean = torch.cat([mag * torch.cos(ang), mag * torch.sin(ang)], dim=1)
    coarse = torch.rand((N, 2, 5, 6), generator=g, device=dev) * 6.0 - 3.0
    flow = (mean + Fn.interpolate(coarse, size=(h, w), mode="bilinear",
                                  align_corners=True)).contiguous()
    # a second set where the flow varies by far more than the residual window
    flow_clamped = (flow + torch.rand(flow.shape, generator=g, device=dev) * 240.0 - 120.0).contiguous()

    errs = []
    for fl in (flow, flow_clamped):
        got = warp_tiled(img, fl[:, 0], fl[:, 1], max_base)
        want = warp_tiled_plain(img, fl[:, 0], fl[:, 1], max_base)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
    err = max(errs)
    if not err <= 1e-5:
        raise AssertionError(f"K4 differs from the plain version by {errs} > 1e-5")
    bu, bv = tile_bases(flow[:, 0], flow[:, 1], max_base)
    # the clamped case must leave the envelope somewhere: compare with the
    # unclamped gather
    from v2e_tpu_torch.ops.kernels.warp import warp_plain

    off_envelope = float((warp_tiled(img, flow_clamped[:, 0], flow_clamped[:, 1], max_base)
                          - warp_plain(img, flow_clamped[:, 0], flow_clamped[:, 1])).abs().max())
    if off_envelope < 0.05:
        raise AssertionError("K4 clamp case never left the residual envelope")

    u, v = flow[:, 0], flow[:, 1]
    gx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    gy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    grid = torch.stack([2.0 * ((gx + u) / w - 0.5), 2.0 * ((gy + v) / h - 0.5)], dim=-1)
    img4 = img[:, None]

    def lib():
        return Fn.grid_sample(img4, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False)

    lib_err = float((lib()[:, 0] - warp_tiled_plain(img, u, v, max_base)).abs().max())
    ms = time_ms(torch, lambda: warp_tiled(img, u, v, max_base), reps=20)
    plain_ms = time_ms(torch, lambda: warp_tiled_plain(img, u, v, max_base), reps=3)
    library_ms = time_ms(torch, lib, reps=20)
    b_ms, b_by = bound(N * h * w * 16, N * h * w * 40)
    log(f"[k4] tiled warp N={N} {h}x{w} max_base {max_base}: max abs err {errs[0]:.3g} "
        f"(motion {float(mag.min()):.1f}-{float(mag.max()):.1f} px, tile bases "
        f"x {int(bu.min())}..{int(bu.max())}, y {int(bv.min())}..{int(bv.max())}), "
        f"{errs[1]:.3g} with the clamp active ({off_envelope:.3g} off the unclamped warp); "
        f"grid_sample {lib_err:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"grid_sample {library_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); {launches} launches "
        f"in run A")
    return {
        "name": "warp_tiled", "route": "cuda", "launches": launches,
        "source": "v2e_tpu_torch/csrc/warp_tiled.cu",
        "replaces": "v2e_tpu/ops/pallas/warp_v2.py:116",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


CLI_FRAMES = 33
RUN_B_U = 12  # run B's fixed upsampling (--timestamp_resolution 0.003 at 30 fps)


def write_cli_input(np, folder):
    """CLI_FRAMES PNGs of 346x260: a textured background and a bright bar
    moving 40 px per frame."""
    import cv2

    os.makedirs(folder)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in range(CLI_FRAMES):
        f = 70 + 30 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
        x0 = (20 + 40 * i) % W
        f[:, x0: x0 + 24] += 120
        cv2.imwrite(os.path.join(folder, f"{i:04d}.png"), np.clip(f, 0, 255).astype(np.uint8))


def read_aedat2(path):
    with open(path, "rb") as f:
        data = f.read()
    header = 0
    while data[header: header + 1] == b"#":
        header = data.index(b"\r\n", header) + 2
    return len(data) - header


def phase_cli(torch, np, tmp, counters):
    """The port's CLI, runs A, B and C, then run A once more under
    torch.profiler (its launches not counted).  Returns {run: launches by
    kernel} and {run: the last [N,H,W] (and max_base) each kernel of the
    run was launched with; for K5 every ((N,H,W,Ci), Co) with its
    launches}."""
    from v2e_tpu_torch import cli
    from v2e_tpu_torch.ops.kernels.conv3 import conv3x3_lane

    src = os.path.join(tmp, "frames")
    write_cli_input(np, src)
    span = (CLI_FRAMES - 1) / SRC_FPS
    runs = {
        "A": ["--allow_random_slomo", "--auto_timestamp_resolution", "True",
              "--timestamp_resolution", "0.0005", "--dvs_aedat2", "a.aedat",
              "--dvs_text", "a.txt"],
        "B": ["--allow_random_slomo", "--dvs_params", "noisy",
              "--auto_timestamp_resolution", "False", "--timestamp_resolution", "0.003",
              "--skip_video_output", "--dvs_aedat2", "b.aedat"],
    }
    runs["C"] = runs["B"][:-1] + ["c.aedat", "--unet_conv", "packedz"]
    runs["D"] = runs["B"][:-1] + ["d.aedat", "--scidvs"]
    runs["E"] = runs["B"][:-1] + ["e.aedat"] + VARIANT_E
    want = {"A": ("warp_tiled", "refractory_scan"), "B": ("scan", "bilinear_warp"),
            "C": ("scan", "bilinear_warp", "conv3x3_lane"), "D": ("bilinear_warp",),
            "E": ("bilinear_warp",)}
    walls, events = {}, {}
    absent = {"A": ("bilinear_warp", "scan", "conv3x3_lane"),
              "B": ("warp_tiled", "refractory_scan", "conv3x3_lane"),
              "C": ("warp_tiled", "refractory_scan"),
              "D": ("warp_tiled", "refractory_scan", "scan", "conv3x3_lane"),
              "E": ("warp_tiled", "refractory_scan", "scan", "conv3x3_lane")}
    launches, shapes, n_frames = {}, {}, {}
    for name, flags in runs.items():
        out = os.path.join(tmp, "out" + name)
        argv = ["-i", src, "--input_frame_rate", str(SRC_FPS), "-o", out] + flags
        for fn in counters.values():
            fn.launches = 0
        conv3x3_lane.shapes = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = cli.run(argv, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        shapes[name] = {k: counters[k].last_call for k in want[name] if k in ("scan", "warp_tiled")}
        if name == "A":
            shapes[name]["refractory_scan"] = counters["refractory_scan"].last_call[0]
            shapes[name]["U"] = stats.upsampling[-1]
        if name == "C":
            shapes[name]["conv3x3_lane"] = dict(conv3x3_lane.shapes)
        walls[name] = wall
        events[name] = stats.num_events
        n_frames[name] = stats.n_frames
        aedat = os.path.join(out, name.lower() + ".aedat")
        payload = read_aedat2(aedat)
        # the sink drops leading events whose first byte would be '#' (a
        # header line to jAER's parser): a few at most, and rarely any
        dropped = stats.num_events - payload // 8
        if stats.num_events <= 0 or payload % 8 or not 0 <= dropped <= 4:
            raise AssertionError(f"run {name}: AEDAT-2 payload {payload} B for "
                                 f"{stats.num_events} events")
        if not (stats.first_ts >= 0.0 and stats.last_ts <= span + 1e-9):
            raise AssertionError(f"run {name}: frame times {stats.first_ts}-{stats.last_ts} "
                                 f"outside the input's 0-{span} s")
        if name == "A":
            ev = np.loadtxt(os.path.join(out, "a.txt"), comments="#", usecols=0)
            if not (ev.min() >= -1e-6 and ev.max() <= span + 1e-6):
                raise AssertionError(f"run A: event times {ev.min()}-{ev.max()} outside 0-{span} s")
            for vid in ("dvs-video.avi", "video_orig.avi", "video_slomo.avi"):
                if os.path.getsize(os.path.join(out, vid)) <= 0:
                    raise AssertionError(f"run A: {vid} is empty")
        if name == "A" and (min(stats.upsampling) <= 32 or stats.fused_chunks):
            raise AssertionError(f"run A: U {stats.upsampling}, {stats.fused_chunks} fused "
                                 "chunks; wants U > 32 and every chunk staged")
        if name == "E":
            check_run_e(np, out, stats)
        if name in "BCDE" and (set(stats.upsampling) != {RUN_B_U} or not stats.fused_chunks):
            raise AssertionError(f"run {name}: U {stats.upsampling}, {stats.fused_chunks} "
                                 "fused chunks; wants U = 12 and fused chunks")
        bad = [k for k in want[name] if not launches[name][k]]
        bad += [k for k in absent[name] if launches[name][k]]
        if bad:
            raise AssertionError(f"run {name}: kernel launches {launches[name]}")
        path = f"{stats.staged_chunks} staged + {stats.fused_chunks} fused chunks"
        log(f"[cli] run {name}: U {stats.upsampling}, {path}; launches "
            + ", ".join(f"{k} {v}" for k, v in launches[name].items())
            + f"; {stats.n_frames} frames, {stats.num_events} events, AEDAT-2 "
            f"{payload} B ({dropped} leading events dropped by the '#' guard); "
            f"wall {wall:.2f} s, realtime factor "
            f"{stats.realtime_factor:.4f} (cli {stats.wall_s:.2f} s)")
    log(f"[cli] run D (SciDVS): events D {events['D']} vs B {events['B']}; run E "
        f"(CSDVS, probe, 8 state videos): {walls['E'] / n_frames['E'] * 1e3:.3f} ms of CLI "
        f"wall per interpolated frame (SloMo, the per-frame path and the state videos' "
        f"encoding), run B {walls['B'] / n_frames['B'] * 1e3:.3f} ms")
    k5 = shapes["C"]["conv3x3_lane"]
    log("[cli] run C: K5 launches by ((N,H,W,Ci), Co): "
        + "; ".join(f"{k} x{v}" for k, v in sorted(k5.items()))
        + f"; events C {events['C']} vs B {events['B']} "
        f"({(events['C'] - events['B']) / events['B']:+.3%}), same random weights, "
        "K5's float32 epilogue against the dense bf16 one")
    argv = ["-i", src, "--input_frame_rate", str(SRC_FPS), "-o", os.path.join(tmp, "outP")]
    profile_device(torch, "cli-profile", lambda: cli.run(argv + runs["A"], device="cuda"),
                   walls["A"] * 1e3, "run A again", top=8)
    return launches, shapes


# run E's variant flags: the center-surround pixel, the probe at the
# sensor's centre and every model-state video
PROBE = (173, 130)
VARIANT_E = ["--cs_lambda_pixels", "2", "--cs_tau_p_ms", "3",
             "--record_single_pixel_states", f"({PROBE[0]},{PROBE[1]})",
             "--show_dvs_model_state", "all", "--save_dvs_model_state"]
RUN_E_STATES = ("new_frame", "log_new_frame", "lp_log_frame", "photoreceptor_noise_arr",
                "cs_surround_frame", "c_minus_s_frame", "base_log_frame", "diff_frame")


def check_run_e(np, out, stats):
    """Run E's probe record holds one sample per emulated frame (every
    interpolated frame but the first, which initializes the emulator), and
    every state video of a CSDVS pixel is there and not empty."""
    import pickle

    with open(os.path.join(out, "pixel-states.dat"), "rb") as f:
        rec = pickle.load(f)
    n = int(np.isfinite(rec["time"]).sum())
    if n != stats.n_frames - 1 or not np.isfinite(rec["diff_frame"][:n]).all():
        raise AssertionError(f"run E: {n} probe samples for {stats.n_frames} frames")
    sizes = {name: os.path.getsize(os.path.join(out, name + ".avi")) for name in RUN_E_STATES}
    if min(sizes.values()) <= 0:
        raise AssertionError(f"run E: state videos {sizes}")
    log(f"[cli] run E: pixel-states.dat {n} samples at {PROBE}; state videos "
        + ", ".join(f"{k} {v} B" for k, v in sizes.items()))


def variant_chunk(torch, dev, cfg, F, h, w, seed=6):
    """F frames of h x w (the moving-bar frames of refr_inputs as linear
    0-255 intensity, run B's frame interval), the emulator's params and
    state from frame 0, and the chunk's draws, for `cfg`."""
    from v2e_tpu_torch.emulator.core import draw_chunk_noise
    from v2e_tpu_torch.emulator.state import init_state

    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    yy = torch.arange(h, device=dev, dtype=f32)[:, None]
    xx = torch.arange(w, device=dev, dtype=f32)[None, :]
    tt = torch.arange(F + 1, device=dev, dtype=f32)[:, None, None]
    bar = (torch.remainder(xx + 0.5 * yy - 3.0 * tt, 96.0) < 10.0).to(f32)
    frames = torch.round(torch.clamp(
        90 + 40 * torch.sin((xx + 0.2 * tt) / 17.0) * torch.cos(yy / 13.0) + 110 * bar
        + 2 * torch.randn((F + 1, h, w), generator=g, device=dev), 0, 255))
    params, state = init_state(cfg, frames[0], 0.0, g)
    times = torch.arange(1, F + 1, device=dev, dtype=f32) / (SRC_FPS * RUN_B_U)
    return params, state, frames[1:], times, draw_chunk_noise(cfg, F, (h, w), g, dev)


def variant_configs():
    """The configurations the variant phases run: run D's and run E's
    emulators (the noisy preset with SciDVS, and with CSDVS, the probe and
    every state), CSDVS with the Euler solver, and SciDVS and the plain
    pixel at R = 0.5 ms."""
    import dataclasses

    from v2e_tpu_torch.emulator.config import EmulatorConfig
    from v2e_tpu_torch.emulator.emulator import MODEL_STATES

    noisy = EmulatorConfig.noisy()
    csdvs = dataclasses.replace(noisy, cs_lambda_pixels=2.0, cs_tau_p_ms=3.0)
    return {
        "scidvs": dataclasses.replace(noisy, scidvs=True),
        "scidvs R=0.5ms": dataclasses.replace(noisy, scidvs=True, refractory_period_s=5e-4),
        "csdvs+probe+states": dataclasses.replace(
            csdvs, probe=(PROBE[0] * 96 // W, PROBE[1] * 64 // H),
            emit_states=tuple(MODEL_STATES)),
        "csdvs euler": dataclasses.replace(csdvs, csdvs_solver="euler"),
        "per-frame R=0.5ms": dataclasses.replace(
            noisy, refractory_period_s=5e-4, probe=(3, 4), emit_states=("diff_frame",)),
    }


# tolerances of tests/test_torch_variants.py (the port against v2e_tpu on
# the CPU), held here between the card and the CPU
COUNT_SHARE = 1e-3
ATOL_SCIDVS = 1e-6
ATOL_STATES = 1e-5
ATOL_CS_EULER = 2e-6


def phase_variants_small(torch, np, dev):
    """The variant paths at 64x96 on the card and on the CPU, from one set
    of inputs and draws made on the CPU: counts, i0, K and stride equal at
    >= 99.9 % of pixel-frames; the SciDVS highpass and base within 1e-6;
    the probe, every state frame and the final state within 1e-5 (the Euler
    surround within 2e-6)."""
    import dataclasses

    from v2e_tpu_torch.emulator.core import emulate_chunk_apply

    def moved(obj, d):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(d) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None})

    h, w, F = 64, 96, 24
    cpu = torch.device("cpu")
    for name, cfg in variant_configs().items():
        params, state, frames, times, draws = variant_chunk(torch, cpu, cfg, F, h, w)
        (gn, go), (cn, co) = (emulate_chunk_apply(
            cfg, moved(params, d), moved(state, d), frames.to(d), times.to(d),
            {k: (None if v is None else v.to(d)) for k, v in draws.items()}) for d in (dev, cpu))
        shares = {k: float((go[k].cpu() != co[k]).float().mean())
                  for k in ("ev_count", "i0", "K", "stride")}
        errs = {}
        for f in ("base_log_frame", "scidvs_highpass", "cs_surround_frame"):
            if getattr(cn, f) is not None:
                errs[f] = float((getattr(gn, f).cpu() - getattr(cn, f)).abs().max())
        for k, v in go.get("states", {}).items():
            errs["state " + k] = float((v.cpu() - co["states"][k]).abs().max())
        if "probe" in go:
            errs["probe"] = float((go["probe"].cpu() - co["probe"]).abs().max())
        limit = {"base_log_frame": ATOL_SCIDVS if cfg.scidvs else ATOL_STATES,
                 "scidvs_highpass": ATOL_SCIDVS,
                 "cs_surround_frame": ATOL_CS_EULER if cfg.csdvs_solver == "euler"
                 else ATOL_STATES}
        bad = [k for k, v in shares.items() if v > COUNT_SHARE]
        bad += [k for k, v in errs.items() if not v <= limit.get(k, ATOL_STATES)]
        n_ev = int(co["ev_count"].abs().sum())
        if bad or n_ev == 0:
            raise AssertionError(f"[variants-small] {name}: card vs CPU {bad}: shares "
                                 f"{shares}, errors {errs}, {n_ev} events")
        log(f"[variants-small] {name} at {h}x{w}, F={F}: card vs CPU counts differ at "
            f"{shares['ev_count']:.4%} of pixel-frames ({n_ev} events on the CPU); max abs "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def phase_variants_time(torch, dev, F=96):
    """At 346x260 on the card: the SciDVS chunk (run D's emulator, F frames
    at run B's frame interval) and the per-frame path (run E's emulator)
    timed through emulate_chunk_apply, the per-frame path's ms per frame,
    and the CSDVS surround update's share of it; then one per-frame chunk
    under the profiler.  Returns the numbers."""
    import dataclasses

    from v2e_tpu_torch.emulator import core

    cfgs = variant_configs()
    out = {}
    for name, key, n in (("scidvs", "scidvs", F), ("per-frame", "csdvs+probe+states", F // 4)):
        cfg = cfgs[key]
        if name == "per-frame":
            cfg = dataclasses.replace(cfg, probe=PROBE)
        params, state, frames, times, draws = variant_chunk(torch, dev, cfg, n, H, W)

        def run():
            return core.emulate_chunk_apply(cfg, params, state, frames, times, draws)

        ms = sorted(time_ms(torch, run, reps=2) for _ in range(3))[1]
        out[name] = {"frames": n, "chunk_ms": ms, "ms_per_frame": ms / n}
        if name == "per-frame":
            lp, sur = state.lp_log_frame, state.cs_surround_frame
            dt = times[0] - state.t_prev
            dct_ms = time_ms(torch, lambda: core._update_csdvs(cfg, lp, sur, dt), reps=20)
            out[name]["csdvs_update_ms"] = dct_ms
            out[name]["csdvs_share"] = dct_ms / (ms / n)
            profile_device(torch, "variants-time", run, ms,
                           f"one per-frame chunk of {n} frames", top=8)
    sci, pf = out["scidvs"], out["per-frame"]
    log(f"[variants-time] at {W}x{H}: SciDVS chunk of {sci['frames']} frames "
        f"{sci['chunk_ms']:.3f} ms ({sci['ms_per_frame']:.4f} ms/frame, plain loop); "
        f"per-frame path (CSDVS exact, probe, 9 states) {pf['ms_per_frame']:.4f} ms/frame "
        f"over {pf['frames']} frames, of which the CSDVS surround update (two float64 "
        f"DCT pairs) {pf['csdvs_update_ms']:.4f} ms ({pf['csdvs_share']:.1%})")
    return out


def phase_resume(torch, np, dev, counters):
    """EventEmulator at 346x260 under the noisy preset with R = 0.5 ms (K1)
    and again with SciDVS (no kernel): run chunk 1, save, run chunk 2; load
    the checkpoint into a new emulator and run chunk 2 there.  The resumed
    events, counters and state equal the continuous run's bit for bit; K1
    launches in the plain case and in no SciDVS run."""
    import dataclasses

    from v2e_tpu_torch.emulator import EventEmulator
    from v2e_tpu_torch.synthetic import make_source_frames

    n1, n2 = 49, 48
    src = make_source_frames(n1 + n2, H, W, seed=2).astype(np.float32)
    times = np.arange(n1 + n2) / (SRC_FPS * RUN_B_U)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in (("refractory", {}), ("scidvs", {"scidvs": True})):
            for fn in counters.values():
                fn.launches = 0
            ems = []
            for _ in range(2):
                em = EventEmulator(seed=3, device=dev, **kw)
                em.set_dvs_params("noisy")
                em.cfg = dataclasses.replace(em.cfg, refractory_period_s=5e-4)
                ems.append(em)
            cont, resumed = ems
            ckpt = os.path.join(tmp, name + ".npz")
            first = cont.generate_events_batch(src[:n1], times[:n1])
            cont.save_state(ckpt)
            want = cont.generate_events_batch(src[n1:], times[n1:])
            resumed.load_state(ckpt)
            got = resumed.generate_events_batch(src[n1:], times[n1:])
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items()}
            same = (got is not None and want is not None and got.shape == want.shape
                    and np.array_equal(got, want)
                    and (resumed.num_events_on, resumed.num_events_off)
                    == (cont.num_events_on, cont.num_events_off)
                    and all(torch.equal(getattr(resumed.state, f.name), getattr(cont.state, f.name))
                            for f in dataclasses.fields(cont.state)
                            if getattr(cont.state, f.name) is not None))
            k1 = launches["refractory_scan"]
            other = sum(v for k, v in launches.items() if k != "refractory_scan")
            if not same or other or (k1 == 0) == (not kw) or first is None:
                raise AssertionError(f"[resume] {name}: resumed == continuous {same}, "
                                     f"launches {launches}")
            res[name] = {"events": int(len(want)), "k1_launches": k1}
            log(f"[resume] {name} at {W}x{H}: chunk 1 {n1} frames, saved, chunk 2 {n2} "
                f"frames: {len(want)} events resumed == continuous bit for bit (events, "
                f"counters, state); launches {launches}")
    return res


def phase_cli_small(torch, np, tmp):
    """Runs A and B at 64x96 with the golden SuperSloMo fixture and
    deterministic emulator flags, and run B with --unet_conv packedz (K5 on
    up2 and up3 at base 8) and with --unet_conv packedfold45 (the fold on
    up4 and up5), on the card and on the CPU: the same U and chunk paths,
    and event totals within 1 % (the CLI computes the UNets in bf16, whose
    sums cuDNN and the CPU round differently, which flips some
    interpolated pixels by one 8-bit level)."""
    import cv2

    from v2e_tpu_torch import cli

    src = os.path.join(tmp, "small")
    os.makedirs(src)
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float32)
    for i in range(12):
        f = 70 + 40 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
        f[:, (10 + 6 * i) % 96: (10 + 6 * i) % 96 + 8] += 100
        cv2.imwrite(os.path.join(src, f"{i:04d}.png"), np.clip(f, 0, 255).astype(np.uint8))
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "fixtures", "slomo_golden.npz")
    common = ["-i", src, "--input_frame_rate", str(SRC_FPS), "--slomo_model", golden,
              "--batch_size", "4", "--dvs_text", "ev.txt", "--no_shuffle",
              "--sigma_thres", "0", "--leak_rate_hz", "0", "--shot_noise_rate_hz", "0",
              "--cutoff_hz", "0"]
    runs = {"A": ["--auto_timestamp_resolution", "True", "--timestamp_resolution", "0.0005"],
            "B": ["--refractory_period", "0", "--auto_timestamp_resolution", "False",
                  "--timestamp_resolution", "0.003", "--skip_video_output"]}
    runs["B packedz"] = runs["B"] + ["--unet_conv", "packedz"]
    runs["B packedfold45"] = runs["B"] + ["--unet_conv", "packedfold45"]
    for name, flags in runs.items():
        res = {}
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, f"small{name.replace(' ', '-')}-{device}")
            st = cli.run(common + flags + ["-o", out], device=device)
            res[device] = (st.upsampling, st.staged_chunks, st.fused_chunks, st.num_events)
        (ug, sg, fg, ng), (uc, sc, fc_, nc) = res["cuda"], res["cpu"]
        if (ug, sg, fg) != (uc, sc, fc_) or abs(ng - nc) > 0.01 * nc or nc == 0:
            raise AssertionError(f"small run {name}: card {res['cuda']} vs CPU {res['cpu']}")
        log(f"[cli-small] run {name} at 64x96: U {ug}, {sg} staged + {fg} fused chunks on "
            f"both; events card {ng} vs CPU {nc} ({abs(ng - nc) / nc:.3%})")


def phase_k5(torch, dev, shapes, launches):
    """K5 at the up4 and up5 shapes run C launched it with (for each (Ci,
    Co), the largest batch: the interp UNet's), bf16 as the CLI runs it."""
    import torch.nn.functional as Fn

    from v2e_tpu_torch.ops.kernels.conv3 import (
        conv3x3_lane, conv3x3_lane_plain, pack_conv3_weights,
    )

    picked = {}
    for (xs, co), _ in shapes.items():
        key = (xs[3], co)
        if key not in picked or xs[0] > picked[key][0][0]:
            picked[key] = (xs, co)
    if set(picked) != {(128, 64), (64, 32)}:
        raise AssertionError(f"run C launched K5 at {sorted(shapes)}, not at up4 and up5")
    g = torch.Generator(device=dev).manual_seed(7)
    torch.backends.cudnn.allow_tf32 = False
    before = conv3x3_lane.launches
    rows, err, tot = [], 0.0, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
                               "flops": 0.0}
    for (n, h, w, ci), co in sorted(picked.values(), key=lambda v: -v[0][3]):
        x = torch.randn((n, h, w, ci), generator=g, device=dev).to(torch.bfloat16)
        wt = torch.randn((co, ci, 3, 3), generator=g, device=dev) / (9 * ci) ** 0.5
        b = 0.1 * torch.randn((co,), generator=g, device=dev)
        # the weights packed once, as UNet.keep_float32_terms caches them
        packed = pack_conv3_weights(wt, torch.bfloat16)
        got = conv3x3_lane(x, wt, b, 0.1, packed=packed)
        if not torch.equal(got, conv3x3_lane(x, wt, b)):
            raise AssertionError("K5 with cached packed weights differs from fresh packing")
        want = conv3x3_lane_plain(x, wt, b)
        torch.cuda.synchronize()
        a, r = got.double(), want.double()
        m = torch.maximum(a.abs(), r.abs())
        tol = torch.clamp(torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8), min=1e-5)
        n_bad = int(((a - r).abs() > tol).sum())
        share = float((a != r).double().mean())
        e = float((a - r).abs().max())
        if n_bad or share > 5e-3:
            raise AssertionError(f"K5 at {(n, h, w, ci, co)}: {n_bad} elements beyond one "
                                 f"bf16 ulp, {share:.4%} differ from the plain version")
        err = max(err, e)
        # yardstick: cuDNN's conv with bias, then leaky_relu, bf16 channels_last
        xc = x.permute(0, 3, 1, 2)
        wc = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bb = b.to(torch.bfloat16)

        def lib():
            return Fn.leaky_relu(Fn.conv2d(xc, wc, bb, padding=1), 0.1)

        ms = time_ms(torch, lambda: conv3x3_lane(x, wt, b, 0.1, packed=packed), reps=10)
        plain_ms = time_ms(torch, lambda: conv3x3_lane_plain(x, wt, b), reps=3)
        library_ms = time_ms(torch, lib, reps=10)
        nbytes = 2 * n * h * w * (ci + co) + 2 * 9 * ci * co + 4 * co
        flops = 2 * n * h * w * ci * co * 9
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_OPS_S)
        log(f"[k5] conv3x3_lane {n}x{h}x{w} {ci}->{co} bf16: max abs err {e:.3g}, "
            f"{share:.4%} of elements differ (all within one bf16 ulp); kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, cuDNN conv+leaky_relu {library_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP), "
            f"{flops / ms / 1e9:.1f} TFLOP/s; {b_ms / ms:.1%} of the bound, "
            f"{ms / library_ms:.3f}x cuDNN's time")
        rows.append(f"{n}x{h}x{w}x{ci}->{co}")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                     ("bytes", nbytes), ("flops", flops)):
            tot[k] += v
    torch.backends.cudnn.allow_tf32 = True
    conv3x3_lane.launches = before  # comparison launches do not count
    b_ms, b_by = bound(tot["bytes"], tot["flops"], PEAK_BF16_OPS_S)
    log(f"[k5] {launches} launches in run C; both shapes together (one call each): "
        f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, cuDNN "
        f"{tot['library_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}); {b_ms / tot['ms']:.1%} "
        f"of the bound, {tot['ms'] / tot['library_ms']:.3f}x cuDNN's time")
    return {
        "name": "conv3x3_lane", "route": "cuda", "launches": launches,
        "source": "v2e_tpu_torch/csrc/conv3x3.cu",
        "replaces": "v2e_tpu/ops/pallas/conv3.py:201",
        "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": tot["library_ms"],
        "shapes": rows,
    }


def phase_unet_forms(torch, dev, n=U * B // 2, h=256, w=320):
    """The interp UNet's forward in five conv forms at the fused chunk's
    shape (n = 80: _group_split(10, 16, 96) gives 2 groups of 5 x 16 pairs):
    times and differences from dense, printed only."""
    from v2e_tpu_torch.models.convert_ckpt import from_jax_params, init_random_slomo_params
    from v2e_tpu_torch.models.unet import unet_apply

    _, net = from_jax_params(*init_random_slomo_params(seed=0), device=dev,
                             dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(8)
    x = 0.3 * torch.randn((n, 12, h, w), generator=g, device=dev)
    dense = None
    for form in ("dense", "packedz", "fold45", "packedfold45", "fold"):
        with torch.no_grad():
            out = unet_apply(net, x, form)
            ms = time_ms(torch, lambda: unet_apply(net, x, form), reps=3)
        if dense is None:
            dense, dense_ms = out, ms
        diff = float((out - dense).abs().max())
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"unet form {form}: non-finite output")
        log(f"[unet-forms] interp UNet {n}x12x{h}x{w} bf16 {form}: {ms:.2f} ms "
            f"({ms / dense_ms:.3f} of dense), max abs diff from dense {diff:.3g}")
    for form in ("dense", "fold45"):
        with torch.no_grad():
            profile_device(torch, "unet-forms", lambda: unet_apply(net, x, form), dense_ms,
                           f"{form} forward (share of dense's time)", top=5)


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
        t0 = time.perf_counter()
        handle, got_u, times = fc.submit_window(src[c * b: c * b + b + 1], c * b, 1.0 / SRC_FPS)
        if got_u != u:
            raise AssertionError(f"chunk {c} ran at U={got_u}, not {u}")
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


def profile_device(torch, tag, fn, ref_ms, what, top=12):
    """Run fn under torch.profiler and print the device kernel time by
    name and its share of `ref_ms`, the same work's unprofiled wall time.
    Informational: prints "not measured" where the profiler sees no device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        # device-side kernel events only (the aten ops repeat their times)
        if dev_us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key))
    if not rows:
        log(f"[{tag}] device time not measured (the profiler saw no device)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{tag}] {what}: device kernel time {busy:.1f} ms in {len(rows)} kernels "
        f"(wall {wall_ms:.1f} ms with the profiler on; {busy / ref_ms:.1%} of the "
        f"unprofiled {ref_ms:.1f} ms)")
    for ms, n, name in rows[:top]:
        log(f"[{tag}]   {ms:9.3f} ms x{n:<5d} {name[:100]}")


def phase_profile(torch, np, fc, em, src, c, chunk_ms):
    """One more chunk of the fused path under torch.profiler."""
    profile_device(torch, "profile", lambda: run_chunks(np, fc, em, src, [c], B, U),
                   chunk_ms, "one chunk")


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
    from v2e_tpu_torch.ops.kernels.conv3 import conv3x3_lane
    from v2e_tpu_torch.ops.kernels.emulator_scan import refractory_scan, scan
    from v2e_tpu_torch.ops.kernels.warp import bilinear_warp
    from v2e_tpu_torch.ops.kernels.warp_tiled import warp_tiled
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

    t = time.perf_counter()
    counters = {"refractory_scan": refractory_scan, "scan": scan,
                "bilinear_warp": bilinear_warp, "warp_tiled": warp_tiled,
                "conv3x3_lane": conv3x3_lane}
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, cli_shapes = phase_cli(torch, np, tmp, counters)
        log(f"[cli] {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        phase_cli_small(torch, np, tmp)
        log(f"[cli-small] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    phase_variants_small(torch, np, dev)
    log(f"[variants-small] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    variants = phase_variants_time(torch, dev)
    log(f"[variants-time] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    resume = phase_resume(torch, np, dev, counters)
    k1["resume_launches"] = resume["refractory"]["k1_launches"]
    log(f"[resume] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    k1["run_a"] = phase_k1_run_a(torch, cli_shapes["A"]["refractory_scan"], cli_shapes["A"]["U"],
                                 cli_launches["A"]["refractory_scan"])
    log(f"[k1] run A shape {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    k2 = phase_k2(torch, dev, cli_shapes["B"]["scan"], cli_launches["B"]["scan"])
    log(f"[k2] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    k4 = phase_k4(torch, dev, *cli_shapes["A"]["warp_tiled"], cli_launches["A"]["warp_tiled"])
    log(f"[k4] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    k5 = phase_k5(torch, dev, cli_shapes["C"]["conv3x3_lane"], cli_launches["C"]["conv3x3_lane"])
    log(f"[k5] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    phase_unet_forms(torch, dev)
    log(f"[unet-forms] {time.perf_counter() - t:.2f} s")

    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log("[variants] " + json.dumps({"variants": variants, "resume": resume,
                                    "run_launches": {k: cli_launches[k] for k in "DE"}}))
    log(json.dumps({"kernels": [k1, k2, k3, k4, k5]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
