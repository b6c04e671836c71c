#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (v2e_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line with its seconds:
  0. the card's name and power limit (nvidia-smi);
  1. build of the CUDA kernels with nvcc (sm_90a) into v2e_tpu_torch/_build,
     and of the native host library with g++ (`[native]`; fails if it does
     not build or load);
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
       I. run A's flags and --dvs_aedat4: the AEDAT-4 file read back with
          the port's readers equals the run's AEDAT-2 stream event for
          event (t in us, x, y, p) and its seek table's element counts sum
          to the run's events;
     each with the kernels' launch counters (v2e_tpu_torch.tracing) read
     before and after, runs A and I with the native host library's call
     counters read the same way (events, AEDAT-2 words and the DVS
     video's histogram through the library, no numpy fallback),
     and its outputs checked (AEDAT-2 payload of 8 B per event, event times
     inside the input's span, non-empty videos in run A); then run A once
     more under torch.profiler for its device time (not counted); then
     `[native]`: the library's six functions against their numpy versions,
     bit for bit, on run A's data (materialize_sparse on its recorded
     compacted chunks, pack_aedat2 and hist2d_accumulate on its events,
     area_count_scan at --dvs_exposure area_count 500 64,
     materialize_frame and count_frame_events on its busiest frame's
     346x260 count map), each timed on the host beside the host's CPU
     model; `[h5]`: where h5py imports, --dvs_h5 --ddd_output and a
     --slomo_use_saved record and replay through the CLI, else one line
     saying they were not run; and runs
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
     slow kernel is printed, not failed); then K6 (bilinear x2 upsample)
     at the UNets' five up levels for a chunk of each conversion cell
     (bf16) and, with its VJP, a training step (float32): equal to its
     plain versions bit for bit, its ulps from F.interpolate and the
     library's backward, and its device time beside the plain version's,
     the library's and the bound; then K8 (the UNets' conv epilogue:
     bias, LeakyReLU and the up levels' skip, NHWC) at the calls the fused
     chunks made (their counted launches, 23 a UNet forward, reported a
     chunk) and at one chunk of each conversion cell's UNets (flow N = 8,
     refinement N = 80 or 96, bf16): equal to its plain version bit for
     bit, its device time beside the plain version's, ATen's `add_` +
     `leaky_relu` (+ `torch.cat`) and the bound, and the layout and glue
     kernels left on cell 1's chunk under the profiler;
 10. the interp UNet's forward at the fused chunk's shape (80 x 12 channels
     of 256x320, bf16, base 32) in the conv forms dense, packedz, fold45,
     packedfold45 and fold: time and max abs difference from dense, and
     the device kernels of one dense and one fold45 forward, printed only;
 11. the CLI's synthetic entry point (--synthetic_input) at 346x260, after
     the video runs:
       F. scripts.moving_dot at the defaults with --skip_video_output: the
          device path (each chunk of 64 frames rendered on the card), one K1
          launch per chunk and nothing else, event times inside the
          stimulus' span;
       G. run F with the videos on: the host path (next_frame), equal to
          run F event for event, or, where the card's renderer differs from
          the host painter, those pixels printed and the totals within
          0.1 %; a non-empty video_orig.avi;
       H. scripts.particles --dvs_params noisy with --skip_video_output: the
          device path with the host walker, one K2 launch per chunk;
     each with its realtime factor, and the device time of runs F and H
     over a quarter of their stimulus; the bytes copied host to device for
     one chunk of runs F and H are read first, right after the build
     (`[h2d]`, torch.profiler, between two marker copies that show the
     trace recorded the whole chunk), and must stay under one frame;
 12. the six generators' first 640 frames at 346x260, the card's renderer
     against the port's host painter (one level at most, at no more than
     1e-4 of the pixels; particles within 1e-5 relative of the host
     painter on the same float32 centers, its next_frame differences
     printed) and against the same renderer on the CPU (particles within 1e-5
     relative), with each renderer's time per 64-frame chunk;
 13. estimate_thresholds on 640 moving-dot frames rendered on the card (no
     mismatch, noise or lowpass; targets from a run at 0.25/0.25): the same
     thresholds and probes on the card as on the CPU;
 14. K1 again at run F's shape: 64 frames of 260x346 at dt = 100 us, R =
     0.5 ms (the filter acts on every pixel that fires);
 15. `[k3-vjp]`: K3 against warp_plain (within 1e-5) and its VJP kernel
     against warp_plain_vjp at the training shape (8 planes of 256x320,
     smooth flows to +-48 px so that taps fall outside, and to +-480 px):
     flow gradients within 1e-6, the image gradient within 1e-5 of its
     largest value; its time with and without the image gradient,
     the plain version's, grid_sample's backward to the grid and the bound;
 16. `[train]`: SuperSloMo training, the port's train_slomo on the card at
     the full width and its defaults (base 32, crop 256x320, batch 8, gap
     2), 30 steps on three clips of make_training_videos at 288x352: K3 and
     its VJP launched 6 times each per step and no plain warp; the step
     alone (median of 10 after 3 warm-up steps), samples/s, peak memory,
     the TF32 setting, the device kernels of one profiled step by group
     (`[train-profile]`); a static scene whose loss 8 steps lower; the
     exported npz loaded into SuperSloMo and interpolating on the card;
     `[train-small]`: one step at base 8 and 64x96 card against CPU with
     cuDNN's TF32 off (loss terms 1e-5 relative, gradients 1e-4 of their
     largest, Adam on the same gradients 1e-7); `[eval]`: eval_slomo_ckpt's
     held-out PSNR of the golden fixture on the card equal to the CPU's
     within 0.05 dB and more than 1 dB over the frame average; `[batch]`:
     batch_convert on a two-video tree on the card (--dvs_h5 "", AEDAT-2
     and text sinks): exit 0, the tree mirrored, 8 B per event; `[ddd]`:
     the DDD tools where h5py imports, else a line saying so;
 17. several devices, on the one card (v2e_tpu_torch/parallel/):
     `[cli-parallel]` (after run H) run B's flags with a fixed seed through
       `python -m v2e_tpu_torch --devices 2 --parallel_mode segment`: the
       clamp warning, and the events of the same run in process;
     `[pixel]` EventEmulator with a mesh of S strips on cuda:0 against one
       device over 4 chunks of run B's 96 frames at 346x260 (the CLI's
       emulator defaults, seed 42): R = 0.5 ms through K1 on strips (one
       launch per strip and chunk) at S = 2 and 3 (260 rows padded to
       261), the noisy preset through K2 per strip at S = 2 and 3, and R =
       0.5 ms at 1280x720 with S = 4; events equal bit for bit, the strips'
       kernel's and K2's launches counted, any plain scan refused; ms per
       chunk beside one device's;
     `[k1-strips]` K1 on 3 strips at run B's shape against its plain
       version and K1, bit for bit; the split chunk timed beside K1 and its
       bound, the kernels' device time at 3 strips and at 1, and the per-
       frame cost of the exchange's hop through system memory;
     `[segment]` EventEmulator in 4 time segments (warm-up 8) over 3
       chunks of run A's 768 frames: K1 once per segment, each pixel's
       signed count within one crossing per seam of the continuous run's;
     `[ddp]` train_slomo's step at full width on 2 ranks of cuda:0 over
       gloo (DDP, global batch 8) against one process on the whole batch:
       loss and weights within 1e-3 of the largest, K3 and its VJP 6 times
       per rank, no plain warp; the step's ms and the all-reduce's share;
     `[dryrun]` `python -m v2e_tpu_torch.parallel.dryrun 2` exits 0.

Then a JSON line of the variant phases' numbers, one of the synthetic
phases' numbers, one of the native host library's (host ms, CPU model),
one of the training phase's numbers, one of the parallel phases' numbers
(`[parallel]`), one JSON line with every kernel's
numbers (K1's launches in run F and K2's in run H beside those of the
fused chunk and run B; K3's launches and error at the training shape;
K3's VJP as its own entry, which K3's names under "vjp", with the
training run's launches; K1 on strips as its own entry, with the
launches of `[pixel]`'s S = 3 run at 346x260), the nvidia-smi line again,
and last {"ok": true, "device": {...}}.  Exits non-zero, with no result,
when CUDA is unavailable, a kernel does not build or disagrees, or any
check fails.
"""
from __future__ import annotations

import copy
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import ExitStack

from portbench.yardstick import PEAK_BF16_FLOP_S, PEAK_BYTES_S, PEAK_F32_OPS_S, bound_s

TIME_LIMIT_S = 1100  # a hang becomes a traceback and a non-zero exit

H, W = 260, 346
U, B = 10, 16
SRC_FPS = 30.0
RUN_B_U = 12  # run B's fixed upsampling (--timestamp_resolution 0.003 at 30 fps)
N_MEAS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


# each kernel wrapper's launch counter (v2e_tpu_torch/tracing.py)
LAUNCH = {"refractory_scan": "launch.k1", "refractory_scan_strips": "launch.k1_strips",
          "scan": "launch.k2", "bilinear_warp": "launch.k3", "bilinear_warp_vjp": "launch.k3_vjp",
          "warp_tiled": "launch.k4", "conv3x3_lane": "launch.k5", "upsample2x": "launch.k6",
          "upsample2x_vjp": "launch.k6_vjp", "conv_bias_leaky": "launch.k8"}


def launch_counts(names) -> dict:
    """{wrapper name: the launches it has made in this process}."""
    from v2e_tpu_torch import tracing

    now = tracing.counters()
    return {k: now.get(LAUNCH[k], 0) for k in names}


def launches_since(before: dict) -> dict:
    """The launches made since `launch_counts` gave `before`."""
    now = launch_counts(before)
    return {k: now[k] - before[k] for k in before}


def host_calls_since(before: dict) -> dict:
    """{(function, "native" | "numpy"): calls} of the host library since
    tracing's counters read `before`."""
    from v2e_tpu_torch import tracing

    out = {}
    for name, n in tracing.counters().items():
        path, _, fn = name.partition(".")
        if path in ("native", "numpy") and n > before.get(name, 0):
            out[(fn, path)] = n - before.get(name, 0)
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cpu_model() -> str:
    """The host CPU's model name as lscpu (else /proc/cpuinfo) gives it,
    printed beside host timings; where the machine hides it ("unknown" in
    a sandbox), with the vendor, family, model number, clock and CPU count
    that /proc/cpuinfo still shows."""
    texts = []
    try:
        texts.append(subprocess.run(["lscpu"], capture_output=True, text=True,
                                    check=True).stdout)
    except (OSError, subprocess.CalledProcessError):
        pass
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            text = f.read()
        texts.append(text)
        for line in text.split("\n\n")[0].splitlines():
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    except OSError:
        pass
    name = "unknown"
    for text in texts:
        for line in text.splitlines():
            key, _, value = line.partition(":")
            if key.strip().lower() == "model name" and value.strip():
                name = value.strip()
                break
        if name != "unknown":
            return name
    detail = ", ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "cpu MHz")
                       if k in info)
    return f"{name} ({detail}, {os.cpu_count()} CPUs)" if detail else name


def bound(nbytes: float, nops: float, peak_ops: float = PEAK_F32_OPS_S):
    """(ms, what sets it): the harness's bound (portbench/yardstick.py) in
    ms, and "bytes" or "operations", the peak that sets it."""
    what = "bytes" if nbytes / PEAK_BYTES_S >= nops / peak_ops else "operations"
    return bound_s(nbytes, nops, peak_ops) * 1e3, what


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
        refractory_grid, refractory_scan, refractory_scan_plain,
    )

    dev = torch.device("cuda")
    args = refr_inputs(torch, dev, F, dt, R)
    mem = args[6]
    before = launch_counts(["refractory_scan"])
    got = refractory_scan(*args)
    per_call = launches_since(before)["refractory_scan"]
    grid = refractory_grid(H * W, args[0].device)
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

    got = bilinear_warp(img, u, v)
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
    ms = time_ms(torch, lambda: bilinear_warp(img, u, v), reps=20)
    plain_ms = time_ms(torch, lambda: warp_plain(img, u, v), reps=5)
    library_ms = time_ms(torch, lib, reps=20)
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


TRAIN_N, TRAIN_H, TRAIN_W = 8, 256, 320  # train_slomo's defaults: batch 8, crop 256x320
TRAIN_STEPS = 30
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "tests", "fixtures", "slomo_golden.npz")


def phase_k3_vjp(torch, dev):
    """K3 and its VJP at the training shape (the batch's 8 planes of
    256x320), smooth flows to +-48 px so that taps fall outside and to
    +-480 px (the training flows from random weights are unbounded):
    K3 against warp_plain within 1e-5 (the [k3] check, at training's
    shape and flows beyond its +-32 px), the VJP against warp_plain_vjp:
    flow gradients within 1e-6, the image gradient (atomic sums) within
    1e-5 of its largest value; grid_sample's backward to the grid timed
    beside it.  Returns the VJP's entry and K3's error at this shape."""
    import torch.nn.functional as Fn

    from v2e_tpu_torch.ops.kernels.warp import (
        bilinear_warp,
        bilinear_warp_vjp,
        warp_plain,
        warp_plain_vjp,
    )

    N, h, w = TRAIN_N, TRAIN_H, TRAIN_W
    g = torch.Generator(device=dev).manual_seed(12)
    img = torch.rand((N, h, w), generator=g, device=dev) - 0.428
    coarse = torch.rand((N, 2, 9, 11), generator=g, device=dev) * 96.0 - 48.0
    flow = Fn.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True).contiguous()
    u, v = flow[:, 0], flow[:, 1]
    gout = torch.randn((N, h, w), generator=g, device=dev)
    xs = torch.arange(w, device=dev)[None, None, :] + u - 0.5
    outside = float(((xs < 0) | (xs > w - 1)).float().mean())

    k3_err = {}
    for reach, (uu, vv) in ((48, (u, v)), (480, (u * 10.0, v * 10.0))):
        k3_err[reach] = float((bilinear_warp(img, uu, vv) - warp_plain(img, uu, vv)).abs().max())
    if not max(k3_err.values()) <= 1e-5:
        raise AssertionError(f"K3 at the training shape differs from the plain version: "
                             f"{k3_err} > 1e-5")
    far_f, _ = bilinear_warp_vjp(img, u * 10.0, v * 10.0, gout)
    far_err = float((far_f - warp_plain_vjp(img, u * 10.0, v * 10.0, gout)[0]).abs().max())
    gf, gi = bilinear_warp_vjp(img, u, v, gout, True)
    wf, wi = warp_plain_vjp(img, u, v, gout, True)
    gf_only, none = bilinear_warp_vjp(img, u, v, gout)
    torch.cuda.synchronize()
    err = float((gf - wf).abs().max())
    err_only = float((gf_only - wf).abs().max())
    err_img = float((gi - wi).abs().max()) / float(wi.abs().max())
    if not (max(err, err_only, far_err) <= 1e-6 and err_img <= 1e-5 and none is None):
        raise AssertionError(f"K3's VJP differs from the plain version: flow {err}, "
                             f"{err_only}, {far_err} (+-480 px) > 1e-6 or image {err_img} "
                             f"> 1e-5 of its largest")

    gx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    gy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    grid = torch.stack([2.0 * ((gx + u) / w - 0.5), 2.0 * ((gy + v) / h - 0.5)],
                       dim=-1).requires_grad_()
    out = Fn.grid_sample(img[:, None], grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)

    def lib():
        return torch.autograd.grad(out, grid, gout[:, None], retain_graph=True)

    ms = time_ms(torch, lambda: bilinear_warp_vjp(img, u, v, gout), reps=20)
    device_ms = time_device_ms(torch, lambda: bilinear_warp_vjp(img, u, v, gout), reps=20)
    ms_img = time_device_ms(torch, lambda: bilinear_warp_vjp(img, u, v, gout, True), reps=20)
    plain_ms = time_ms(torch, lambda: warp_plain_vjp(img, u, v, gout), reps=5)
    library_ms = time_ms(torch, lib, reps=20)
    library_device_ms = time_device_ms(torch, lib, reps=20)
    k3_ms = time_device_ms(torch, lambda: bilinear_warp(img, u, v), reps=20)
    # image, u, v, gout read, grad_u, grad_v written: 24 B per pixel; ~45 f32 ops
    b_ms, b_by = bound(N * h * w * 24, N * h * w * 45)
    log(f"[k3-vjp] K3 N={N} {h}x{w}: max abs err {k3_err[48]:.3g} with flows to +-48 px "
        f"({outside:.1%} of x taps outside), {k3_err[480]:.3g} to +-480 px")
    log(f"[k3-vjp] K3's VJP N={N} {h}x{w}, flows to +-48 px: max abs err {err:.3g} (flow "
        f"only {err_only:.3g}; {far_err:.3g} to +-480 px), image gradient "
        f"{err_img:.3g} of its largest; kernel {ms:.4f} ms, device {device_ms:.4f} ms "
        f"({ms_img:.4f} ms with the image gradient), plain {plain_ms:.3f} ms, grid_sample "
        f"backward {library_ms:.4f} ms (device {library_device_ms:.4f} ms), bound "
        f"{b_ms:.4f} ms ({b_by}); K3 forward at this shape: device {k3_ms:.4f} ms")
    return {
        "name": "bilinear_warp_vjp", "route": "cuda",
        "source": "v2e_tpu_torch/csrc/warp.cu",
        "replaces": "v2e_tpu/models/backwarp.py:16",
        "max_abs_err": max(err, err_only, far_err), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "device_ms": device_ms, "device_ms_with_image_grad": ms_img,
        "library_device_ms": library_device_ms, "image_grad_rel_err": err_img,
        "k3_device_ms_at_train_shape": k3_ms,
    }, max(k3_err.values())


KERNEL_GROUPS = (  # device kernel names of a training step, by what they do
    ("warps (K3, VJP)", ("warp_kernel", "warp_bwd_kernel")),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("cuDNN layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convolutions", ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad", "fprop",
                      "implicit", "winograd", "cutlass")),
    ("bilinear upsample", ("upsample_bilinear",)),
)


def group_kernels(rows):
    """Device ms of profiled kernels (rows of profile_device) by group;
    what no group names is elementwise and the rest."""
    out = {name: 0.0 for name, _ in KERNEL_GROUPS}
    out["elementwise and other"] = 0.0
    for ms, _, key in rows:
        low = key.lower()
        for name, pats in KERNEL_GROUPS:
            if any(p in low for p in pats):
                out[name] += ms
                break
        else:
            out["elementwise and other"] += ms
    return out


def phase_train(torch, np, dev, tmp, launches, k6_calls):
    """The port's train_slomo on the card at SuperSloMo's full width and its
    defaults (base 32, crop 256x320, batch 8, gap 2), TRAIN_STEPS steps on
    clips of make_training_videos rendered at 288x352: K3 and its VJP
    launched 6 times each per step and no plain warp; then the training
    step alone (median of 10 after 3 warm-up steps, peak memory), one
    profiled step by kernel group, a static scene whose loss 8 steps
    lower, and the exported npz loaded into SuperSloMo for one
    interpolation.  K6 and its VJP launch 10 times each per step (5 up
    levels of 2 UNets).  `launches` gets the counts of the tool's run,
    `k6_calls` K6's and its VJP's calls by shape there."""
    import importlib

    import v2e_tpu_torch.ops.kernels.warp as warp_mod
    from v2e_tpu_torch.dataset_tools import make_training_videos, train_slomo
    from v2e_tpu_torch.dataset_tools.batch_convert import find_videos
    from v2e_tpu_torch.models import train

    # the module: v2e_tpu_torch.models exports the function `backwarp` under its name
    backwarp_mod = importlib.import_module("v2e_tpu_torch.models.backwarp")
    vids = os.path.join(tmp, "train-videos")
    t = time.perf_counter()
    make_training_videos.main(["-o", vids, "--n_videos", "3", "--frames", "24",
                               "--size", "288", "352", "--seed", "0"])
    log(f"[train] 3 clips of 24 frames at 288x352 rendered in {time.perf_counter() - t:.2f} s")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    plain = Counter()

    def counted(name, fn):
        def wrapper(*a, **k):
            plain[name] += 1
            return fn(*a, **k)
        return wrapper

    spent = Counter()  # the tool's seconds of sampling and of checkpoints

    def timed(name, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t
        return wrapper

    saved = (warp_mod.warp_plain, warp_mod.warp_plain_vjp, backwarp_mod.warp_plain,
             train_slomo.TripletSampler.sample_batch, train_slomo.save_checkpoint)
    warp_mod.warp_plain = counted("warp_plain", saved[0])
    warp_mod.warp_plain_vjp = counted("warp_plain_vjp", saved[1])
    backwarp_mod.warp_plain = counted("warp_plain", saved[2])
    train_slomo.TripletSampler.sample_batch = timed("sample", saved[3])
    train_slomo.save_checkpoint = timed("checkpoint", saved[4])
    out = os.path.join(tmp, "train-run")
    argv = ["-i", vids, "-o", out, "--steps", str(TRAIN_STEPS), "--batch_size", str(TRAIN_N),
            "--crop", str(TRAIN_H), str(TRAIN_W), "--base", "32", "--log_every", "10",
            "--checkpoint_every", str(TRAIN_STEPS)]
    try:
        before = launch_counts(["bilinear_warp", "bilinear_warp_vjp", "upsample2x",
                                "upsample2x_vjp"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        with k6_recorder() as up, k6_recorder("upsample2x_vjp") as up_vjp:
            run = train_slomo.run(argv, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches.update(launches_since(before))
    finally:
        (warp_mod.warp_plain, warp_mod.warp_plain_vjp, backwarp_mod.warp_plain,
         train_slomo.TripletSampler.sample_batch, train_slomo.save_checkpoint) = saved
    k6_calls.update(upsample2x=Counter(up.calls), upsample2x_vjp=Counter(up_vjp.calls))
    per_step = (launches["bilinear_warp"] / TRAIN_STEPS, launches["bilinear_warp_vjp"] / TRAIN_STEPS)
    if per_step != (6, 6) or plain:
        raise AssertionError(f"train_slomo: K3 and VJP launches per step {per_step} != (6, 6), "
                             f"plain warp calls {dict(plain)}")
    k6_step = (launches["upsample2x"] / TRAIN_STEPS, launches["upsample2x_vjp"] / TRAIN_STEPS)
    if k6_step != (10, 10):
        raise AssertionError(f"train_slomo: K6 and VJP launches per step {k6_step} != (10, 10)")
    if not all(np.isfinite(v) for v in run.metrics.values()):
        raise AssertionError(f"train_slomo: metrics not finite {run.metrics}")
    log(f"[train] train_slomo base 32, crop {TRAIN_H}x{TRAIN_W}, batch {TRAIN_N}: "
        f"{TRAIN_STEPS} steps in {wall:.2f} s ({run.samples / wall:.1f} samples/s; the loop "
        f"{run.wall_s:.2f} s, of it sampling {spent['sample']:.2f} s and the checkpoint "
        f"{spent['checkpoint']:.2f} s); K3 {per_step[0]:g} and VJP {per_step[1]:g} "
        f"launches per step, no plain warp; K6 {k6_step[0]:g} and VJP {k6_step[1]:g}; last loss {run.metrics['loss']:.4f} "
        f"(l_r {run.metrics['l_r']:.4f}, l_w {run.metrics['l_w']:.4f}, "
        f"l_s {run.metrics['l_s']:.4f}); cuDNN TF32 {tf32[0]}, matmul TF32 {tf32[1]}")

    state = train.create_train_state(seed=0, base=32, device="cuda")
    sampler = train_slomo.TripletSampler(find_videos(vids, {".avi"}), (TRAIN_H, TRAIN_W), 2,
                                         seed=1)
    batch = train.batch_to(sampler.sample_batch(TRAIN_N), dev)
    step = train.make_train_step()
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    step_ms = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] step (median of 10 after 3 warm-up): {step_ms:.2f} ms "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
        f"{TRAIN_N / step_ms * 1e3:.1f} samples/s, peak memory {peak / 2**30:.2f} GiB")
    rows = profile_device(torch, "train-profile", lambda: step(state, batch), step_ms,
                          "one training step", top=15)
    groups = group_kernels(rows or [])
    busy = sum(groups.values())
    if busy:
        log("[train-profile] by group: " + ", ".join(
            f"{k} {v:.2f} ms ({v / busy:.1%})" for k, v in groups.items()))

    static = train.create_train_state(seed=2, base=32, device="cuda")
    img = batch["I0"]
    scene = {"I0": img, "I1": img, "It": img, "t": torch.full((TRAIN_N,), 0.5, device=dev)}
    losses = [float(step(static, scene)[1]["loss"]) for _ in range(8)]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"static scene at base 32: loss did not fall in 8 steps {losses}")
    log(f"[train] static scene base 32: loss {losses[0]:.4f} -> {losses[-1]:.4f} in 8 steps")

    from v2e_tpu_torch.models.slomo import SuperSloMo

    slomo = SuperSloMo(run.npz, upsampling_factor=4, batch_size=2, device="cuda")
    frames = sampler._load(find_videos(vids, {".avi"})[0])[:3].astype(np.float32)
    interp, U = slomo.interpolate_batch(frames, frames.shape[1], frames.shape[2])
    if tuple(interp.shape) != (2 * U, 288, 352) or not bool(torch.isfinite(interp).all()):
        raise AssertionError(f"trained npz: interpolation {tuple(interp.shape)} not finite")
    log(f"[train] {os.path.basename(run.npz)} (base {slomo.flow_net.base}) interpolated "
        f"3 frames at 288x352 on the card: {tuple(interp.shape)}, finite")
    return {"steps": TRAIN_STEPS, "wall_s": wall, "samples_per_s_tool": run.samples / wall,
            "loop_s": run.wall_s, "sample_s": spent["sample"], "checkpoint_s": spent["checkpoint"],
            "step_ms": step_ms, "samples_per_s": TRAIN_N / step_ms * 1e3,
            "peak_bytes": peak, "tf32_cudnn": tf32[0], "groups_ms": groups,
            "static_losses": [losses[0], losses[-1]]}


def train_small_step(torch, np, params, batch, device):
    """One loss and backward at base 8 on `device`: (state, metrics)."""
    from v2e_tpu_torch.models import train

    state = train.create_train_state(params=params, device=device)
    b = train.batch_to(batch, torch.device(device))
    loss, metrics = train.slomo_loss(state.flow_net, state.interp_net,
                                     b["I0"], b["I1"], b["It"], b["t"])
    loss.backward()
    return state, {k: float(v.detach()) for k, v in metrics.items()}


def phase_train_small(torch, np):
    """One training step at base 8 and 64x96 on the card and on the CPU from
    the same weights and batch, cuDNN's TF32 off.  With cuDNN off (PyTorch's
    own CUDA convolutions) at tests/test_torch_train.py's tolerances: loss
    terms within 1e-5 relative, every gradient within 1e-4 of its tensor's
    largest, and Adam fed the CPU's gradients on both within 1e-7; this
    holds the port's losses, K3, its VJP and Adam.  With cuDNN on (the
    path train_slomo runs) the gradients within 1e-3 of their largest:
    cuDNN's float32 weight gradients of the 5x5 layers are 4.4e-4 of their
    largest off a float64 reference, the CPU's 3.7e-6 (H100 80GB HBM3,
    700 W, torch 2.11.0+cu128)."""
    from v2e_tpu_torch.models.convert_ckpt import init_random_slomo_params, to_jax_params

    params = init_random_slomo_params(11, base=8)
    rng = np.random.default_rng(8)
    batch = {k: rng.normal(0, 0.3, (2, 1, 64, 96)).astype(np.float32) for k in ("I0", "I1", "It")}
    batch["t"] = rng.uniform(0.1, 0.9, (2,)).astype(np.float32)
    sc, mc = train_small_step(torch, np, params, batch, "cpu")
    pc = [(f"{i}.{n}", p) for i, net in enumerate((sc.flow_net, sc.interp_net))
          for n, p in net.named_parameters()]
    old = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled
    torch.backends.cudnn.allow_tf32 = False
    try:
        for cudnn, grad_tol in ((False, 1e-4), (True, 1e-3)):
            torch.backends.cudnn.enabled = cudnn
            sg, mg = train_small_step(torch, np, params, batch, "cuda")
            loss_err = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc)
            pg = [p for net in (sg.flow_net, sg.interp_net) for p in net.parameters()]
            errs = sorted(((float((a.grad.cpu() - b.grad).abs().max()) / float(b.grad.abs().max()),
                            name) for a, (name, b) in zip(pg, pc)), reverse=True)
            if not (loss_err <= 1e-5 and errs[0][0] <= grad_tol):
                raise AssertionError(f"train-small (cuDNN {cudnn}): card vs CPU loss {loss_err:.3g} "
                                     f"> 1e-5 or gradients {errs[:3]} > {grad_tol}")
            line = (f"[train-small] base 8, 2x64x96, TF32 off, cuDNN {'on' if cudnn else 'off'}: "
                    f"card vs CPU loss terms within {loss_err:.3g} relative, gradients within "
                    f"{errs[0][0]:.3g} of their largest (worst {errs[0][1]}, then "
                    f"{errs[1][1]} {errs[1][0]:.3g})")
            if not cudnn:
                for a, (_, b) in zip(pg, pc):
                    a.grad = b.grad.to(a.device)
                sg.optimizer.step()
                sc.optimizer.step()  # its gradients stay for the cuDNN case
                adam_err = max(float(np.abs(x[k][n] - y[k][n]).max())
                               for x, y in zip(to_jax_params(sg.flow_net, sg.interp_net),
                                               to_jax_params(sc.flow_net, sc.interp_net))
                               for k in x for n in ("w", "b"))
                if not adam_err <= 1e-7:
                    raise AssertionError(f"train-small: Adam card vs CPU {adam_err:.3g} > 1e-7")
                line += f", Adam on the same gradients within {adam_err:.3g}"
            log(line)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled = old


def phase_eval(torch):
    """eval_slomo_ckpt on the golden fixture on the card and on the CPU."""
    from v2e_tpu_torch.dataset_tools.eval_slomo_ckpt import evaluate

    card = evaluate(GOLDEN, device="cuda")
    cpu = evaluate(GOLDEN, device="cpu")
    if abs(card["model"] - cpu["model"]) > 0.05 or not card["model"] > card["average"] + 1.0:
        raise AssertionError(f"eval: card {card} vs CPU {cpu}")
    log(f"[eval] golden fixture (base {card['base']}) at 128x160, U=4: PSNR card "
        f"{card['model']:.4f} dB, CPU {cpu['model']:.4f} dB, frame average "
        f"{card['average']:.4f} dB (margin {card['model'] - card['average']:+.2f} dB)")
    return card


def phase_batch(torch, np, tmp):
    """batch_convert on a two-video tree on the card (golden SuperSloMo,
    U=12, --dvs_h5 "" and an AEDAT-2 sink): exit 0, the tree mirrored, 8 B
    of AEDAT-2 payload per event of the run's text file."""
    import cv2

    from v2e_tpu_torch.dataset_tools import batch_convert

    src = os.path.join(tmp, "batch-in")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for sub, name in (("classA", "v1"), ("classB", "v2")):
        os.makedirs(os.path.join(src, sub))
        vw = cv2.VideoWriter(os.path.join(src, sub, f"{name}.avi"),
                             cv2.VideoWriter_fourcc(*"XVID"), 30, (W, H), False)
        phase = rng.uniform(0, 6)
        for i in range(8):
            f = 100 + 60 * np.sin((xx - 4 * i) / 11.0 + phase) * np.cos(yy / 13.0)
            vw.write(np.clip(f, 0, 255).astype(np.uint8))
        vw.release()
    dst = os.path.join(tmp, "batch-out")
    t = time.perf_counter()
    rc = batch_convert.main(["-i", src, "-o", dst, "--dvs_h5", "", "--dvs_aedat2", "ev.aedat",
                             "--dvs_text", "ev.txt", "--timestamp_resolution", "0.003",
                             "--auto_timestamp_resolution", "false", "--slomo_model", GOLDEN],
                            device="cuda")
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"batch_convert exited {rc}")
    counts = []
    for sub, name in (("classA", "v1"), ("classB", "v2")):
        folder = os.path.join(dst, sub, name)
        n = sum(1 for ln in open(os.path.join(folder, "ev.txt")) if not ln.startswith("#"))
        payload = read_aedat2(os.path.join(folder, "ev.aedat"))
        if n == 0 or payload != 8 * n:
            raise AssertionError(f"batch_convert {sub}/{name}: {payload} B of AEDAT-2 for {n} events")
        counts.append(n)
    log(f"[batch] batch_convert on the card, 2 videos of 8 frames at {W}x{H} (U=12): exit 0, "
        f"tree mirrored, {counts} events at 8 B each, {wall:.2f} s")


def phase_ddd(np, tmp):
    """The DDD tools where h5py imports: ddd_v2e on the card on a written
    three-frame recording; else one line saying they were not run."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        log("[ddd] not run: h5py is absent on this machine (the CPU tests hold the DDD tools "
            "against v2e_tpu's)")
        return
    import struct

    from v2e_tpu_torch.dataset_tools import ddd_v2e
    from v2e_tpu_torch.io.ddd import DDDH5Writer

    def header(etype, esize, n):
        return struct.pack("hhiiiiii", etype, 0, esize, 0, 0, n, n, n)

    path = os.path.join(tmp, "rec.hdf5")
    w = DDDH5Writer(path)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in range(3):
        img = (100 + 60 * np.sin((xx - 5 * i) / 9.0)).astype(np.uint16) * 256
        head = np.zeros(9, np.uint32)
        head[2] = 1_000_000 + 40_000 * i
        w.append_packet(header(2, 36 + img.nbytes, 1), head.tobytes() + img.tobytes())
    w.close()
    out = os.path.join(tmp, "ddd-out")
    rc = ddd_v2e.main(["-i", path, "-o", out, "--slomo_model", GOLDEN, "--numpy_output",
                       "--timestamp_resolution", "0.008"], device="cuda")
    n = np.load(os.path.join(out, "events-v2e.npy")).shape[0] if rc == 0 else 0
    if rc != 0 or n == 0:
        raise AssertionError(f"ddd_v2e exited {rc} with {n} synthetic events")
    log(f"[ddd] ddd_v2e on the card: {n} synthetic events from 3 APS frames")


def k2_inputs(torch, dev, F, h, w, noisy=True, seed=4, dt=1.0 / (SRC_FPS * RUN_B_U)):
    """K2's inputs at F x h x w: the moving-bar log frames of refr_inputs,
    and with `noisy` the noisy preset's leak and shot noise drawn as
    emulate_chunk_apply draws them at frame interval `dt` (run B's by
    default).  Returns the scan's arguments."""
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


def check_k2(torch, dev, F, h, w, noisy, tag, plain_reps=2, **inputs):
    """K2 against its plain version on k2_inputs (`inputs` goes to it):
    counts equal, base within 1e-6, one launch per call; then both timed.
    Returns the numbers."""
    from v2e_tpu_torch.ops.kernels.emulator_scan import (
        GROUP, RING, _device_plan, scan, scan_plain, stream_layout,
    )

    args = k2_inputs(torch, dev, F, h, w, noisy, **inputs)
    before = launch_counts(["scan"])
    got = scan(*args)
    per_call = launches_since(before)["scan"]
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
    plan = _device_plan(h * w, F, args[0].device.index, *stream_layout(*args[:3]))[0]
    ms = time_ms(torch, lambda: scan(*args), reps=20)
    dev_ms = time_device_ms(torch, lambda: scan(*args), reps=20)
    plain_ms = time_ms(torch, lambda: scan_plain(*args), reps=plain_reps)
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


def aedat2_events(np, path):
    """A 346x260 AEDAT-2 file's events [N,4] int64 (t us, x, y, p 0/1)."""
    with open(path, "rb") as f:
        data = f.read()
    header = 0
    while data[header: header + 1] == b"#":
        header = data.index(b"\r\n", header) + 2
    words = np.frombuffer(data[header:], dtype=">i4").astype(np.int64).reshape(-1, 2)
    a = words[:, 0]
    x = W - 1 - ((a >> 12) & 0x3FF)
    y = H - 1 - ((a >> 22) & 0x1FF)
    return np.stack([words[:, 1], x, y, (a >> 11) & 1], axis=1)


def check_run_i(np, out, n_events):
    """Run I's AEDAT-4 file read back: the AEDAT-2 stream event for event
    (from the first event the AEDAT-2 sink kept), and the seek table's
    element counts summing to the total."""
    from v2e_tpu_torch.io.aedat4 import read_aedat4, read_aedat4_data_table

    ev4 = read_aedat4(os.path.join(out, "i.aedat4"))
    ev4 = np.stack([np.rint(ev4[:, 0] * 1e6), ev4[:, 1], ev4[:, 2], ev4[:, 3] > 0],
                   axis=1).astype(np.int64)
    ev2 = aedat2_events(np, os.path.join(out, "i.aedat"))
    dropped = len(ev4) - len(ev2)
    table = read_aedat4_data_table(os.path.join(out, "i.aedat4"))
    counted = sum(e["num_elements"] for e in table)
    if len(ev4) != n_events or counted != n_events or not 0 <= dropped <= 4:
        raise AssertionError(f"run I: AEDAT-4 {len(ev4)} events, table {counted}, "
                             f"AEDAT-2 {len(ev2)}, run {n_events}")
    if not np.array_equal(ev4[dropped:], ev2):
        bad = int((ev4[dropped:] != ev2).any(axis=1).sum())
        raise AssertionError(f"run I: {bad} AEDAT-4 events differ from the AEDAT-2 stream")
    return len(table)


class CallRecorder:
    """Wraps module.<name> to keep `keep(*args)` of each call, in `calls`."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.keep = module, name, keep
        self.inner, self.calls = getattr(module, name), []

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def __call__(self, *args):
        self.calls.append(self.keep(*args))
        return self.inner(*args)


def sparse_recorder(native):
    """native.materialize_sparse's calls, each argument copied before the
    call (the shuffle's generator too), for the [native] phase."""
    return CallRecorder(native, "materialize_sparse", lambda *a: copy.deepcopy(a))


def k6_recorder(name="upsample2x"):
    """K6's calls by (shape, dtype, channels_last): `upsample2x` (x) or
    `upsample2x_vjp` (gout, channels_last), as Upsample2xFn makes them."""
    from v2e_tpu_torch.ops.kernels import upsample

    if name == "upsample2x":
        def keep(x):
            return tuple(x.shape), x.dtype, upsample._channels_last(x)
    else:
        def keep(gout, channels_last=False):
            return tuple(gout.shape), gout.dtype, channels_last
    return CallRecorder(upsample, name, keep)


def k8_recorder():
    """K8's calls by (y's shape, dtype, with a skip), as the UNets'
    inference path makes them (models/unet.py imports the wrapper)."""
    from v2e_tpu_torch.models import unet

    return CallRecorder(unet, "conv_bias_leaky",
                        lambda y, bias, skip=None: (tuple(y.shape), y.dtype, skip is not None))


def shape_recorders() -> dict:
    """CallRecorders of the calls a conversion makes to K1 and K2 (their
    [F,H,W]) and to K4 (its [N,H,W] and max_base), where the emulator core
    and the backwarp call them."""
    import importlib

    from v2e_tpu_torch.emulator import core
    # the module: v2e_tpu_torch.models exports the function `backwarp` under its name
    backwarp = importlib.import_module("v2e_tpu_torch.models.backwarp")

    def frames(lp, *rest):
        return tuple(lp.shape)

    return {"refractory_scan": CallRecorder(core, "refractory_scan", frames),
            "scan": CallRecorder(core, "scan", frames),
            "warp_tiled": CallRecorder(backwarp, "warp_tiled",
                                       lambda img, u, v, mb: (tuple(img.shape), int(mb)))}


def phase_cli(torch, np, tmp, counters):
    """The port's CLI, runs A-E and I, then run A once more under
    torch.profiler (its launches not counted).  Returns {run: launches by
    kernel}, {run: the last [N,H,W] (and max_base) each kernel of the
    run was launched with; for K5 every ((N,H,W,Ci), Co) and for K6 every
    (shape, dtype, channels_last) with its launches; the run's SloMo
    chunks}, and run A's materialize_sparse calls (their arguments)."""
    from v2e_tpu_torch import cli, native, tracing
    from v2e_tpu_torch.ops.kernels.conv3 import shape_counts

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
    runs["I"] = ([{"a.aedat": "i.aedat", "a.txt": "i.txt"}.get(f, f) for f in runs["A"]]
                 + ["--dvs_aedat4", "i.aedat4"])
    # every run interpolates with SuperSloMo, so every run launches K6
    want = {"A": ("warp_tiled", "refractory_scan", "upsample2x"),
            "B": ("scan", "bilinear_warp", "upsample2x"),
            "C": ("scan", "bilinear_warp", "conv3x3_lane", "upsample2x"),
            "D": ("bilinear_warp", "upsample2x"), "E": ("bilinear_warp", "upsample2x")}
    want["I"] = want["A"]
    walls, events, rtfs = {}, {}, {}
    absent = {"A": ("bilinear_warp", "scan", "conv3x3_lane"),
              "B": ("warp_tiled", "refractory_scan", "conv3x3_lane"),
              "C": ("warp_tiled", "refractory_scan"),
              "D": ("warp_tiled", "refractory_scan", "scan", "conv3x3_lane"),
              "E": ("warp_tiled", "refractory_scan", "scan", "conv3x3_lane")}
    absent["I"] = absent["A"]
    launches, shapes, n_frames = {}, {}, {}
    recorder = sparse_recorder(native)
    for name, flags in runs.items():
        out = os.path.join(tmp, "out" + name)
        argv = ["-i", src, "--input_frame_rate", str(SRC_FPS), "-o", out] + flags
        before = launch_counts(counters)
        counted = tracing.counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = shape_recorders()
        with k6_recorder() as k6, ExitStack() as stack:
            for rec in recs.values():
                stack.enter_context(rec)
            if name == "A":
                stack.enter_context(recorder)
            stats = cli.run(argv, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[name] = launches_since(before)
        host_calls = host_calls_since(counted)
        last = {k: rec.calls[-1] if rec.calls else None for k, rec in recs.items()}
        shapes[name] = {k: last[k] for k in want[name] if k in ("scan", "warp_tiled")}
        shapes[name]["upsample2x"] = Counter(k6.calls)
        shapes[name]["chunks"] = stats.staged_chunks + stats.fused_chunks
        if name == "A":
            shapes[name]["refractory_scan"] = last["refractory_scan"]
            shapes[name]["U"] = stats.upsampling[-1]
        if name == "C":
            k5 = shape_counts(tracing.counters())
            k5_before = shape_counts(counted)
            shapes[name]["conv3x3_lane"] = {k: n - k5_before.get(k, 0) for k, n in k5.items()
                                            if n > k5_before.get(k, 0)}
        walls[name] = wall
        rtfs[name] = stats.realtime_factor
        events[name] = stats.num_events
        n_frames[name] = stats.n_frames
        if name in "AI":
            # the host half runs in the native library: events, AEDAT-2
            # words and the DVS video's histogram, with no numpy fallback
            used = {f for f, path in host_calls if path == "native"}
            fallback = {f for f, path in host_calls if path == "numpy"}
            if fallback or not {"materialize_sparse", "pack_aedat2",
                                "hist2d_accumulate"} <= used:
                raise AssertionError(f"run {name}: host calls {host_calls}")
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
        if name in "AI":
            ev = np.loadtxt(os.path.join(out, name.lower() + ".txt"), comments="#", usecols=0)
            if not (ev.min() >= -1e-6 and ev.max() <= span + 1e-6):
                raise AssertionError(f"run A: event times {ev.min()}-{ev.max()} outside 0-{span} s")
            for vid in ("dvs-video.avi", "video_orig.avi", "video_slomo.avi"):
                if os.path.getsize(os.path.join(out, vid)) <= 0:
                    raise AssertionError(f"run A: {vid} is empty")
        if name in "AI" and (min(stats.upsampling) <= 32 or stats.fused_chunks):
            raise AssertionError(f"run A: U {stats.upsampling}, {stats.fused_chunks} fused "
                                 "chunks; wants U > 32 and every chunk staged")
        if name == "E":
            check_run_e(np, out, stats)
        if name == "I":
            n_packets = check_run_i(np, out, stats.num_events)
        if name in "BCDE" and (set(stats.upsampling) != {RUN_B_U} or not stats.fused_chunks):
            raise AssertionError(f"run {name}: U {stats.upsampling}, {stats.fused_chunks} "
                                 "fused chunks; wants U = 12 and fused chunks")
        bad = [k for k in want[name] if not launches[name][k]]
        bad += [k for k in absent[name] if launches[name][k]]
        # K6 launches once per up level of each UNet forward, 5 a forward
        if launches[name]["upsample2x"] % 5:
            bad.append("upsample2x")
        if bad:
            raise AssertionError(f"run {name}: kernel launches {launches[name]}")
        path = f"{stats.staged_chunks} staged + {stats.fused_chunks} fused chunks"
        log(f"[cli] run {name}: U {stats.upsampling}, {path}; launches "
            + ", ".join(f"{k} {v}" for k, v in launches[name].items())
            + f" (K6 {launches[name]['upsample2x'] / shapes[name]['chunks']:g} a chunk)"
            + f"; {stats.n_frames} frames, {stats.num_events} events, AEDAT-2 "
            f"{payload} B ({dropped} leading events dropped by the '#' guard); "
            f"wall {wall:.2f} s, realtime factor "
            f"{stats.realtime_factor:.4f} (cli {stats.wall_s:.2f} s)"
            + (f"; host calls {sorted(host_calls.items())}" if name in "AI" else ""))
    log(f"[cli] run A with the native host library: wall {walls['A']:.2f} s, realtime "
        f"factor {rtfs['A']:.4f} (PR 10, numpy host path: 9.86-10.57 s); "
        f"host CPU {cpu_model()}")
    log(f"[cli] run I (run A + --dvs_aedat4): wall {walls['I']:.2f} s, realtime factor "
        f"{rtfs['I']:.4f}, {events['I']} events read back from i.aedat4 equal to "
        f"i.aedat, {n_packets} packets in its seek table")
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
    return launches, shapes, recorder.calls


AREA_COUNT = (500, 64)  # --dvs_exposure area_count 500 64: events, area size


def phase_native(np, calls):
    """The native host library's six functions against their numpy
    versions, bit for bit, on run A's data: materialize_sparse on each of
    its compacted chunks (the recorded calls, the shuffle's generator
    copied), pack_aedat2 and hist2d_accumulate on all its events,
    area_count_scan over them at --dvs_exposure area_count 500 64, and
    materialize_frame with count_frame_events on the 346x260 count map of
    its busiest frame.  Returns {function: (native ms, numpy ms)} on the
    card's host."""
    from v2e_tpu_torch import native
    from v2e_tpu_torch.emulator.events import (
        materialize_events_sparse_numpy,
        materialize_frame_numpy,
    )
    from v2e_tpu_torch.io.aedat2 import pack_aedat2_numpy
    from v2e_tpu_torch.render.renderer import accumulate_histogram_numpy, area_count_scan_numpy

    ms = {}

    def both(name, run_native, run_numpy):
        t = time.perf_counter()
        a = run_native()
        t_native = time.perf_counter() - t
        t = time.perf_counter()
        b = run_numpy()
        t_numpy = time.perf_counter() - t
        prev = ms.get(name, (0.0, 0.0))
        ms[name] = (prev[0] + t_native * 1e3, prev[1] + t_numpy * 1e3)
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        if not all(np.array_equal(x, y) for x, y in pairs):
            raise AssertionError(f"[native] {name}: the library differs from numpy")
        return a

    if not calls:
        raise AssertionError("[native] run A recorded no materialize_sparse call")
    parts = []
    for args in calls:
        *head, rng, label = args
        ev = both("materialize_sparse",
                  lambda: native.materialize_sparse(*head, copy.deepcopy(rng), label),
                  lambda: materialize_events_sparse_numpy(*head, copy.deepcopy(rng), label))
        parts.append(ev[0])
    events = np.concatenate(parts)
    shifts = (W, H, 12, 22, 11)  # 346x260: x<<12, y<<22, pol<<11
    both("pack_aedat2", lambda: native.pack_aedat2(events, *shifts, True),
         lambda: pack_aedat2_numpy(events, *shifts, True, True))

    def hist(fn):
        frame = np.zeros((H, W), np.float32)
        fn(frame, events, 2.0)
        return frame

    both("hist2d_accumulate", lambda: hist(native.hist2d_accumulate),
         lambda: hist(accumulate_histogram_numpy))
    count, dim = AREA_COUNT

    def scan(fn):
        counts = np.zeros((1 + W // dim, 1 + H // dim), np.int64)
        ends, start = [], 0
        while start < events.shape[0]:
            ends.append(fn(events, start, dim, count, counts))
            start = ends[-1] + 1
        return np.array(ends), counts

    ends = both("area_count_scan", lambda: scan(native.area_count_scan),
                lambda: scan(area_count_scan_numpy))[0]

    # the busiest frame of the busiest chunk as a dense 346x260 count map
    idx, cnt, i0, shot, stride, K, t0, tf, _, h, w = max(calls, key=lambda c: len(c[0]))[:11]
    frame_of = idx // (h * w)
    f = int(np.bincount(frame_of).argmax())
    sel = frame_of == f
    pix = idx[sel] % (h * w)
    c_map, i_map = np.zeros(h * w, np.int16), np.zeros(h * w, np.int16)
    on, off = np.zeros(h * w, bool), np.zeros(h * w, bool)
    c_map[pix], i_map[pix] = cnt[sel], i0[sel]
    if shot is not None:
        on[pix], off[pix] = (shot[sel] & 1) > 0, (shot[sel] & 2) > 0
    maps = [m.reshape(h, w) for m in (c_map, i_map, on, off)]
    st, k, tp, tfr = int(stride[f]), int(K[f]), float(t0[f]), float(tf[f])
    step = (tfr - tp) / max(k, 1)
    frame_ev = both(
        "materialize_frame",
        lambda: native.materialize_frame(maps[0], maps[1], st, k, tp, step, tfr, maps[2],
                                         maps[3], True),
        lambda: materialize_frame_numpy(maps[0], maps[1], st, k, tp, tfr, maps[2], maps[3],
                                        None, True))[0]
    both("count_frame_events", lambda: native.count_frame_events(maps[0], maps[2], maps[3]),
         lambda: int(np.abs(c_map.astype(np.int64)).sum() + on.sum() + off.sum()))
    log(f"[native] run A's {len(calls)} chunks, {events.shape[0]} events; "
        f"{len(ends)} area_count frames; frame {f} of {h}x{w}: {frame_ev.shape[0]} events; "
        "every function equal to its numpy version; host CPU " + cpu_model())
    for name, (a, b) in ms.items():
        log(f"[native] {name}: native {a:.3f} ms, numpy {b:.3f} ms ({b / max(a, 1e-9):.1f}x)")
    return {name: {"native_ms": a, "numpy_ms": b} for name, (a, b) in ms.items()}


def phase_h5(np, tmp, device="cuda"):
    """--dvs_h5 with --ddd_output and --slomo_use_saved through the CLI on
    phase_cli's input, where h5py imports: a first run records the SloMo
    cache and writes every event and frame to the HDF5 file, a second
    replays the cache and must give the same events.  Without h5py one line
    says they were not run."""
    try:
        import h5py
    except ImportError as e:
        log(f"[h5] --dvs_h5, --ddd_output and --slomo_use_saved not run: h5py does not "
            f"import on this machine ({e}); the CPU tests hold them")
        return
    from v2e_tpu_torch import cli

    base = ["-i", os.path.join(tmp, "frames"), "--input_frame_rate", str(SRC_FPS),
            "--allow_random_slomo", "--auto_timestamp_resolution", "False",
            "--timestamp_resolution", "0.003", "--skip_video_output", "--no_shuffle",
            "--sigma_thres", "0", "--leak_rate_hz", "0", "--shot_noise_rate_hz", "0",
            "--dvs_text", "j.txt", "--slomo_use_saved"]
    out = [os.path.join(tmp, "h5", name) for name in ("first", "replay")]
    first = cli.run(base + ["-o", out[0], "--dvs_h5", "j.h5", "--ddd_output"], device=device)
    second = cli.run(base + ["-o", out[1]], device=device)
    with h5py.File(os.path.join(out[0], "j.h5"), "r") as f:
        n_events, frames = f["events"].shape[0], f["frame"].shape
    if n_events != first.num_events or frames != (first.n_frames, H, W):
        raise AssertionError(f"[h5] {n_events} events for {first.num_events}, frames "
                             f"{frames} for {first.n_frames}")
    a, b = (np.loadtxt(os.path.join(o, "j.txt"), comments="#") for o in out)
    if second.staged_chunks or second.fused_chunks or not np.array_equal(a, b):
        raise AssertionError("[h5] the replayed run differs from the recorded one")
    log(f"[h5] --dvs_h5 --ddd_output: {n_events} events, frames {frames}; "
        f"--slomo_use_saved replay: {len(b)} events equal to the recorded run's")


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
            before = launch_counts(counters)
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
            launches = launches_since(before)
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
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOP_S)
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
    b_ms, b_by = bound(tot["bytes"], tot["flops"], PEAK_BF16_FLOP_S)
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


def phase_k6(torch, dev, cases):
    """K6 (bilinear x2 upsample) and its VJP at the shapes the main path
    launched them with.  `cases`: (tag, {(shape, dtype, channels_last):
    calls} of the forward, the same of the VJP or None, the launches
    counted (launch.k6, launch.k6_vjp or None) while they were recorded,
    the chunks or steps they came from, "chunk" or "step").  The counted
    launches must equal the recorded calls.  Each distinct call is
    launched once and must equal the plain version bit for bit; its largest
    difference from F.interpolate (and, for the VJP, from the library's
    backward) in ulps of the output type at the taps' scale is printed.
    Times are device times (CUDA events over repeated launches), weighted by
    each call's launches and divided by the chunks or steps, beside the
    plain version's, the library's and the bound (input read once, output
    written once)."""
    import torch.nn.functional as Fn

    from v2e_tpu_torch.ops.kernels.upsample import (
        upsample2x, upsample2x_plain, upsample2x_plain_vjp, upsample2x_vjp,
    )

    def ulps(got, want, scale, dtype):
        fi = torch.finfo(dtype)
        s = scale.to(torch.float64).abs().clamp(min=fi.tiny)
        step = fi.eps * torch.exp2(torch.floor(torch.log2(s)))
        return float(((got.double() - want.double()).abs() / step).max())

    def lib_vjp(gout, shape):
        return torch.ops.aten.upsample_bilinear2d_backward(
            gout, list(gout.shape[2:]), list(shape), False, 2.0, 2.0)

    def layout(channels_last):
        return torch.channels_last if channels_last else torch.contiguous_format

    g = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for tag, calls, vjp_calls, launches, per, unit in cases:
        if launches != (sum(calls.values()), sum(vjp_calls.values()) if vjp_calls else None):
            raise AssertionError(f"[k6] {tag}: launches {launches} counted, calls recorded "
                                 f"{dict(calls)} {dict(vjp_calls or {})}")
        tot = {"launches": launches[0], "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bytes": 0.0, "ulps": 0.0}
        for (shape, dtype, cl), k in sorted(calls.items(), key=str):
            n, c, h, w = shape
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            x = x.contiguous(memory_format=layout(cl))
            got = upsample2x(x)
            if not torch.equal(got, upsample2x_plain(x)):
                raise AssertionError(f"K6 at {shape} {dtype} differs from its plain version")
            lib = Fn.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
            scale = Fn.interpolate(x.abs().double(), scale_factor=2, mode="bilinear",
                                   align_corners=False)
            tot["ulps"] = max(tot["ulps"], ulps(got, lib, scale, dtype))
            del lib, scale
            reps = 20 if n * c * h * w < 50e6 else 10
            tot["ms"] += k * time_ms(torch, lambda: upsample2x(x), reps=reps)
            tot["plain_ms"] += k * time_ms(torch, lambda: upsample2x_plain(x), reps=3)
            tot["library_ms"] += k * time_ms(torch, lambda: Fn.interpolate(
                x, scale_factor=2, mode="bilinear", align_corners=False), reps=3)
            tot["bytes"] += k * 5 * x.numel() * x.element_size()
        if vjp_calls:
            tot.update({"vjp_launches": launches[1], "vjp_ms": 0.0,
                        "vjp_plain_ms": 0.0, "vjp_library_ms": 0.0, "vjp_bytes": 0.0,
                        "vjp_ulps": 0.0})
        for (shape, dtype, cl), k in sorted((vjp_calls or {}).items(), key=str):
            gout = torch.randn(shape, generator=g, device=dev).to(dtype)
            xshape = shape[:2] + (shape[2] // 2, shape[3] // 2)
            gx = upsample2x_vjp(gout, cl)
            if not torch.equal(gx, upsample2x_plain_vjp(gout, cl)):
                raise AssertionError(f"K6's VJP at {shape} {dtype} differs from its plain "
                                     "version")
            scale = upsample2x_plain_vjp(gout.double().abs())
            tot["vjp_ulps"] = max(tot["vjp_ulps"],
                                  ulps(gx, lib_vjp(gout, xshape), scale, dtype))
            tot["vjp_ms"] += k * time_ms(torch, lambda: upsample2x_vjp(gout, cl), reps=20)
            tot["vjp_plain_ms"] += k * time_ms(torch, lambda: upsample2x_plain_vjp(gout, cl),
                                               reps=3)
            tot["vjp_library_ms"] += k * time_ms(torch, lambda: lib_vjp(gout, xshape), reps=3)
            tot["vjp_bytes"] += k * 5 * gx.numel() * gx.element_size()
        tot = {k: v / per if k.endswith(("ms", "bytes")) else v for k, v in tot.items()}
        b_ms, _ = bound(tot["bytes"], 0)
        kinds = sorted({(str(d).removeprefix("torch."), "channels_last" if cl else "NCHW")
                        for _, d, cl in calls})
        line = (f"[k6] {tag}: {tot['launches']} launches counted in {per} {unit}s, "
                f"{tot['launches'] / per:g} a {unit} ({', '.join(' '.join(k) for k in kinds)}; "
                + ", ".join(f"{'x'.join(map(str, sh))} x{k / per:g}"
                            for (sh, _, _), k in sorted(calls.items(), key=str))
                + f"): kernel {tot['ms']:.4f} ms a {unit}, plain {tot['plain_ms']:.3f} ms, "
                f"F.interpolate {tot['library_ms']:.3f} ms, bound {b_ms:.4f} ms (bytes, "
                f"{tot['bytes'] / 1e9:.3f} GB), {b_ms / tot['ms']:.1%} of the bound; "
                f"F.interpolate within {tot['ulps']:.3g} ulps")
        if vjp_calls:
            vb_ms, _ = bound(tot["vjp_bytes"], 0)
            line += (f"; VJP {tot['vjp_launches'] / per:g} launches a {unit}, kernel "
                     f"{tot['vjp_ms']:.4f} ms, "
                     f"plain {tot['vjp_plain_ms']:.3f} ms, library backward "
                     f"{tot['vjp_library_ms']:.3f} ms, bound {vb_ms:.4f} ms, "
                     f"{vb_ms / tot['vjp_ms']:.1%}; the library's backward within "
                     f"{tot['vjp_ulps']:.3g} ulps")
            tot["vjp_bound_ms"] = vb_ms
        log(line)
        tot["shapes"] = {f"{'x'.join(map(str, sh))} {str(d).removeprefix('torch.')}"
                         f"{' channels_last' if cl else ''}": k / per
                         for (sh, d, cl), k in calls.items()}
        out[tag] = dict(tot, bound_ms=b_ms, per=per, unit=unit)
    head = out[cases[0][0]]
    return {
        "name": "upsample2x", "route": "cuda", "source": "v2e_tpu_torch/csrc/upsample.cu",
        "replaces": "none (v2e_tpu/models/unet.py:300, jax.image.resize)", "cases": out,
        "launches": head["launches"], "ms": head["ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
    }


def phase_k8(torch, dev, fused_calls, fused_launches):
    """K8 (the UNets' conv epilogue) at the shapes the main path launched
    it with: `fused_calls` ({(y's shape, dtype, with a skip): calls}) and
    `fused_launches` (launch.k8) of the N_MEAS fused chunks, which the
    `kernels` line reports a chunk.  Two more cases are one chunk of each
    conversion cell's UNets, bf16 with random weights: the flow UNet at
    N = 8 and the refinement UNet at N = 80 (dvs346_slomo_u10) or 96
    (dvs346_noisy_u12), each counted from launch.k8 taken just before it.
    In every case the counted launches must equal the recorded calls.  Each
    distinct call is launched once and must equal the plain version bit
    for bit; device times (CUDA events over repeated launches), weighted by
    the calls and divided by the chunks, beside the plain version's, the
    library pair it replaced (ATen's bias `add_` and `F.leaky_relu`, and
    `torch.cat` where the skip is, on NCHW as the parent ran them) and the
    bound (the conv output and the skip read once, the output written
    once).  Last, dvs346_slomo_u10's chunk of UNet forwards under the
    profiler, with the layout and glue kernels left on it by name."""
    import torch.nn.functional as Fn

    from v2e_tpu_torch.models.convert_ckpt import from_jax_params, init_random_slomo_params
    from v2e_tpu_torch.ops.kernels.conv_epilogue import conv_bias_leaky, conv_bias_leaky_plain

    flow, interp = from_jax_params(*init_random_slomo_params(seed=0), device=dev,
                                   dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(23)

    def nhwc(n, h, w, c):
        return torch.randn((n, h, w, c), generator=g, device=dev).to(
            torch.bfloat16).permute(0, 3, 1, 2)

    def cell_chunk(n_refine):
        flow(nhwc(8, 256, 320, 2))
        interp(nhwc(n_refine, 256, 320, 12))

    cases = [(f"fused chunks B={B} U={U}", fused_calls, fused_launches, N_MEAS)]
    for tag, n_refine in (("dvs346_slomo_u10", 80), ("dvs346_noisy_u12", 96)):
        with k8_recorder() as rec, torch.no_grad():
            before = launch_counts(["conv_bias_leaky"])
            cell_chunk(n_refine)
            launches = launches_since(before)["conv_bias_leaky"]
        cases.append((f"{tag} chunk (flow N=8, refinement N={n_refine})",
                      Counter(rec.calls), launches, 1))

    timed = {}

    def time_call(shape, dtype, with_skip):
        """(ms, plain ms, library ms, bytes) of one call, checked once."""
        if (shape, dtype, with_skip) in timed:
            return timed[shape, dtype, with_skip]
        n, c, h, w = shape
        y = nhwc(n, h, w, c).to(dtype)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        skip = nhwc(n, h, w, c).to(dtype) if with_skip else None
        if not torch.equal(conv_bias_leaky(y, bias, skip), conv_bias_leaky_plain(y, bias, skip)):
            raise AssertionError(f"K8 at {shape} {dtype} skip={with_skip} differs from "
                                 "its plain version")
        yl, bl = y.contiguous(), bias.to(dtype)[None, :, None, None]
        sl = skip.contiguous() if with_skip else None

        def library():
            a = Fn.leaky_relu(yl.add_(bl), 0.1)
            return torch.cat([a, sl], dim=1) if with_skip else a

        reps = 20 if y.numel() < 50e6 else 10
        timed[shape, dtype, with_skip] = (
            time_ms(torch, lambda: conv_bias_leaky(y, bias, skip), reps=reps),
            time_ms(torch, lambda: conv_bias_leaky_plain(y, bias, skip), reps=3),
            time_ms(torch, library, reps=5),
            (4 if with_skip else 2) * y.numel() * y.element_size())
        return timed[shape, dtype, with_skip]

    out = {}
    for tag, calls, launches, per in cases:
        if sum(calls.values()) != launches:
            raise AssertionError(f"[k8] {tag}: {launches} launches counted, "
                                 f"{sum(calls.values())} calls recorded")
        tot = {"launches": launches // per if launches % per == 0 else launches / per,
               "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bytes": 0.0}
        for key, k in sorted(calls.items(), key=str):
            for name, v in zip(("ms", "plain_ms", "library_ms", "bytes"), time_call(*key)):
                tot[name] += k * v / per
        b_ms, _ = bound(tot["bytes"], 0)
        log(f"[k8] {tag}, bf16: {launches} launches counted and recorded in {per} "
            f"chunk(s), {launches / per:g} a chunk ("
            + ", ".join(f"{'x'.join(map(str, sh))}{' +skip' if sk else ''} x{k / per:g}"
                        for (sh, _, sk), k in sorted(calls.items(), key=str))
            + f"): kernel {tot['ms']:.4f} ms a chunk, plain {tot['plain_ms']:.3f} ms, "
            f"add_ + leaky_relu (+ cat) {tot['library_ms']:.3f} ms, bound {b_ms:.4f} ms "
            f"(bytes, {tot['bytes'] / 1e9:.3f} GB), {b_ms / tot['ms']:.1%} of the bound, "
            f"{tot['ms'] / b_ms:.3f}x it")
        out[tag] = dict(tot, bound_ms=b_ms, per=per)
    with torch.no_grad():
        ms = time_ms(torch, lambda: cell_chunk(80), reps=3)
        rows = profile_device(torch, "k8", lambda: cell_chunk(80), ms,
                              "dvs346_slomo_u10's UNet forwards (flow N=8, refinement N=80, "
                              "bf16 dense)", top=10)
    glue = ("nchwToNhwc", "nhwcToNchw", "nhwcAddPadding", "CatArray", "leaky_relu",
            "CUDAFunctor_add", "reduce_kernel", "avg_pool2d")
    left = [(ms, n, name) for ms, n, name in rows if any(p in name for p in glue)]
    if rows:
        log("[k8] layout and glue kernels left on that chunk: " + ("; ".join(
            f"{name[:60]} x{n} {ms:.3f} ms" for ms, n, name in left) or "none"))
    head = out[cases[0][0]]
    return {
        "name": "conv_bias_leaky", "route": "cuda", "source": "v2e_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": "none (v2e_tpu/models/unet.py::_conv_block, XLA's fusion)", "cases": out,
        "launches": head["launches"], "ms": head["ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
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


# the synthetic generators, in the order of [synthetic-gens]
SYNTHETIC = ("moving_dot", "single_linearly_moving_dot", "spots", "barberpole",
             "gradients", "particles")
GEN_FRAMES = 640
# a uint8-level renderer may leave pixels one level off the float64 host
# painter where a float32 time, angle or phase lands on the other side of a
# floor or a comparison (tests/test_torch_synthetic.py counts them on the
# CPU: at most 3380 of 640 x 260 x 346, 5.9e-5, in gradients)
GEN_PIXEL_SHARE = 1e-4
# copies that open and close a profiled CLI run's trace ([h2d] runs before
# any other profile: late in a long run a trace lacked its first copies)
MARKER_BYTES = (4096, 8192)
# CUPTI can lose the first copy it sees after the profiler starts: a
# throwaway copy of this size goes first and is dropped from the trace
WARM_BYTES = 2048
SYNTHETIC_F = ["--synthetic_input", "scripts.moving_dot"]
SYNTHETIC_H = ["--synthetic_input", "scripts.particles", "--dvs_params", "noisy"]
# each generator's flag for the stimulus' length in seconds
SYNTHETIC_LENGTH = {"F": "--t_total", "H": "--total_time"}


def cli_copies(torch, np, argv, n_frames):
    """The copies (name, bytes) that a torch.profiler trace records over one
    whole `cli.run(argv)` cut to n_frames frames of 100 us, between two
    marker copies host to device (MARKER_BYTES) that show the trace recorded
    all of it, after a throwaway copy (WARM_BYTES).  The run makes its
    cached 0-d operands anew."""
    from torch.profiler import ProfilerActivity, profile

    from v2e_tpu_torch import cli, device

    device._scalar.cache_clear()
    markers = [np.zeros(n // 4, dtype=np.float32) for n in (WARM_BYTES,) + MARKER_BYTES]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.from_numpy(markers[0]).to("cuda")
        torch.cuda.synchronize()
        torch.from_numpy(markers[1]).to("cuda")
        torch.cuda.synchronize()
        stats = cli.run(argv, device="cuda")
        torch.cuda.synchronize()
        torch.from_numpy(markers[2]).to("cuda")
        torch.cuda.synchronize()
    if stats.n_frames != n_frames:
        raise AssertionError(f"{argv}: {stats.n_frames} frames, not {n_frames}")
    path = os.path.join(argv[argv.index("-o") + 1], "h2d-trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    copies = [(e.get("name", ""), int(e.get("args", {}).get("bytes", -1)))
              for e in sorted(trace, key=lambda e: e.get("ts", 0))
              if e.get("cat") == "gpu_memcpy"]
    if copies and "HtoD" in copies[0][0] and copies[0][1] == WARM_BYTES:
        copies = copies[1:]
    ends = copies[:1] + copies[-1:]
    if [b for n, b in ends if "HtoD" in n] != list(MARKER_BYTES):
        raise AssertionError(f"{argv}: the trace's first and last copies are not the "
                             f"markers: {copies[:4]} ... {copies[-4:]}")
    return copies[1:-1]


def phase_h2d(torch, np):
    """The bytes the CLI copies host to device per chunk on runs F's and H's
    device path, which must stay under one frame: the copies of a whole
    3-chunk run less those of a 2-chunk run (after an unprofiled warm run),
    so that they hold everything the CLI does per chunk.  Returns {run:
    bytes per chunk}."""
    from v2e_tpu_torch import cli

    frame_bytes = H * W * 4
    c = 64  # the CLI's default --chunk_size
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in (("F", SYNTHETIC_F), ("H", SYNTHETIC_H)):
            def argv(chunks, tag):
                # the generators take frames at arange(0, length, 100 us)
                return flags + ["--dvs_emulator_seed", "7", "--skip_video_output",
                                SYNTHETIC_LENGTH[name], str((chunks * c - 0.5) * 1e-4),
                                "-o", os.path.join(tmp, f"h2d{name}{tag}")]

            cli.run(argv(2, "warm"), device="cuda")
            runs = {k: cli_copies(torch, np, argv(k, k), k * c) for k in (2, 3)}
            per = {k: {d: [b for n, b in cp if d in n] for d in ("HtoD", "DtoD", "DtoH")}
                   for k, cp in runs.items()}
            nbytes = sum(per[3]["HtoD"]) - sum(per[2]["HtoD"])
            if not 0 <= nbytes < frame_bytes:
                raise AssertionError(f"run {name}: {nbytes} B host to device per chunk, "
                                     f"not under one frame ({frame_bytes} B)")
            log(f"[h2d] run {name}: {nbytes} B host to device per chunk of {c} frames (one "
                f"frame is {frame_bytes} B): the CLI's whole 3-chunk run copies "
                f"{sum(per[3]['HtoD'])} B in {len(per[3]['HtoD'])} copies host to device, "
                f"its 2-chunk run {sum(per[2]['HtoD'])} B in {len(per[2]['HtoD'])}; per chunk "
                + ", ".join(f"{len(per[3][d]) - len(per[2][d])} copies {d}"
                            for d in ("HtoD", "DtoD", "DtoH")))
            out[name] = nbytes
    return out


def event_lines(path):
    """A text sink's event lines (its header carries a creation time)."""
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("#")]


def phase_synthetic_cli(torch, np, tmp, counters):
    """The CLI's synthetic entry point at 346x260 on the card: runs F
    (moving_dot, device path, K1), G (run F with the videos on: the host
    path) and H (particles, noisy: device path with the host walker, K2),
    each with every kernel's launch counter set to 0 before and read after;
    then the device time of shortened runs F and H under torch.profiler.
    Returns {run: launches by kernel} and {run: {kernel: {(F, H, W, leak
    and shot given): calls}}}, the calls the emulator made in the run."""
    import v2e_tpu_torch.emulator.core as core
    from v2e_tpu_torch import cli

    seed = ["--dvs_emulator_seed", "7"]  # F and G draw the same noise
    runs = {
        "F": SYNTHETIC_F + seed + ["--skip_video_output", "--dvs_text", "f.txt"],
        "G": SYNTHETIC_F + seed + ["--dvs_text", "g.txt"],
        "H": SYNTHETIC_H + seed + ["--skip_video_output"],
    }
    want = {"F": "refractory_scan", "G": "refractory_scan", "H": "scan"}
    launches, stats_by, shapes = {}, {}, {}
    real = {k: getattr(core, k) for k in ("refractory_scan", "scan")}

    def recorded(k, calls):
        def call(lp, leak, shot, *rest):
            calls[(*lp.shape, leak is not None and shot is not None)] += 1
            return real[k](lp, leak, shot, *rest)
        return call

    for name, flags in runs.items():
        out = os.path.join(tmp, "syn" + name)
        before = launch_counts(counters)
        shapes[name] = {k: Counter() for k in real}
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            for k in real:
                setattr(core, k, recorded(k, shapes[name][k]))
            stats = cli.run(flags + ["-o", out], device="cuda")
        finally:
            for k, fn in real.items():
                setattr(core, k, fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[name] = launches_since(before)
        stats_by[name] = stats
        chunks = -(-stats.n_frames // 64)
        others = {k: v for k, v in launches[name].items() if k != want[name] and v}
        if launches[name][want[name]] != chunks or others:
            raise AssertionError(f"run {name}: launches {launches[name]} for {chunks} chunks; "
                                 f"wants one {want[name]} launch per chunk and nothing else")
        span = (stats.first_ts, stats.last_ts)
        if stats.num_events <= 0 or span[0] != 0.0:
            raise AssertionError(f"run {name}: {stats.num_events} events, frames {span}")
        where = ""
        if name in "FG":
            ev = np.loadtxt(os.path.join(out, name.lower() + ".txt"), comments="#",
                            usecols=0)
            if len(ev) != stats.num_events or not (
                    ev.min() >= span[0] - 1e-6 and ev.max() <= span[1] + 1e-6):
                raise AssertionError(f"run {name}: {len(ev)} event times in "
                                     f"{ev.min()}-{ev.max()}, frames {span}")
            where = f", event times {ev.min():.6f}-{ev.max():.6f} s inside the frames' span"
        log(f"[cli] run {name}: {stats.n_frames} frames of {W}x{H} in {chunks} chunks, "
            f"{stats.num_events} events{where}; launches "
            + ", ".join(f"{k} {v}" for k, v in launches[name].items())
            + f"; {want[name]} calls by (F, H, W, leak and shot) "
            + ", ".join(f"{k} x{v}" for k, v in sorted(shapes[name][want[name]].items()))
            + f"; wall {wall:.2f} s, realtime factor {stats.realtime_factor:.4f} "
            f"(stimulus {span[1] - span[0]:.4f} s, cli {stats.wall_s:.2f} s)")

    # run G: the host painter's frames against the card's renderer
    f_ev, g_ev = (event_lines(os.path.join(tmp, "syn" + n, n.lower() + ".txt")) for n in "FG")
    if f_ev != g_ev:
        n_px, n_fr, worst = render_diff(np, "moving_dot", stats_by["F"].n_frames)
        rel = abs(len(f_ev) - len(g_ev)) / len(f_ev)
        only_f = len(Counter(f_ev) - Counter(g_ev))
        only_g = len(Counter(g_ev) - Counter(f_ev))
        log(f"[cli] run G: events differ from run F ({len(g_ev)} vs {len(f_ev)}, {rel:.4%}; "
            f"{only_f} events of F not in G, {only_g} of G not in F); "
            f"the card's renderer differs from the host painter at {n_px} pixels in {n_fr} "
            f"frames, by at most {worst} level")
        if rel > 1e-3:
            raise AssertionError(f"run G: event totals differ by {rel:.4%} > 0.1 %")
    else:
        log(f"[cli] run G (host path, videos on): all {len(g_ev)} events equal to run F's")
    avi = os.path.join(tmp, "synG", "video_orig.avi")
    if os.path.getsize(avi) <= 0:
        raise AssertionError("run G: video_orig.avi is empty")
    log(f"[cli] run G: video_orig.avi {os.path.getsize(avi)} B")

    short = {"F": SYNTHETIC_F + seed + ["--skip_video_output", "--cycles", "0.25"],
             "H": SYNTHETIC_H + seed + ["--skip_video_output", "--total_time", "0.25"]}
    for name, flags in short.items():
        argv = flags + ["-o", os.path.join(tmp, "prof" + name)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        cli.run(argv, device="cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        profile_device(torch, "syn-profile", lambda: cli.run(argv, device="cuda"), ms,
                       f"run {name} over a quarter of its stimulus", top=8)
    return launches, {name: shapes[name][want[name]] for name in runs}


def twins(name, k):
    """k instances of generator `name` at W x H that render the same frames
    (particles: the same walkers and respawn stream)."""
    from v2e_tpu_torch.synthetic import load_synthetic_input

    cls = load_synthetic_input(f"scripts.{name}")
    out = [cls(width=W, height=H) for _ in range(k)]
    if name == "particles":
        for o in out[1:]:
            o.pos, o.vel = out[0].pos.copy(), out[0].vel.copy()
            o._rng = copy.deepcopy(out[0]._rng)
    return out


def gen_frames(np, name, n, devices, chunk=64):
    """The first n frames of generator `name` at W x H, as numpy: the host
    painter's (float32), then the renderer's on each of `devices`, chunk by
    chunk, all from the same walkers; with their times and a spare
    instance."""
    host_syn, *syns, spare = twins(name, len(devices) + 2)
    frames, ts = [], []
    for _ in range(n):
        fr, t = host_syn.next_frame()
        frames.append(np.asarray(fr, dtype=np.float32))
        ts.append(t)
    ts = np.asarray(ts)
    renders = [np.concatenate([syn.device_frames(ts[s: s + chunk], device).cpu().numpy()
                               for s in range(0, n, chunk)])
               for syn, device in zip(syns, devices)]
    return np.stack(frames), renders, ts, spare


def render_diff(np, name, n):
    """Pixels, frames and the largest level by which the card's renderer
    differs from the host painter over the first n frames of `name`."""
    host, (card,), _, _ = gen_frames(np, name, n, ("cuda",))
    d = np.abs(card - host)
    return (int((d > 0).sum()), int((d.reshape(n, -1).max(axis=1) > 0).sum()),
            float(d.max()))


def phase_synthetic_gens(torch, np, dev, n=GEN_FRAMES):
    """The first n frames of each generator at 346x260: the card's renderer
    against the port's host painter and against the same renderer on the
    CPU, and its time per 64-frame chunk.  Returns {name: numbers}."""
    from v2e_tpu_torch.synthetic.device import particles_frames
    from v2e_tpu_torch.synthetic.draw import paint_gaussian_dots

    out = {}
    n_pix = n * H * W
    for name in SYNTHETIC:
        host, (card, cpu), ts, spare = gen_frames(np, name, n, (dev, "cpu"))
        d_host = np.abs(card - host)
        d_cpu = np.abs(card - cpu)
        if name == "particles":
            walker, timed = twins(name, 2)
            args = (W, H, float(spare.fg), float(spare.bg), float(spare.radius), 2.0,
                    int(spare.radius * 2) + 1)
            painted = np.stack([paint_gaussian_dots(c, *args) for c in spare.trajectory(ts)])
            rel = float((np.abs(card - painted) / np.maximum(painted, 1.0)).max())
            rel_cpu = float((d_cpu / np.maximum(np.abs(cpu), 1.0)).max())
            ok = rel <= 1e-5 and rel_cpu <= 1e-5
            what = (f"max relative err {rel:.3g} against the host painter on the same float32 "
                    f"centers, {rel_cpu:.3g} against the CPU renderer on them; against "
                    f"next_frame (float64 positions) max abs err {d_host.max():.3g}, "
                    f"{int((d_host > 1e-3).sum())} pixels beyond 1e-3 in "
                    f"{int((d_host.reshape(n, -1).max(1) > 1e-3).sum())} frames")
            centers = walker.trajectory(ts[:64])
            ms = time_ms(torch, lambda: particles_frames(centers, *args, device=dev), reps=20)
            t = time.perf_counter()
            timed.trajectory(ts[:64])
            walk_ms = (time.perf_counter() - t) * 1e3
            what += f"; host walker {walk_ms:.3f} ms per chunk"
        else:
            n_host = int((d_host > 0).sum())
            n_cpu = int((d_cpu > 0).sum())
            ok = d_host.max() <= 1.0 and n_host <= GEN_PIXEL_SHARE * n_pix
            what = (f"{n_host} pixels in {int((d_host.reshape(n, -1).max(1) > 0).sum())} frames "
                    f"off the host painter (max {d_host.max():.0f} level), {n_cpu} off the CPU "
                    f"renderer (max {d_cpu.max():.0f})")
            ms = time_ms(torch, lambda: spare.device_frames(ts[:64], dev), reps=20)
        log(f"[synthetic-gens] {name}: {n} frames of {W}x{H}: {what}; renderer {ms:.4f} ms "
            f"per 64-frame chunk")
        if not ok:
            raise AssertionError(f"[synthetic-gens] {name}: {what}")
        out[name] = {"ms_per_chunk": ms, "max_err_host": float(d_host.max()),
                     "max_err_cpu": float(d_cpu.max())}
    return out


def run_frames(name, calls, h=H, w=W):
    """The frame counts of a kernel's calls in run `name`, each call made at
    h x w, largest first."""
    if {(ch, cw) for _, ch, cw, _ in calls} != {(h, w)}:
        raise AssertionError(f"run {name} called the kernel at {dict(calls)}, not at {h}x{w}")
    return sorted({f for f, *_ in calls}, reverse=True)


def phase_k1_run_f(torch, calls, launches):
    """K1 at each shape run F called it with (its 64-frame chunks and the
    shorter last one) of 260x346, at the generators' 100 us step under the
    CLI's 0.5 ms refractory period.  Returns the numbers of the full
    chunk, with each shape's under `by_frames`."""
    by = {f: check_k1(torch, f, 1e-4, 0.0005, f"run F shape (F={f}, dt 100 us)")
          for f in run_frames("F", calls)}
    log(f"[k1] run F: {launches} launches (one per chunk), calls by (F, H, W, leak and "
        f"shot) {dict(calls)}")
    return {**by[max(by)], "by_frames": by}


def phase_k2_run_h(torch, dev, calls, launches):
    """K2 at each shape run H called it with (its 64-frame chunks, which fill
    the ring's stages only in part, and the shorter last one) of 260x346,
    with the noisy preset's leak and shot noise at the generators' 100 us
    step.  Returns the numbers of each shape and run H's launches."""
    if not all(noisy for *_, noisy in calls):
        raise AssertionError(f"run H called K2 without leak or shot noise: {dict(calls)}")
    by = {f: check_k2(torch, dev, f, H, W, True, f"run H shape (F={f}, dt 100 us)", dt=1e-4)
          for f in run_frames("H", calls)}
    log(f"[k2] run H: {launches} launches (one per chunk), calls by (F, H, W, leak and "
        f"shot) {dict(calls)}")
    return {"launches": launches, "by_frames": by}


def phase_thres(torch, np, dev, n=GEN_FRAMES):
    """estimate_thresholds on n moving-dot frames rendered on the card, no
    mismatch, noise or lowpass, targets from a run at 0.25/0.25: the same
    thresholds on the card as on the CPU (which gets the card's frames)."""
    from v2e_tpu_torch.analysis import thres_estimator as te
    from v2e_tpu_torch.synthetic.device import moving_dot_frames

    times = np.arange(n) * 1e-4
    frames = moving_dot_frames(times, W, H, device=dev)
    clean = dict(sigma_thres=0.0, leak_rate_hz=0.0, shot_noise_rate_hz=0.0, cutoff_hz=0.0)
    on, off = te._count_events(frames, times, 0.25, 0.25, device=dev, **clean)
    if min(on, off) <= 0:
        raise AssertionError(f"[thres] the stimulus gives {on} ON and {off} OFF events")
    count = te._count_events
    got = {}
    try:
        for device, fr in (("cuda", frames), ("cpu", frames.cpu())):
            probes = []
            te._count_events = lambda *a, **k: probes.append(a[2]) or count(*a, **k)
            t = time.perf_counter()
            thr = te.estimate_thresholds(fr, times, on, off, device=device, **clean)
            got[device] = (thr, len(probes), time.perf_counter() - t)
    finally:
        te._count_events = count
    (tg, pg, sg), (tc, pc, sc) = got["cuda"], got["cpu"]
    log(f"[thres] {n} frames of {W}x{H}, targets {on} ON / {off} OFF at 0.25: card "
        f"{tg} in {pg} probes, {sg:.2f} s ({sg / max(pg, 1):.3f} s per probe); CPU {tc} in "
        f"{pc} probes, {sc:.2f} s")
    if tg != tc or pg != pc:
        raise AssertionError(f"[thres] card {tg} ({pg} probes) vs CPU {tc} ({pc} probes)")
    return {"thresholds": list(tg), "probes": pg, "card_s": sg, "cpu_s": sc}


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
        return rows
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{tag}] {what}: device kernel time {busy:.1f} ms in {len(rows)} kernels "
        f"(wall {wall_ms:.1f} ms with the profiler on; {busy / ref_ms:.1%} of the "
        f"unprofiled {ref_ms:.1f} ms)")
    for ms, n, name in rows[:top]:
        log(f"[{tag}]   {ms:9.3f} ms x{n:<5d} {name[:100]}")
    return rows


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


# ---- several devices: pixel strips, K1 on strips, time segments, DDP ----

PIXEL_U = RUN_B_U
PIXEL_F = 8 * RUN_B_U  # run B's chunk: 8 source pairs at U = 12
PIXEL_CHUNKS = 4
SEG_S, SEG_W, SEG_U, SEG_CHUNKS = 4, 8, 96, 3  # segments, warm-up, run A's U (F = 768)
# the CLI's emulator defaults (args.py)
CLI_EMULATOR = dict(pos_thres=0.2, neg_thres=0.2, sigma_thres=0.03, cutoff_hz=300.0,
                    leak_rate_hz=0.01, shot_noise_rate_hz=0.001, refractory_period_s=0.0005)
DDP_RANKS, DDP_STEPS = 2, 5
# [ddp]'s step: train_slomo's default global batch and crop, SuperSloMo's width
DDP_SHAPE = (TRAIN_N, TRAIN_H, TRAIN_W, 32)
PIXEL_LARGE = (720, 1280, 4)  # [pixel]'s large plane and its strips
PLAIN_SCANS = ("refractory_count_plain", "refractory_apply_plain", "refractory_scan_plain",
               "refractory_scan_strips_plain", "scan_plain")


def scene(torch, dev, n, h, w, u):
    """make_source_frames' scene (a drifting texture and a moving blob) and
    a bright bar sweeping 40 px per source frame, as the CLI runs' input,
    sampled u times per 30 fps source frame: u8[n,h,w] on the card."""
    f32 = torch.float32
    yy = torch.arange(h, device=dev, dtype=f32)[:, None]
    xx = torch.arange(w, device=dev, dtype=f32)[None, :]
    s = (torch.arange(n, device=dev, dtype=f32) / u)[:, None, None]
    fr = 100 + 40 * torch.sin((xx + 2.0 * s) / 17.0) * torch.cos(yy / 13.0)
    cx = torch.remainder(w / 4 + 5 * s, w)
    fr = fr + 80 * torch.exp(-((xx - cx) ** 2 + (yy - h / 2) ** 2) / (2 * 15.0 ** 2))
    fr = fr + 100 * (torch.remainder(xx + 0.5 * yy - 40.0 * s, 240.0) < 30.0).to(f32)
    return torch.clamp(fr, 0, 255).to(torch.uint8)


def run_stream(torch, np, em, frames, times, chunk, n_chunks):
    """Feed 1 + n_chunks * chunk frames to `em` in chunks (the first with the
    initial frame); returns (events, mean ms per chunk after the first, from
    submit to collected events)."""
    evs, ms = [], []
    for c in range(n_chunks):
        a, b = (0 if c == 0 else 1 + c * chunk), 1 + (c + 1) * chunk
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev = em.generate_events_batch(frames[a:b], times[a:b])
        torch.cuda.synchronize()
        if c:
            ms.append((time.perf_counter() - t) * 1e3)
        if ev is not None:
            evs.append(ev)
    return np.concatenate(evs), float(np.mean(ms))


class PlainScansRefused:
    """Within the block, any plain version of K1, K1 on strips or K2
    raises: the main path must reach the kernels."""

    def __enter__(self):
        from v2e_tpu_torch.ops.kernels import emulator_scan as es

        self.es, self.saved = es, {n: getattr(es, n) for n in PLAIN_SCANS}

        def refuse(*a, **k):
            raise AssertionError("a plain scan version ran on the main path")
        for n in PLAIN_SCANS:
            setattr(es, n, refuse)

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.es, n, fn)


def phase_pixel(torch, np, dev):
    """`[pixel]`: EventEmulator with a mesh of S strips on the card against
    the single-device EventEmulator on the same frames (4 chunks of run B's
    96 frames at 1/360 s, seed 42, the CLI's emulator defaults): with R =
    0.5 ms (K1 on strips) at S = 2 and 3 (3 pads 260 rows to 261), with the
    noisy preset (K2 per strip) at S = 2 and 3, and at 1280x720 with S = 4.
    Events equal bit for bit; launches as the strips need them and no
    plain version.  Returns the S = 3 refractory run's launches."""
    from v2e_tpu_torch.emulator import EventEmulator
    from v2e_tpu_torch.ops.kernels import emulator_scan as es
    from v2e_tpu_torch.parallel.mesh import Mesh

    counters = {"refractory_scan_strips": es.refractory_scan_strips,
                "refractory_scan": es.refractory_scan, "scan": es.scan}
    cases = [(None, H, W, 2), (None, H, W, 3), ("noisy", H, W, 2), ("noisy", H, W, 3),
             (None, *PIXEL_LARGE)]
    n = 1 + PIXEL_CHUNKS * PIXEL_F
    times = np.arange(n) / (SRC_FPS * PIXEL_U)
    out = {}
    for preset, h, w, S in cases:
        frames = scene(torch, dev, n, h, w, PIXEL_U)

        def emulator(mesh):
            em = EventEmulator(**CLI_EMULATOR, seed=42, shuffle_events_within_iteration=False,
                               device=dev, mesh=mesh, pad_rows=(-h) % S if mesh else 0)
            if preset:
                em.set_dvs_params(preset)
            return em

        ev1, ms1 = run_stream(torch, np, emulator(None), frames, times, PIXEL_F, PIXEL_CHUNKS)
        before = launch_counts(counters)
        with PlainScansRefused():
            ev2, ms2 = run_stream(torch, np, emulator(Mesh([[dev] * S], ("data", "spatial"))),
                                  frames, times, PIXEL_F, PIXEL_CHUNKS)
        launches = launches_since(before)
        tag = f"{preset or 'R=0.5ms'} {w}x{h} S={S}"
        if not np.array_equal(ev1, ev2):
            raise AssertionError(f"[pixel] {tag}: {len(ev2)} events on strips, {len(ev1)} on "
                                 "one device, not equal")
        n_chunks = PIXEL_CHUNKS * S
        want = ({"refractory_scan_strips": n_chunks, "refractory_scan": 0, "scan": 0}
                if preset is None else
                {"refractory_scan_strips": 0, "refractory_scan": 0, "scan": n_chunks})
        if launches != want:
            raise AssertionError(f"[pixel] {tag}: launches {launches}, want {want}")
        log(f"[pixel] {tag}{' (1 pad row)' if h % S else ''}: {len(ev1)} events equal to "
            f"the single device's bit for bit; launches {launches}; {ms2:.2f} ms per chunk "
            f"of {PIXEL_F} frames on strips, {ms1:.2f} ms on one device")
        out[tag] = {"events": len(ev1), "ms": ms2, "ms_one_device": ms1, "launches": launches}
        del frames
    return out


def strip_rows(torch, args, S):
    """refractory_scan's arguments (refr_inputs) cut into S row strips."""
    from v2e_tpu_torch.parallel.mesh import strip_bounds

    return [tuple(x[..., a:b, :].clone(memory_format=torch.contiguous_format)
                  for x in args[:7]) + args[7:] for a, b in strip_bounds(args[0].shape[1], S)]


def kernel_device_ms(torch, fn, name, reps):
    """Mean device ms per launch of the kernels whose name holds `name`,
    over `reps` calls of fn under torch.profiler; None where the profiler
    sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if name in e.key and str(e.device_type).endswith("CUDA"):
            total += getattr(e, "self_device_time_total", 0) or 0
            count += e.count
    return total / count / 1e3 if total > 0 else None


def phase_k1_strips(torch, dev, launches):
    """`[k1-strips]`: K1 on 3 strips of the card at run B's shape (96
    frames of 260x346 at 1/360 s, R = 0.5 ms, refr_inputs) against its
    plain version and against K1 on the whole plane, all bit for bit; the
    split chunk (one call: 3 launches and the wait for them) timed beside
    K1's chunk and K1's bound, and under the profiler the kernels' device
    time at 3 strips and at 1 strip (a round trip through the exchange per
    frame with no other strip to wait for) beside K1's: their excess over
    K1 per frame is the cost of the second level of the barrier.  Returns
    the kernel's entry with the launches of the [pixel] run `launches`."""
    from v2e_tpu_torch.ops.kernels import emulator_scan as es

    S, F = 3, PIXEL_F
    args = refr_inputs(torch, dev, F, 1.0 / (SRC_FPS * PIXEL_U), 0.0005)
    strips, one = strip_rows(torch, args, S), strip_rows(torch, args, 1)
    got = es.refractory_scan_strips(strips)
    want = es.refractory_scan_strips_plain(strips)
    whole = es.refractory_scan(*args)
    torch.cuda.synchronize()
    grids = es._device_grids(tuple(a[0].shape[1] * a[0].shape[2] for a in strips),
                             tuple(a[0].device.index for a in strips))
    for k, name in enumerate(("base", "mem", "counts", "i0")):
        g = torch.cat([r[k] for r in got], dim=-2)
        if not (torch.equal(g, torch.cat([r[k] for r in want], dim=-2))
                and torch.equal(g, whole[k])):
            raise AssertionError(f"[k1-strips] {name}: the strips differ from their plain "
                                 "version or from K1")
    if not all(torch.equal(r[4], whole[4]) and torch.equal(r[4], w[4])
               for r, w in zip(got, want)):
        raise AssertionError("[k1-strips] K: the strips differ from their plain version or K1")
    if not bool(whole[3].any()):
        raise AssertionError("[k1-strips] the test data leaves the filter idle")
    ms = {"split_chunk": time_ms(torch, lambda: es.refractory_scan_strips(strips), reps=20),
          "one_strip_chunk": time_ms(torch, lambda: es.refractory_scan_strips(one), reps=20),
          "k1_chunk": time_ms(torch, lambda: es.refractory_scan(*args), reps=20),
          "plain": time_ms(torch, lambda: es.refractory_scan_strips_plain(strips), reps=2)}
    dev_ms = {"strips": kernel_device_ms(torch, lambda: es.refractory_scan_strips(strips),
                                         "refr_strips", 10),
              "one_strip": kernel_device_ms(torch, lambda: es.refractory_scan_strips(one),
                                            "refr_strips", 10),
              "k1": kernel_device_ms(torch, lambda: es.refractory_scan(*args),
                                     "refr_persistent", 10)}
    # K1's bound: each input read once, each output written once (13 B per
    # pixel-frame, the state planes once)
    b_chunk = bound(F * H * W * 13 + H * W * 24, F * H * W * 40)
    hop = {k: (None if dev_ms[k] is None or dev_ms["k1"] is None
               else (dev_ms[k] - dev_ms["k1"]) / F * 1e3) for k in ("strips", "one_strip")}
    fmt = lambda v, f=".4f": "not measured" if v is None else format(v, f)
    log(f"[k1-strips] {S} strips of {F} frames at {W}x{H}, grids "
        f"{[(g.blocks, g.threads) for g in grids]}: counts, i0, K, base and memory equal to "
        f"the plain version and to K1 bit for bit; the split chunk {ms['split_chunk']:.4f} ms "
        f"per call ({S} launches and the wait), one strip {ms['one_strip_chunk']:.4f} ms, K1 "
        f"{ms['k1_chunk']:.4f} ms (K1's former two halves: 20.7 ms on an H100 80GB HBM3 at "
        f"700 W); device per launch: "
        f"strips {fmt(dev_ms['strips'])} ms, one strip {fmt(dev_ms['one_strip'])} ms, K1 "
        f"{fmt(dev_ms['k1'])} ms; over K1 per frame: {fmt(hop['strips'], '.2f')} us at "
        f"{S} strips, {fmt(hop['one_strip'], '.2f')} us at 1 (the exchange's round trip); "
        f"K1's bound {b_chunk[0]:.4f} ms; plain {ms['plain']:.1f} ms")
    return {"name": "refractory_scan_strips", "route": "cuda",
            "source": "v2e_tpu_torch/csrc/emulator_scan.cu",
            "replaces": "v2e_tpu/ops/pallas/emulator_scan.py:247",
            "launches": launches["refractory_scan_strips"], "max_abs_err": 0.0,
            "ms": dev_ms["strips"] if dev_ms["strips"] is not None else ms["split_chunk"],
            "plain_ms": ms["plain"], "bound_ms": b_chunk[0], "bound_by": b_chunk[1],
            "library_ms": None, "split_chunk_ms": ms["split_chunk"],
            "one_strip_chunk_ms": ms["one_strip_chunk"], "k1_chunk_ms": ms["k1_chunk"],
            "device_ms": dev_ms, "hop_us_per_frame": hop,
            "grids": [[g.blocks, g.threads, int(g.regs)] for g in grids]}


def pixel_sums(np, ev, h, w):
    """Each pixel's signed event count."""
    m = np.zeros((h, w), np.int64)
    np.add.at(m, (ev[:, 2].astype(np.int64), ev[:, 1].astype(np.int64)),
              np.where(ev[:, 3] > 0, 1, -1))
    return m


def phase_segment(torch, np, dev):
    """`[segment]`: EventEmulator in 4 time segments on the card (warm-up 8,
    3 chunks of run A's 768 frames at U = 96, the CLI's emulator defaults
    without leak) against the continuous run, twice: with R = 0.5 ms (K1
    once per segment) and with R = 0 (K2 once per segment).  The event
    totals within 2.5 % of the continuous run's (tests/test_parallel.py's
    bound for long chunks); with R = 0 each pixel's signed count within one
    threshold crossing per seam (3 in a chunk and one at each later
    chunk's start), the bound parallel/convert.py states; with R > 0 a
    fresh segment also forgets the refractory filter's lag, so that
    displacement is printed, not held.  Returns the numbers."""
    from v2e_tpu_torch.emulator import EventEmulator
    from v2e_tpu_torch.ops.kernels import emulator_scan as es
    from v2e_tpu_torch.parallel.convert import make_segment_mesh

    F = 8 * SEG_U
    n = 1 + SEG_CHUNKS * F
    frames = scene(torch, dev, n, H, W, SEG_U)
    times = np.arange(n) / (SRC_FPS * SEG_U)
    card = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    seams = SEG_CHUNKS * (SEG_S - 1) + SEG_CHUNKS - 1
    out, bad = {}, []
    for R, kernel in ((0.0005, es.refractory_scan), (0.0, es.scan)):
        kw = dict(CLI_EMULATOR, leak_rate_hz=0.0, refractory_period_s=R, seed=42,
                  shuffle_events_within_iteration=False, device=dev)
        ev1, ms1 = run_stream(torch, np, EventEmulator(**kw), frames, times, F, SEG_CHUNKS)
        before = launch_counts([kernel.__name__])
        seg = EventEmulator(mesh=make_segment_mesh(SEG_S, card), parallel_mode="segment",
                            segment_warmup=SEG_W, **kw)
        with PlainScansRefused():
            ev2, ms2 = run_stream(torch, np, seg, frames, times, F, SEG_CHUNKS)
        launches = launches_since(before)[kernel.__name__]
        delta = int(np.abs(pixel_sums(np, ev1, H, W) - pixel_sums(np, ev2, H, W)).max())
        rate = (len(ev2) - len(ev1)) / len(ev1)
        tag = f"R={R * 1e3:g}ms"
        log(f"[segment] {tag}: {SEG_S} segments, warm-up {SEG_W}, {SEG_CHUNKS} chunks of {F} "
            f"frames at {W}x{H}: {kernel.__name__} {launches} launches; events {len(ev2)} "
            f"against {len(ev1)} continuous ({rate:+.3%}), largest per-pixel displacement "
            f"{delta} crossings over {seams} seams; {ms2:.2f} ms per chunk, continuous "
            f"{ms1:.2f} ms")
        if launches != SEG_S * SEG_CHUNKS or abs(rate) > 0.025 or (R == 0 and delta > seams):
            bad.append(tag)
        out[tag] = {"ms": ms2, "ms_continuous": ms1, "events": len(ev2),
                    "events_continuous": len(ev1), "max_pixel_delta": delta,
                    "launches": launches}
    if bad:
        raise AssertionError(f"[segment] {bad}: launches, totals or the seam bound")
    return out


def ddp_batch(np, shape):
    """A seeded global batch of random triplets, shape (n, h, w, base)."""
    n, h, w, _ = shape
    rng = np.random.default_rng(3)
    batch = {k: (0.3 * rng.normal(size=(n, 1, h, w))).astype(np.float32)
             for k in ("I0", "I1", "It")}
    batch["t"] = rng.uniform(0.1, 0.9, (n,)).astype(np.float32)
    return batch


def ddp_rank(rank, world, port, out, device, shape):
    """One rank of `[ddp]` on `device`: one step, its launches and (rank 0)
    its loss and weights; then DDP_STEPS steps timed with the all-reduce and
    as many without (no_sync)."""
    import contextlib
    import importlib

    import numpy as np
    import torch
    import torch.distributed as dist

    import v2e_tpu_torch.ops.kernels.warp as warp_mod
    from v2e_tpu_torch.models import train

    backwarp_mod = importlib.import_module("v2e_tpu_torch.models.backwarp")

    def refuse(*a, **k):
        raise AssertionError("a plain warp ran in the data-parallel step")
    if torch.device(device).type == "cuda":  # on the card the step must reach K3
        warp_mod.warp_plain = warp_mod.warp_plain_vjp = backwarp_mod.warp_plain = refuse
    dev = train.init_ranks(device, rank, world, f"tcp://localhost:{port}")
    try:
        state = train.replicate_state(
            train.create_train_state(seed=0, base=shape[3], device=dev))
        step = train.make_train_step()
        batch = train.shard_batch(ddp_batch(np, shape))
        before = launch_counts(["bilinear_warp", "bilinear_warp_vjp"])
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        result = {"launches": list(launches_since(before).values()),
                  "backend": dist.get_backend()}
        if rank == 0:
            params = [p for net in (state.flow_net, state.interp_net)
                      for p in train.unwrap(net).parameters()]
            result["loss"] = float(metrics["loss"])
            result["weights"] = [p.detach().cpu().clone() for p in params]
            result["grads"] = [p.grad.detach().cpu().clone() for p in params]

        def median_ms(local):
            ms = []
            for _ in range(DDP_STEPS):
                with contextlib.ExitStack() as stack:
                    if local:
                        stack.enter_context(state.flow_net.no_sync())
                        stack.enter_context(state.interp_net.no_sync())
                    dist.barrier()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    step(state, batch)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
            return float(np.median(ms))

        result["ms"] = median_ms(False)
        result["ms_local"] = median_ms(True)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_ddp(torch, np, dev, tmp):
    """`[ddp]`: train_slomo's step at SuperSloMo's full width (base 32,
    256x320, global batch 8) on two ranks of the card over gloo (DDP),
    against one process on the whole batch, with cuDNN's TF32 on as
    train_slomo runs (the method and tolerances of `[train-small]`'s card
    check): the loss within 1e-3 relative, the ranks' averaged gradients
    within 1e-3 of their largest, and Adam on those gradients giving the
    ranks' weights (1e-6 of the largest); the weights after the whole step printed (Adam's first step
    moves each weight by about lr times the sign of its gradient, so a
    gradient near zero whose sign the batch split turns moves it by 2 lr).
    Each rank launches K3 and its VJP 6 times and no plain warp.  Prints
    the step's median ms and the all-reduce's share (the step against the
    same step under no_sync)."""
    import torch.multiprocessing as mp

    from v2e_tpu_torch.models import train

    mp.spawn(ddp_rank, args=(DDP_RANKS, train.free_port(), tmp, str(dev), DDP_SHAPE),
             nprocs=DDP_RANKS)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(DDP_RANKS)]
    r0 = ranks[0]
    state = train.create_train_state(seed=0, base=DDP_SHAPE[3], device=dev)
    params = [p for net in (state.flow_net, state.interp_net) for p in net.parameters()]
    b = train.batch_to(ddp_batch(np, DDP_SHAPE), dev)
    loss, _ = train.slomo_loss(state.flow_net, state.interp_net, b["I0"], b["I1"], b["It"], b["t"])
    loss.backward()
    loss = float(loss.detach())
    grads = [p.grad.detach().cpu().clone() for p in params]
    g_err = (max(float((a - g).abs().max()) for a, g in zip(r0["grads"], grads))
             / max(float(g.abs().max()) for g in grads))
    state.optimizer.step()  # one process's whole step
    raw = [p.detach().cpu().clone() for p in params]
    # Adam afresh from the same weights on the ranks' averaged gradients
    state = train.create_train_state(seed=0, base=DDP_SHAPE[3], device=dev)
    params = [p for net in (state.flow_net, state.interp_net) for p in net.parameters()]
    for p, g in zip(params, r0["grads"]):
        p.grad = g.to(dev)
    state.optimizer.step()
    scale = max(float(w.abs().max()) for w in raw)
    adam_err = max(float((p.detach().cpu() - w).abs().max())
                   for p, w in zip(params, r0["weights"])) / scale
    raw_err = max(float((a - w).abs().max()) for a, w in zip(r0["weights"], raw)) / scale
    l_err = abs(r0["loss"] - loss) / abs(loss)
    if (l_err > 1e-3 or g_err > 1e-3 or adam_err > 1e-6
            or any(r["launches"] != [6, 6] for r in ranks)):
        raise AssertionError(f"[ddp] loss {r0['loss']} against {loss} ({l_err:.2e}), "
                             f"gradients {g_err:.2e} and Adam's weights {adam_err:.2e} of "
                             f"their largest, launches {[r['launches'] for r in ranks]}")
    ms, ms_local = r0["ms"], r0["ms_local"]
    share = (ms - ms_local) / ms
    n, h, w, base = DDP_SHAPE
    log(f"[ddp] {DDP_RANKS} ranks on {dev} over {r0['backend']}, global batch {n} of {h}x{w}, "
        f"base {base}: loss {r0['loss']:.5f} against one process's {loss:.5f} "
        f"({l_err:.2e}), averaged gradients within {g_err:.2e} of their largest, Adam on them "
        f"{adam_err:.2e}; weights after the step {raw_err:.2e} of their largest (2 lr = "
        f"{2e-4 / scale:.2e}); K3 and VJP launches per rank {[r['launches'] for r in ranks]}; "
        f"step {ms:.1f} ms (median of {DDP_STEPS}; {n / ms * 1e3:.1f} samples/s), "
        f"{ms_local:.1f} ms without the all-reduce: its share {share:.1%}")
    return {"ms": ms, "ms_without_allreduce": ms_local, "allreduce_share": share,
            "loss_rel_err": l_err, "grads_rel_err": g_err, "adam_rel_err": adam_err,
            "weights_rel_err": raw_err}


def phase_cli_parallel(np, tmp):
    """`[cli-parallel]`: run B's flags (emulator seed 7) in process on one
    device, then `python -m v2e_tpu_torch` with --devices 2 --parallel_mode
    segment: on one card it logs the clamp warning and writes the same
    events."""
    from v2e_tpu_torch import cli

    argv = ["-i", os.path.join(tmp, "frames"), "--input_frame_rate", str(SRC_FPS),
            "--allow_random_slomo", "--dvs_params", "noisy", "--auto_timestamp_resolution",
            "False", "--timestamp_resolution", "0.003", "--skip_video_output",
            "--dvs_emulator_seed", "7", "--dvs_text", "ev.txt"]
    one, two = os.path.join(tmp, "cli-one"), os.path.join(tmp, "cli-two")
    cli.run(argv + ["-o", one], device="cuda")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "v2e_tpu_torch", *argv, "-o", two,
                           "--devices", "2", "--parallel_mode", "segment"],
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t
    ev = [np.loadtxt(os.path.join(d, "ev.txt"), comments="#") for d in (one, two)]
    warned = "--devices 2 > 1 available; using 1" in proc.stderr
    if proc.returncode or not warned or not np.array_equal(ev[0], ev[1]) or not len(ev[0]):
        raise AssertionError(f"[cli-parallel] exit {proc.returncode}, clamp warning {warned}, "
                             f"events {len(ev[1])} against {len(ev[0])}: "
                             f"{proc.stderr[-1500:]}")
    log(f"[cli-parallel] --devices 2 --parallel_mode segment on one card: the clamp warning, "
        f"{len(ev[1])} events equal to the single-device run's; {wall:.2f} s in a fresh process")


def phase_dryrun():
    """`[dryrun]`: `python -m v2e_tpu_torch.parallel.dryrun 2` on the card."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "v2e_tpu_torch.parallel.dryrun", "2"],
                          capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip OK")]
    if proc.returncode or not lines:
        raise AssertionError(f"[dryrun] exit {proc.returncode}: {proc.stdout[-1000:]} "
                             f"{proc.stderr[-1500:]}")
    log(f"[dryrun] {lines[0]} ({time.perf_counter() - t:.2f} s)")


def main() -> int:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from v2e_tpu_torch import native
    from v2e_tpu_torch.emulator import EventEmulator
    from v2e_tpu_torch.fused import FusedConverter
    from v2e_tpu_torch.io.aedat2 import AEDat2Output
    from v2e_tpu_torch.io.text import DVSTextOutput
    from v2e_tpu_torch.models.slomo import MAX_GROUP, SuperSloMo, _group_split
    from v2e_tpu_torch.ops.kernels import build
    from v2e_tpu_torch.ops.kernels.conv3 import conv3x3_lane
    from v2e_tpu_torch.ops.kernels.emulator_scan import refractory_scan, scan
    from v2e_tpu_torch.ops.kernels.upsample import upsample2x
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
    if not native.have_native():
        raise AssertionError(f"[native] {native.SOURCE} did not build or load with g++")
    log(f"[native] built {native.LIBRARY} ({time.perf_counter() - t:.2f} s, "
        f"g++ {' '.join(native.GXX_FLAGS)})")

    t = time.perf_counter()
    h2d = phase_h2d(torch, np)
    log(f"[h2d] {time.perf_counter() - t:.2f} s")

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

    before = launch_counts(["refractory_scan", "bilinear_warp", "upsample2x",
                            "conv_bias_leaky"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    split = []
    with k6_recorder() as k6_rec, k8_recorder() as k8_rec:
        runs = run_chunks(np, fc, em, src, range(2, 2 + N_MEAS), B, U, split)
    wall = time.perf_counter() - t
    k1["launches"], k3["launches"], k6_launches, k8_launches = launches_since(before).values()
    # K6: 5 up levels, K8: 23 convs, of the flow UNet and of each refinement
    # group's UNet
    unets = (1 + _group_split(U, B, MAX_GROUP)[0]) * N_MEAS
    if (len(runs) != N_MEAS or not k1["launches"] or not k3["launches"]
            or k6_launches != 5 * unets or k8_launches != 23 * unets):
        raise AssertionError(
            f"main path ran {len(runs)} chunks, K1 launches {k1['launches']}, "
            f"K3 launches {k3['launches']}, K6 launches {k6_launches} (want {5 * unets}), "
            f"K8 launches {k8_launches} (want {23 * unets})")
    for _, hd in runs:
        fr = hd["outs"]["dvs_frames"]
        if tuple(fr.shape) != (B * U, H, W) or not bool(torch.isfinite(fr).all()):
            raise AssertionError("interpolated frames are not finite [B*U,H,W]")
    n_ev = [len(e) for e, _ in runs]
    rtf = N_MEAS * B / SRC_FPS / wall
    log(f"[fused] {N_MEAS} measured chunks of {B * U} frames at {W}x{H}: "
        f"{wall:.3f} s, {wall / N_MEAS * 1e3:.1f} ms/chunk, realtime factor "
        f"{rtf:.4f}; events/chunk {n_ev}; K1 launches {k1['launches']}, "
        f"K3 launches {k3['launches']}, K6 launches {k6_launches}, K8 launches "
        f"{k8_launches}; warp window {fc.window}")
    sub = [a for a, _ in split]
    col = [b for _, b in split]
    log(f"[fused] per chunk: submit (the host's enqueue, no wait for the device) "
        f"{np.mean(sub) * 1e3:.1f} ms, collect (fetch, which waits for its chunk, + host events) "
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
                "conv3x3_lane": conv3x3_lane, "upsample2x": upsample2x}
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, cli_shapes, run_a_calls = phase_cli(torch, np, tmp, counters)
        log(f"[cli] {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        host_ms = phase_native(np, run_a_calls)
        del run_a_calls
        log(f"[native] {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        phase_h5(np, tmp)
        log(f"[h5] {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        phase_cli_small(torch, np, tmp)
        log(f"[cli-small] {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        syn_launches, syn_calls = phase_synthetic_cli(torch, np, tmp, counters)
        log(f"[cli] runs F, G, H {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        phase_cli_parallel(np, tmp)
        log(f"[cli-parallel] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    gens = phase_synthetic_gens(torch, np, dev)
    log(f"[synthetic-gens] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    thres = phase_thres(torch, np, dev)
    log(f"[thres] {time.perf_counter() - t:.2f} s")

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
    k1["run_f"] = phase_k1_run_f(torch, syn_calls["F"], syn_launches["F"]["refractory_scan"])
    k1["launches_run_f"] = syn_launches["F"]["refractory_scan"]
    log(f"[k1] run F shape {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    k2 = phase_k2(torch, dev, cli_shapes["B"]["scan"], cli_launches["B"]["scan"])
    k2["launches_run_h"] = syn_launches["H"]["scan"]
    k2["run_h"] = phase_k2_run_h(torch, dev, syn_calls["H"], k2["launches_run_h"])
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

    t = time.perf_counter()
    vjp, k3["max_abs_err_train_shape"] = phase_k3_vjp(torch, dev)
    log(f"[k3-vjp] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    train_launches, train_k6 = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        training = phase_train(torch, np, dev, tmp, train_launches, train_k6)
        log(f"[train] {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        phase_train_small(torch, np)
        log(f"[train-small] {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        phase_eval(torch)
        log(f"[eval] {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        phase_batch(torch, np, tmp)
        log(f"[batch] {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        phase_ddd(np, tmp)
        log(f"[ddd] {time.perf_counter() - t:.2f} s")
    vjp["launches"] = train_launches["bilinear_warp_vjp"]
    k3["launches_train"] = train_launches["bilinear_warp"]
    k3["vjp"] = vjp["name"]  # the VJP's numbers are in its own entry

    t = time.perf_counter()
    k6 = phase_k6(torch, dev, [
        (f"CLI run B (noisy, U={RUN_B_U}, as dvs346_noisy_u12)",
         cli_shapes["B"]["upsample2x"], None, (cli_launches["B"]["upsample2x"], None),
         cli_shapes["B"]["chunks"], "chunk"),
        (f"fused chunks B={B} U={U}", Counter(k6_rec.calls), None, (k6_launches, None),
         N_MEAS, "chunk"),
        ("CLI run C (packedz)", cli_shapes["C"]["upsample2x"], None,
         (cli_launches["C"]["upsample2x"], None), cli_shapes["C"]["chunks"], "chunk"),
        (f"train_slomo batch {TRAIN_N} float32", train_k6["upsample2x"],
         train_k6["upsample2x_vjp"],
         (train_launches["upsample2x"], train_launches["upsample2x_vjp"]), TRAIN_STEPS,
         "step"),
    ])
    log(f"[k6] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    k8 = phase_k8(torch, dev, Counter(k8_rec.calls), k8_launches)
    log(f"[k8] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    pixel = phase_pixel(torch, np, dev)
    log(f"[pixel] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    k1_strips = phase_k1_strips(torch, dev, pixel[f"R=0.5ms {W}x{H} S=3"]["launches"])
    log(f"[k1-strips] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    segment = phase_segment(torch, np, dev)
    log(f"[segment] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ddp = phase_ddp(torch, np, dev, tmp)
    log(f"[ddp] {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    phase_dryrun()
    log(f"[dryrun] {time.perf_counter() - t:.2f} s")

    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log("[variants] " + json.dumps({"variants": variants, "resume": resume,
                                    "run_launches": {k: cli_launches[k] for k in "DE"}}))
    log("[synthetic] " + json.dumps({"generators": gens, "thres": thres, "h2d_bytes": h2d,
                                     "run_launches": syn_launches}))
    log("[native] " + json.dumps({"host_cpu": cpu_model(), "functions": host_ms}))
    log("[training] " + json.dumps(training))
    log("[parallel] " + json.dumps({"pixel": pixel, "segment": segment, "ddp": ddp}))
    log(json.dumps({"kernels": [k1, k2, k3, vjp, k4, k5, k6, k8, k1_strips]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
