"""The conversion cells: source frames through the port's CLI pipeline to
an AEDAT-2 file, SuperSloMo on (models/pipeline.py's
run_interpolated_pipeline, fused chunks after the first) or off
(cli._run_direct), as `python -m v2e_tpu_torch` runs them.

The load is a closed loop: the pipeline takes frames from the source as
fast as it consumes them.  The source iterator is the benchmark's clock:
* set-up ends when the first WARM_CHUNKS chunks (the staged first chunk
  and one of the steady shape) have reached the sink; the window starts
  there and closes at the first chunk boundary `seconds` later;
* a chunk is handed over when the iterator yields its last frame, and done
  when the emulator's collect_finalize (events materialized and written to
  the AEDAT-2 file) returns for it.

Host ranges (trace.HostRanges) are recorded around the emulator's
submit_batch / submit_batch_fused ("submit"), collect_fetch and
collect_finalize, through wrappers on the emulator instance.  With
--trace the profiler records the device from the window's start for
TRACE_SECONDS.

Correctness (after the window, the program's state freed): the reference
(reference/emulator.py, float64) runs the first WARM_CHUNKS chunks from
the first frame, and every `check_every`-th chunk after them from the
program's state at that chunk's start (its base, lowpass, last spike times
and time, copied as the chunk is submitted).  Compared:
* events_mismatch: per chunk, pixel and polarity, |program - reference|
  event counts summed, over the reference's events; the program's events
  are read back from the AEDAT-2 file and binned into chunks by time;
* state_mismatch: the share of pixels whose base or lowpass, after a
  checked chunk of the reference, differs by more than 1e-3 (log units,
  1/200 of a threshold) from the program's at the next chunk's start (the
  state the reference skips between checked chunks);
* frames_mean_abs_dn (SuperSloMo cells): the mean absolute difference, in
  8-bit levels, between the program's interpolated frames and the
  reference's (reference/slomo.py, float32), on `frame_chunks` of the
  checked chunks inside the window.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List

import numpy as np

from portbench import traffic
from portbench.trace import TRACE_SECONDS, Profile
from portbench.yardstick import snap32

# the staged first chunk and one of the steady shape: set-up ends when both
# have reached the sink
WARM_CHUNKS = 2

PIXEL_FLAGS = {  # configuration key -> the CLI's flag
    "pos_thres": "--pos_thres", "neg_thres": "--neg_thres", "sigma_thres": "--sigma_thres",
    "cutoff_hz": "--cutoff_hz", "leak_rate_hz": "--leak_rate_hz",
    "shot_noise_rate_hz": "--shot_noise_rate_hz", "refractory_period_s": "--refractory_period",
    "leak_jitter_fraction": "--leak_jitter_fraction",
    "noise_rate_cov_decades": "--noise_rate_cov_decades",
}


def emulator_seed(seed: int) -> int:
    """The emulator's generator seed (never 0, which the port takes as
    'fresh entropy')."""
    return seed % ((1 << 63) - 1) + 1


def pixel_config(run) -> dict:
    """The DVS pixel parameters of the cell: the configuration's, with the
    cell's `pixel` preset values over them."""
    px = dict(run.config["dvs"])
    px.update(run.cell.get("pixel", {}))
    return px


class Shape:
    """Where chunks start and end in the source stream."""

    def __init__(self, cell: dict, config: dict, interval: float):
        self.slomo = bool(cell["slomo"])
        self.interval = interval
        if self.slomo:
            self.pairs = int(config["batch_pairs"])  # the CLI's --batch_size
            self.U = int(cell["upsampling"])
        else:
            self.frames = int(cell["chunk_frames"])

    def last_frame(self, c: int) -> int:
        """Source index of chunk c's last frame."""
        return self.pairs * (c + 1) if self.slomo else self.frames * (c + 1) - 1

    def first_new_frame(self, c: int) -> int:
        """Source index of the first frame chunk c adds (a SuperSloMo chunk
        also takes the previous chunk's last frame)."""
        return self.pairs * c + 1 if self.slomo else self.frames * c

    def source_s(self) -> float:
        """Seconds of source one chunk converts."""
        return (self.pairs if self.slomo else self.frames) * self.interval

    def times(self, c: int) -> np.ndarray:
        """Absolute times of chunk c's emulated frames (chunk 0 also has the
        first frame, which starts the emulator)."""
        if self.slomo:
            n = self.pairs * self.U
            return (self.pairs * c + np.arange(n) / self.U) * self.interval
        return (self.frames * c + np.arange(self.frames)) * self.interval

    def src_frames(self, c: int) -> range:
        """Source indices of the frames chunk c takes."""
        return (range(self.pairs * c, self.pairs * (c + 1) + 1) if self.slomo
                else range(self.frames * c, self.frames * (c + 1)))


def checked(c: int, warm: int, every: int, phase: int) -> bool:
    return c >= warm and (c - warm) % every == phase


def run(run) -> None:
    import torch

    cell, cfg = run.cell, run.config
    H, W = int(cfg["height"]), int(cfg["width"])
    dev = torch.device(run.device)
    src = traffic.make_source(cell["source"], H, W, run.seed)
    shape = Shape(cell, cfg, src.frame_interval)
    warm = WARM_CHUNKS
    every = int(cell["check"]["check_every"])
    phase = traffic.seed_rng(run.seed, "check").integers(every)
    out_dir = os.path.join(run.tmpdir, "out")
    seed = emulator_seed(run.seed)

    argv = ["--output_folder", out_dir, "--overwrite", "--unique_output_folder", "false",
            "--skip_video_output", "--dvs_aedat2", "events.aedat",
            "--output_width", str(W), "--output_height", str(H),
            "--dvs_emulator_seed", str(seed)]
    for key, flag in PIXEL_FLAGS.items():
        argv += [flag, repr(float(cfg["dvs"][key]))]
    if cell.get("dvs_params"):
        argv += ["--dvs_params", cell["dvs_params"]]
    weights = None
    if shape.slomo:
        from portbench.weights import make_slomo_weights, save_checkpoint

        dtype = getattr(torch, cfg["unet_dtype"])
        weights = make_slomo_weights(run.seed, int(cfg["base"]), dev, dtype)
        ckpt = save_checkpoint(os.path.join(run.tmpdir, "slomo.ckpt"), *weights)
        argv += ["--slomo_model", ckpt, "--batch_size", str(shape.pairs),
                 "--unet_conv", cfg["unet_conv"]]
    else:
        argv += ["--disable_slomo", "--chunk_size", str(shape.frames)]

    from v2e_tpu_torch import cli

    args, _ = cli.get_args(argv)
    args.output_folder = out_dir
    os.makedirs(out_dir, exist_ok=True)
    em = cli._make_emulator(args, out_dir, W, H, dev)

    host = run.host
    subs: List[Dict] = []  # per chunk, in submission order
    done_ns: List[int] = []
    warm_done = threading.Event()

    def snapshot():
        st = em.state
        if st is None:
            return None
        return {"base": st.base_log_frame.clone(), "lp": st.lp_log_frame.clone(),
                "mem": st.timestamp_mem.clone(), "t_prev": st.t_prev.clone(),
                "t_origin": em.t_origin}

    def before_submit():
        c = len(subs)
        rec = {"c": c}
        if checked(c, warm, every, phase) or checked(c - 1, warm, every, phase):
            rec["state"] = snapshot()
        return rec

    orig_submit, orig_fused = em.submit_batch, em.submit_batch_fused
    orig_fetch, orig_finalize = em.collect_fetch, em.collect_finalize

    def submit_batch(frames, times):
        rec = before_submit()
        t = time.perf_counter_ns()
        handle = orig_submit(frames, times)
        host.add("submit", t, time.perf_counter_ns())
        if shape.slomo and (rec["c"] < warm or checked(rec["c"], warm, every, phase)):
            rec["frames_u8"] = torch.as_tensor(frames).to(dev).to(torch.uint8)
        subs.append(rec)
        return handle

    def submit_batch_fused(*a, **k):
        rec = before_submit()
        t = time.perf_counter_ns()
        handle = orig_fused(*a, **k)
        host.add("submit", t, time.perf_counter_ns())
        if rec["c"] < warm or checked(rec["c"], warm, every, phase):
            rec["frames_u8"] = handle["outs"]["dvs_frames"].to(torch.uint8)
        subs.append(rec)
        return handle

    def collect_finalize(handle, packed):
        t = time.perf_counter_ns()
        out = orig_finalize(handle, packed)
        end = time.perf_counter_ns()
        host.add("collect_finalize", t, end)
        done_ns.append(end)
        if len(done_ns) >= warm:
            warm_done.set()
        return out

    em.submit_batch = submit_batch
    em.submit_batch_fused = submit_batch_fused
    em.collect_fetch = host.wrap("collect_fetch", orig_fetch)
    em.collect_finalize = collect_finalize

    prof = Profile(dev.type) if run.trace else None
    trace_s = TRACE_SECONDS
    handover: Dict[int, int] = {}
    device_sync = torch.cuda.synchronize if dev.type == "cuda" else None

    def frames_iter():
        i = 0
        c_next = warm  # the next chunk whose first frame is awaited
        while True:
            if i == shape.first_new_frame(c_next):
                if c_next == warm:
                    if not warm_done.wait(timeout=1200):
                        raise RuntimeError("the warm-up chunks never reached the sink")
                    if prof is not None:
                        prof.start()  # before the window: its start-up is slow
                    if device_sync is not None:
                        device_sync()
                    run.window_start_ns = time.perf_counter_ns()
                    if prof is not None:
                        prof.start_ns = run.window_start_ns
                else:
                    now = time.perf_counter_ns()
                    if prof is not None and now - run.window_start_ns >= trace_s * 1e9:
                        prof.stop()
                    if now - run.window_start_ns >= run.seconds * 1e9:
                        run.window_end_ns = now
                        if prof is not None:
                            prof.stop()
                        return
                c_next += 1
            c = max(i - 1, 0) // shape.pairs if shape.slomo else i // shape.frames
            if i == shape.last_frame(c):
                handover[c] = time.perf_counter_ns()
            yield src.frame(i)
            i += 1

    stats = cli.Stats()
    try:
        if shape.slomo:
            from v2e_tpu_torch.models.pipeline import run_interpolated_pipeline

            run_interpolated_pipeline(
                args, frames_iter(), shape.interval, em, None, None, W, H, stats,
                upsampling_factor=shape.U, auto_upsample=False,
                feed_renderer=cli._feed_renderer, device=dev)
        else:
            cli._run_direct(args, frames_iter(), shape.interval, em, None, None, W, H, stats)
    finally:
        if prof is not None:
            prof.stop()
        em.cleanup()
    if device_sync is not None:
        device_sync()
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if prof is not None:
        run.trace_data = prof.reduce()

    ws, we = run.window_start_ns, run.window_end_ns
    in_window = [c for c, t in handover.items() if ws <= t < we]
    run.attempted = len(in_window)
    run.failed = sum(1 for c in in_window if c >= len(done_ns))
    run.records["handover_ns"] = [handover.get(c) for c in range(len(subs))]
    run.records["done_ns"] = list(done_ns)
    run.counts["chunk_source_s"] = shape.source_s()
    run.counts["chunk_frames"] = shape.pairs * shape.U if shape.slomo else shape.frames
    run.counts["pairs"] = shape.pairs if shape.slomo else 0
    run.counts["upsampling"] = shape.U if shape.slomo else 0
    run.counts["unet_hw"] = (snap32(H), snap32(W))
    run.counts["base"] = int(cfg.get("base", 0))
    run.counts["chunks"] = len(subs)
    run.counts["hw"] = (H, W)
    run.counts["pixel"] = pixel_config(run)

    aedat = os.path.join(out_dir, "events.aedat")
    del em
    t = time.perf_counter()
    check(run, shape, src, subs, weights, aedat, pixel_config(run), seed, warm, every, phase)
    run.counts["check_s"] = time.perf_counter() - t


def chunk_of_events(t_us: np.ndarray, last_times: np.ndarray) -> np.ndarray:
    """Chunk index of each event: an event at or before a chunk's last frame
    time (with float32 rounding of up to 0.48 us in the program's times)
    belongs to it; the next chunk's events come at least one sub-step
    later."""
    bounds = np.floor(last_times * 1e6 + 0.48).astype(np.int64) + 1
    return np.searchsorted(bounds, t_us, side="right")


def check(run, shape, src, subs, weights, aedat, px, seed, warm, every, phase) -> None:
    import torch

    from portbench.reference.aedat2 import read_events
    from portbench.reference.emulator import PixelArray, PixelConfig

    dev = torch.device(run.device)
    H, W = int(run.config["height"]), int(run.config["width"])
    n_chunks = len(subs)
    t_us, x, y, on = read_events(aedat, W, H)
    last_times = np.array([shape.times(c)[-1] for c in range(n_chunks)])
    cidx = chunk_of_events(t_us, last_times)
    order = np.argsort(cidx, kind="stable")  # in time order already, unless broken
    cidx, x, y, on = cidx[order], x[order], y[order], on[order]
    starts = np.searchsorted(cidx, np.arange(n_chunks + 1), side="left")

    def prog_counts(c):
        sl = slice(starts[c], starts[c + 1])
        key = (on[sl].astype(np.int64) * H + y[sl]) * W + x[sl]
        n = np.bincount(key, minlength=2 * H * W)
        n = torch.from_numpy(n.reshape(2, H, W)).to(dev)
        return n[1], n[0]  # ON, OFF

    ref = PixelArray(PixelConfig.from_dict(px), seed, dev)
    diff_sum = ref_sum = 0
    state_bad = state_n = 0
    frames_err, frames_n = 0.0, 0
    frame_chunks = int(run.cell["check"].get("frame_chunks", 0))
    ws, we = run.window_start_ns, run.window_end_ns
    handover = run.records["handover_ns"]

    def frames_of(c):
        if shape.slomo:
            return subs[c]["frames_u8"]
        return torch.from_numpy(np.stack([src.frame(i) for i in shape.src_frames(c)])).to(dev)

    for c in range(n_chunks):
        times = shape.times(c)
        if c < warm or checked(c, warm, every, phase):
            frames = frames_of(c)
            if c == 0:
                ref.start(frames[0], float(times[0]))
                frames, times = frames[1:], times[1:]
            elif c >= warm:
                st = subs[c]["state"]
                ref.load(st["base"], st["lp"], st["mem"], st["t_origin"],
                         float(shape.times(c - 1)[-1]))
            r_on, r_off = ref.run_chunk(frames, times)
            p_on, p_off = prog_counts(c)
            diff_sum += int((p_on - r_on).abs().sum() + (p_off - r_off).abs().sum())
            ref_sum += int(r_on.sum() + r_off.sum())
            nxt = subs[c + 1]["state"] if c + 1 < n_chunks and "state" in subs[c + 1] else None
            if c >= warm and nxt is not None:
                bad = ((ref.base - nxt["base"].double()).abs() > 1e-3) | \
                      ((ref.lp - nxt["lp"].double()).abs() > 1e-3)
                state_bad += int(bad.sum())
                state_n += bad.numel()
            if (shape.slomo and c >= warm and frames_n < frame_chunks
                    and handover[c] is not None and ws <= handover[c] < we):
                from portbench.reference.slomo import interpolate_chunk

                src_c = torch.from_numpy(np.stack([src.frame(i) for i in shape.src_frames(c)])).to(dev)
                flow_w, interp_w = weights
                want = interpolate_chunk(flow_w, interp_w, src_c, shape.U)
                frames_err += float((subs[c]["frames_u8"].float() - want).abs().mean())
                frames_n += 1
        else:
            ref.noise.chunk(len(times), (H, W))  # the port draws this chunk's noise too
    limits = run.cell["check"]["limits"]
    run.checks["events_mismatch"] = {"value": diff_sum / max(ref_sum, 1),
                                     "limit": limits["events_mismatch"]}
    run.checks["state_mismatch"] = {"value": state_bad / max(state_n, 1) if state_n else None,
                                    "limit": limits["state_mismatch"]}
    if shape.slomo:
        run.checks["frames_mean_abs_dn"] = {"value": frames_err / frames_n if frames_n else None,
                                            "limit": limits["frames_mean_abs_dn"]}
    run.counts["events_reference"] = ref_sum
    run.counts["events_written"] = int(t_us.shape[0])
