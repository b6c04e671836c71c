"""The v2e command-line conversion on the port (port of v2e_tpu/cli.py):

    python -m v2e_tpu_torch -i <video file or image folder> [v2e flags]
    python -m v2e_tpu_torch --synthetic_input scripts.moving_dot [v2e flags]

Same flags and defaults as the JAX package's CLI (args.py).  Source frames
are read with cv2 (an image folder needs --input_frame_rate), cropped,
resized and converted to luma, then either interpolated with SuperSloMo
and emulated chunk by chunk (models/pipeline.py), or with --disable_slomo
fed straight to the emulator (`_run_direct`).  Events go to the AEDAT-2,
AEDAT-4, text and HDF5 sinks (--ddd_output adds the frames to the HDF5
file) and the DVS video renderer; the pixel variants (--scidvs,
--cs_lambda_pixels), the single-pixel probe and the model-state videos go
to the emulator, and --resume_state / --checkpoint_state load the
emulator's state before the conversion and save it after.  A synthetic
input (synthetic/) is a generator class named by module path; its frames
go straight to the emulator, rendered on the device chunk by chunk when no
input AVI is written (`_run_synthetic`).  --devices N > 1 runs the
emulator over a mesh of N cards (`_make_mesh_from_args`): image rows in
strips (--parallel_mode pixel) or time segments (segment).  --slomo_use_saved records the
interpolated frames on a first run and replays them on later ones, and
--slomo_stats_plot plots each chunk's upsampling factor
(models/pipeline.py).

Runs on the CUDA device; `main(argv, device="cpu")` runs the plain PyTorch
versions of the kernels on the CPU (the tests do).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import sys
import time
from typing import List, Optional

import numpy as np

from v2e_tpu_torch.args import (
    SmartFormatter,
    log_layout_flags,
    v2e_args,
    v2e_check_dvs_exposure_args,
    write_args_info,
)
from v2e_tpu_torch.device import resolve_device
from v2e_tpu_torch.emulator import EventEmulator
from v2e_tpu_torch.render import EventRenderer, ExposureMode
from v2e_tpu_torch.utils.cameras import set_size_from_camera
from v2e_tpu_torch.utils.lowpass import check_lowpass
from v2e_tpu_torch.utils.paths import set_output_folder

logger = logging.getLogger(__name__)


class UsageError(ValueError):
    """A command line the port cannot run: `code` is the exit status (1
    without an input)."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


def get_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="v2e_tpu_torch: convert video to realistic synthetic DVS "
        "events (PyTorch/CUDA)",
        formatter_class=SmartFormatter,
        allow_abbrev=True,
    )
    return v2e_args(parser).parse_known_args(argv)


@dataclasses.dataclass
class Stats:
    """What a conversion did, filled as it runs."""

    t0: float = dataclasses.field(default_factory=time.time)
    n_frames: int = 0
    first_ts: Optional[float] = None
    last_ts: Optional[float] = None
    fused_chunks: int = 0
    staged_chunks: int = 0
    upsampling: List[int] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    realtime_factor: Optional[float] = None
    num_events: int = 0


def _feed_renderer(renderer, events, offsets, exposure_mode, height, width, skip_video):
    if skip_video or renderer is None or events is None or not len(events):
        return
    if exposure_mode == ExposureMode.SOURCE and offsets is not None:
        for f in range(len(offsets) - 1):
            ev = events[offsets[f]: offsets[f + 1]]
            if len(ev):
                renderer.render_events_to_frames(ev, height, width)
    else:
        renderer.render_events_to_frames(events, height, width)


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """The command line: 0 on success, else a UsageError's exit code (1
    without an input)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    try:
        run(argv, device)
    except UsageError as e:
        logger.error(str(e))
        return e.code
    return 0


def run(argv: Optional[List[str]] = None, device=None) -> Stats:
    """Parse `argv` and convert; returns the run's `Stats`.  Raises
    UsageError for a missing input."""
    args, other_args = get_args(argv)
    if args.input is None and args.synthetic_input is None:
        raise UsageError("specify --input video file or image folder, or "
                         "--synthetic_input module", 1)
    log_layout_flags(args)
    dev = resolve_device(device)

    output_folder = set_output_folder(
        args.output_folder, args.input, args.unique_output_folder,
        args.overwrite, args.output_in_place,
    )
    args.output_folder = output_folder
    write_args_info(args, output_folder, other_args, " ".join(sys.argv))
    output_width, output_height = set_size_from_camera(args)
    exposure = v2e_check_dvs_exposure_args(args)

    def convert() -> Stats:
        if args.synthetic_input is not None:
            return _run_synthetic(args, other_args, output_folder, output_width,
                                  output_height, exposure, dev)
        return _run_video(args, output_folder, output_width, output_height, exposure, dev)

    if not args.profile:
        return convert()
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    from v2e_tpu_torch import tracing

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace_dir = os.path.join(output_folder, "torch-trace")
    os.makedirs(trace_dir, exist_ok=True)
    logger.info(f"capturing a torch.profiler trace to {trace_dir}")
    with profile(activities=activities) as prof:
        stats = convert()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump(tracing.export(tracing.drain()), f)
    return stats


def _make_mesh_from_args(args, output_height, device):
    """The conversion's mesh for --devices > 1: (mesh or None, parallel
    mode, pad rows).

    --devices clamps to the visible CUDA cards, with the JAX CLI's warning;
    for a run on the CPU the strips or segments all take the CPU, standing
    in for JAX's virtual CPU devices.  Pixel mode splits the rows over the
    mesh's 'spatial' axis; when H does not divide, inert pad rows
    (EmulatorConfig.pad_rows) round it up, except for CSDVS, whose surround
    would couple into them: it takes the largest divisor of H instead."""
    from v2e_tpu_torch.parallel.convert import make_segment_mesh
    from v2e_tpu_torch.parallel.mesh import Mesh, mesh_devices

    devices = args.devices or 1
    if devices <= 1:
        return None, "pixel", 0
    if device.type == "cuda" and device.index is None:
        import torch

        avail = torch.cuda.device_count()
        if devices > avail:
            logger.warning(f"--devices {devices} > {avail} available; using {avail}")
            devices = avail
        if devices <= 1:
            return None, "pixel", 0
    if args.parallel_mode == "segment":
        return make_segment_mesh(devices, device), "segment", 0

    H = output_height or 260
    pad = (-H) % devices
    if pad and args.cs_lambda_pixels:
        s = max(d for d in range(1, devices + 1) if H % d == 0)
        if s <= 1:
            logger.warning(f"--devices {devices}: CSDVS forbids row padding and no "
                           f"divisor of height {H} > 1; running single-device")
            return None, "pixel", 0
        if s < devices:
            logger.warning(f"--devices {devices}: CSDVS forbids row padding; height "
                           f"{H} shards over {s} devices, {devices - s} idle")
        devices, pad = s, 0
    if pad:
        logger.info(f"padding height {H} -> {H + pad} with inert rows to shard "
                    f"evenly over {devices} devices")
    return Mesh([mesh_devices(devices, device)], ("data", "spatial")), "pixel", pad


def _make_emulator(args, output_folder, output_width, output_height, device) -> EventEmulator:
    mesh, parallel_mode, pad_rows = _make_mesh_from_args(args, output_height, device)
    em = EventEmulator(
        mesh=mesh,
        parallel_mode=parallel_mode,
        pad_rows=pad_rows,
        segment_warmup=args.segment_warmup,
        pos_thres=args.pos_thres,
        neg_thres=args.neg_thres,
        sigma_thres=args.sigma_thres,
        cutoff_hz=args.cutoff_hz,
        leak_rate_hz=args.leak_rate_hz,
        refractory_period_s=args.refractory_period,
        shot_noise_rate_hz=args.shot_noise_rate_hz,
        photoreceptor_noise=args.photoreceptor_noise,
        leak_jitter_fraction=args.leak_jitter_fraction,
        noise_rate_cov_decades=args.noise_rate_cov_decades,
        seed=args.dvs_emulator_seed,
        output_folder=output_folder,
        dvs_h5=args.dvs_h5,
        dvs_aedat2=args.dvs_aedat2,
        dvs_aedat4=args.dvs_aedat4,
        dvs_text=args.dvs_text,
        output_width=output_width,
        output_height=output_height,
        device=device,
        hdr=args.hdr,
        label_signal_noise=args.label_signal_noise,
        shuffle_events_within_iteration=not args.no_shuffle,
        compaction_capacity_hint=args.compaction_capacity,
        scidvs=args.scidvs,
        cs_lambda_pixels=args.cs_lambda_pixels,
        cs_tau_p_ms=args.cs_tau_p_ms,
        show_dvs_model_state=args.show_dvs_model_state,
        save_dvs_model_state=args.save_dvs_model_state,
        record_single_pixel_states=args.record_single_pixel_states,
    )
    if args.dvs_params is not None:
        em.set_dvs_params(args.dvs_params)
    if args.ddd_output and em.dvs_h5 is not None:
        em.prepare_storage(None, None)  # frame datasets that grow as frames arrive
    elif args.ddd_output:
        logger.warning("--ddd_output requires --dvs_h5; ignoring")
    if args.resume_state:
        em.load_state(args.resume_state)
    return em


def _make_renderer(args, output_folder, exposure) -> Optional[EventRenderer]:
    if args.skip_video_output or args.dvs_vid is None:
        return None
    mode, value, area_dimension = exposure
    return EventRenderer(
        full_scale_count=args.dvs_vid_full_scale,
        output_path=output_folder,
        dvs_vid=args.dvs_vid,
        exposure_mode=mode,
        exposure_value=value if value is not None else 1 / 300.0,
        area_dimension=area_dimension,
        avi_frame_rate=args.avi_frame_rate,
    )


def _finish(args, emulator, renderer, stats: Stats) -> Stats:
    if args.checkpoint_state:
        try:
            emulator.save_state(args.checkpoint_state)
        except RuntimeError as e:
            logger.warning(f"could not checkpoint emulator state: {e}")
    emulator.cleanup()
    if renderer is not None:
        renderer.cleanup()
    wall = time.time() - stats.t0
    dur = (stats.last_ts - stats.first_ts
           if stats.first_ts is not None and stats.last_ts is not None else 0.0)
    total = emulator.num_events_total
    npix = (emulator.output_width or 1) * (emulator.output_height or 1)
    stats.wall_s, stats.num_events = wall, total
    logger.info(
        f"processed {stats.n_frames} frames ({dur:.3f}s of DVS time) in "
        f"{wall:.2f}s wall ({stats.n_frames / max(wall, 1e-9):.1f} fr/s)"
    )
    if dur > 0:
        logger.info(
            f"events: {total:,} total ({emulator.num_events_on:,} on, "
            f"{emulator.num_events_off:,} off); rates {total / dur / 1e6:.3f} Meps, "
            f"{total / dur / npix:.3f} Hz/pixel"
        )
        if wall > 0:
            stats.realtime_factor = dur / wall
            logger.info(
                f"realtime factor: {dur / wall:.3f}x "
                f"({'faster' if dur > wall else 'slower'} than real time)"
            )
    logger.info(f"outputs are in {args.output_folder}")
    return stats


def _run_video(args, output_folder, output_width, output_height, exposure, device) -> Stats:
    from v2e_tpu_torch.io.reader import luma_frames, open_video_input

    cap, src_fps, _, in_w, in_h = open_video_input(args.input, args.input_frame_rate)
    if output_width is None or output_height is None:
        output_width, output_height = in_w, in_h
        if args.crop is not None:
            left, right, top, bottom = args.crop
            output_width -= left + right
            output_height -= top + bottom
    src_frame_interval = (1.0 / src_fps) / args.input_slowmotion_factor
    start_frame = int(args.start_time * src_fps) if args.start_time is not None else 0
    stop_frame = int(args.stop_time * src_fps) if args.stop_time is not None else None

    use_slomo = not args.disable_slomo
    upsampling_factor, auto_upsample = 2, True
    if use_slomo and args.timestamp_resolution is not None:
        auto_upsample = bool(args.auto_timestamp_resolution)
        upsampling_factor = max(
            int(math.ceil(src_frame_interval / args.timestamp_resolution)), 2
        )
        check_lowpass(args.cutoff_hz, upsampling_factor / src_frame_interval)
    elif not use_slomo:
        check_lowpass(args.cutoff_hz, 1.0 / src_frame_interval)

    emulator = _make_emulator(args, output_folder, output_width, output_height, device)
    renderer = _make_renderer(args, output_folder, exposure)
    stats = Stats()
    frames_iter = luma_frames(
        cap, output_width, output_height, crop=args.crop,
        start_frame=start_frame, stop_frame=stop_frame, hdr=args.hdr,
    )
    mode = exposure[0]
    try:
        if not use_slomo:
            _run_direct(args, frames_iter, src_frame_interval, emulator, renderer,
                        mode, output_width, output_height, stats)
        else:
            from v2e_tpu_torch.models.pipeline import run_interpolated_pipeline

            run_interpolated_pipeline(
                args, frames_iter, src_frame_interval, emulator, renderer, mode,
                output_width, output_height, stats,
                upsampling_factor=upsampling_factor, auto_upsample=auto_upsample,
                feed_renderer=_feed_renderer, device=device,
            )
    finally:
        cap.release()
    return _finish(args, emulator, renderer, stats)


def _run_synthetic(args, other_args, output_folder, output_width, output_height,
                   exposure, device) -> Stats:
    """--synthetic_input: the generator's frames go straight into the
    emulator.  With no input AVI to write, a generator that has
    `device_frames` renders each chunk on `device` and only the chunk's
    times travel there; otherwise `next_frame`'s host frames are stacked
    into chunks of --chunk_size."""
    from tqdm import tqdm

    from v2e_tpu_torch.synthetic import load_synthetic_input

    if output_width is None or output_height is None:
        output_width, output_height = 346, 260
    cls = load_synthetic_input(args.synthetic_input)
    avi_path = (None if args.skip_video_output or args.vid_orig is None
                else os.path.join(output_folder, args.vid_orig))
    syn = cls(width=output_width, height=output_height, avi_path=avi_path,
              preview=False, arg_list=other_args, parent_args=args)

    emulator = _make_emulator(args, output_folder, output_width, output_height, device)
    renderer = _make_renderer(args, output_folder, exposure)
    stats = Stats()
    pipeline = _make_pipeline(args, emulator, renderer, exposure[0], output_width,
                              output_height)
    pbar = tqdm(total=syn.total_frames(), desc="synthetic", unit="fr")
    try:
        if avi_path is None and hasattr(syn, "device_frames"):
            times = np.asarray(syn.times, dtype=np.float64)
            stats.first_ts, stats.last_ts = float(times[0]), float(times[-1])
            stats.n_frames = len(times)
            for s in range(0, len(times), args.chunk_size):
                blk = times[s: s + args.chunk_size]
                pipeline.push(syn.device_frames(blk, device), blk)
                pbar.update(len(blk))
        else:
            _push_frames(pipeline, _host_frames(syn), args.chunk_size, stats, pbar)
    finally:
        pipeline.close()
        pbar.close()
        syn.cleanup()
    return _finish(args, emulator, renderer, stats)


def _make_pipeline(args, emulator, renderer, exposure_mode, width, height):
    """The emulator's chunk pipeline, its events fed to the renderer."""
    from v2e_tpu_torch.emulator.pipeline import ChunkPipeline

    return ChunkPipeline(
        emulator,
        lambda ev, lab, off: _feed_renderer(
            renderer, ev, off, exposure_mode, height, width, args.skip_video_output
        ),
    )


def _host_frames(syn):
    """`syn.next_frame()`'s (frame, time) pairs up to its end."""
    while True:
        frame, t = syn.next_frame()
        if frame is None:
            return
        yield np.asarray(frame), float(t)


def _push_frames(pipeline, frames_and_times, chunk_size: int, stats: Stats,
                 pbar=None) -> None:
    """(frame, time) pairs, stacked into chunks of `chunk_size` frames and
    pushed into `pipeline`."""
    chunk: List[np.ndarray] = []
    times: List[float] = []

    def flush():
        if chunk:
            pipeline.push(np.stack(chunk), np.array(times, dtype=np.float64))
            chunk.clear()
            times.clear()

    for frame, t in frames_and_times:
        if stats.first_ts is None:
            stats.first_ts = t
        stats.last_ts = t
        stats.n_frames += 1
        chunk.append(frame)
        times.append(t)
        if len(chunk) >= chunk_size:
            flush()
        if pbar is not None:
            pbar.update(1)
    flush()


def _run_direct(args, frames_iter, frame_interval, emulator, renderer,
                exposure_mode, width, height, stats: Stats) -> None:
    """--disable_slomo: source frames go straight into the emulator, in
    chunks of --chunk_size frames."""
    pipeline = _make_pipeline(args, emulator, renderer, exposure_mode, width, height)
    try:
        _push_frames(pipeline, ((frame, idx * frame_interval)
                                for idx, frame in enumerate(frames_iter)),
                     args.chunk_size, stats)
    finally:
        pipeline.close()


if __name__ == "__main__":
    sys.exit(main())
