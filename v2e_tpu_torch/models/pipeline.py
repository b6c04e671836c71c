"""The SloMo -> emulator streaming conversion of the CLI (port of
v2e_tpu/models/pipeline.py::run_interpolated_pipeline).

Source frames are cut into overlapping windows of batch_size + 1 frames.
Each window is interpolated U-fold on the device and feeds the emulator
without returning to the host; only the compacted events come back.  Two
ways through a window:

* fused (`FusedConverter`, when nothing on the host needs the
  interpolated frames: no slomo video, SloMo cache or HDF5 sink): one
  `fused_chunk` per window after the first, with U from a one-chunk
  lookahead in auto mode;
* staged (a host consumer of the frames, or the first window): interpolate in
  pair slices (`SuperSloMo.interpolate_batch_slices`, where auto-U and the
  warp window are chosen from the window's own flow), then `submit_batch`.

Up to `DEPTH` chunks are in flight, collected in order by a fetch thread
and a finalize thread (`ChunkPipeline`).

With --slomo_use_saved a first run records the interpolated frames to an
HDF5 cache beside the output folder (every window staged) and a later run
with the same input and SloMo settings replays them into the emulator
with no model (`_replay_cached`).  --slomo_stats_plot writes each chunk's
upsampling factor to slomo-stats.png (matplotlib).
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Iterator, List, Optional

import numpy as np

from v2e_tpu_torch.emulator.pipeline import ChunkPipeline
from v2e_tpu_torch.fused import FusedConverter
from v2e_tpu_torch.models.slomo import SuperSloMo

logger = logging.getLogger(__name__)

# chunks in flight (the JAX package's depth)
DEPTH = 6


def _write_gray(writer, frames: np.ndarray) -> None:
    import cv2

    for fr in frames:
        writer.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))


def run_interpolated_pipeline(
    args,
    frames_iter: Iterator[np.ndarray],
    src_frame_interval: float,
    emulator,
    renderer,
    exposure_mode,
    output_width: int,
    output_height: int,
    stats,
    upsampling_factor: int,
    auto_upsample: bool,
    feed_renderer: Callable,
    device=None,
) -> Optional[SuperSloMo]:
    """Convert `frames_iter` through SloMo and the emulator; returns the
    SloMo engine (its U statistics), or None when a saved stream was
    replayed, and fills `stats`."""
    cache_writer = None
    if args.slomo_use_saved and args.input is not None:
        from v2e_tpu_torch.models.slomo_cache import (
            SlomoCacheReader,
            SlomoCacheWriter,
            cache_path_for,
        )

        cpath = cache_path_for(args, src_frame_interval, output_height, output_width)
        if SlomoCacheReader.usable(cpath):
            logger.info(f"replaying saved SloMo frames from {cpath}")
            _replay_cached(cpath, args, emulator, renderer, exposure_mode,
                           output_width, output_height, stats, feed_renderer)
            return None
        cache_writer = SlomoCacheWriter(cpath, output_height, output_width)
        logger.info(f"recording SloMo frames to {cpath}")

    slomo = SuperSloMo(
        model=args.slomo_model,
        auto_upsample=auto_upsample,
        upsampling_factor=upsampling_factor,
        batch_size=args.batch_size,
        allow_random=args.allow_random_slomo,
        device=device,
        conv_impl=args.unet_conv,
    )

    orig_writer = slomo_writer = None
    if not args.skip_video_output:
        from v2e_tpu_torch.utils.video import video_writer

        if args.vid_orig:
            orig_writer = video_writer(
                os.path.join(args.output_folder, args.vid_orig),
                output_height, output_width, frame_rate=args.avi_frame_rate,
            )
        if args.vid_slomo:
            slomo_writer = video_writer(
                os.path.join(args.output_folder, args.vid_slomo),
                output_height, output_width, frame_rate=args.avi_frame_rate,
            )

    # the fused chunk keeps the interpolated frames on the device and runs
    # the emulator on one device, so it runs only without a mesh and when
    # no host consumer (the slomo video, the SloMo cache, the HDF5 sink's
    # frames) needs them
    fused = (FusedConverter(slomo, emulator)
             if cache_writer is None
             and FusedConverter.usable(slomo, emulator, slomo_writer is not None)
             else None)
    if fused is not None:
        logger.info("using fused conversion chunks")
    pipeline = ChunkPipeline(
        emulator,
        lambda ev, lab, off: feed_renderer(
            renderer, ev, off, exposure_mode, output_height, output_width,
            args.skip_video_output,
        ),
        depth=DEPTH,
    )
    on_collected = fused.note_collected if fused is not None else None
    window: List[np.ndarray] = []
    pair_index = 0  # global index of the window's first pair
    stats_u: List[tuple] = []  # (source time, U) per window

    def note_times(times: np.ndarray, n_out: int) -> None:
        stats.n_frames += n_out
        if stats.first_ts is None:
            stats.first_ts = float(times[0])
        stats.last_ts = float(times[-1])

    def process_window() -> None:
        nonlocal pair_index
        if len(window) < 2:
            return
        chunk = np.stack(window)
        n_pairs = chunk.shape[0] - 1
        if fused is not None:
            n_staged = fused.n_staged
            handle, U, times = fused.submit_window(chunk, pair_index, src_frame_interval)
            pipeline.push_handle(handle, on_collected)
            note_times(times, n_pairs * U)
            if fused.n_staged > n_staged:
                stats.staged_chunks += 1
            else:
                stats.fused_chunks += 1
        else:
            U, slices = slomo.interpolate_batch_slices(chunk, output_height, output_width)
            stats.staged_chunks += 1
            for interp, pair_off in slices:
                n_out = interp.shape[0]
                # output frame k*U+i of pair k sits at source time k + i/U
                times = (pair_index + pair_off
                         + np.arange(n_out, dtype=np.float64) / U) * src_frame_interval
                pipeline.push_handle(emulator.submit_batch(interp, times))
                if slomo_writer is not None or cache_writer is not None:
                    host = interp.to("cpu").numpy().astype(np.uint8)
                    if cache_writer is not None:
                        cache_writer.append(host, times)
                    if slomo_writer is not None:
                        _write_gray(slomo_writer, host)
                note_times(times, n_out)
        stats.upsampling.append(U)
        stats_u.append((pair_index * src_frame_interval, U))
        if orig_writer is not None:
            _write_gray(orig_writer, np.stack(window[:-1]).astype(np.uint8))
        pair_index += n_pairs
        # the last source frame seeds the next window
        last = window[-1]
        window.clear()
        window.append(last)

    try:
        for frame in frames_iter:
            window.append(frame)
            if len(window) >= args.batch_size + 1:
                process_window()
        process_window()
        # the JAX package prewarms its XLA slice programs after the first
        # collected chunk (prewarm_collect); eager PyTorch compiles nothing
    except BaseException:
        if cache_writer is not None:
            cache_writer.abort()  # a partial stream is never replayed
        raise
    finally:
        pipeline.close()
        for writer in (orig_writer, slomo_writer):
            if writer is not None:
                writer.release()
    if cache_writer is not None:
        cache_writer.finalize(slomo.avg_upsampling_factor)
    logger.info(f"SloMo average upsampling factor: {slomo.avg_upsampling_factor:.1f}")
    if args.slomo_stats_plot and stats_u:
        save_slomo_stats_plot(args.output_folder, stats_u)
    return slomo


def _replay_cached(cpath, args, emulator, renderer, exposure_mode, output_width,
                   output_height, stats, feed_renderer) -> None:
    """Feed a recorded interpolated stream straight into the emulator in
    chunks of --chunk_size frames (a --slomo_use_saved run after the
    first: no model, no UNet)."""
    from v2e_tpu_torch.models.slomo_cache import SlomoCacheReader

    reader = SlomoCacheReader(cpath)
    pipeline = ChunkPipeline(
        emulator,
        lambda ev, lab, off: feed_renderer(
            renderer, ev, off, exposure_mode, output_height, output_width,
            args.skip_video_output,
        ),
    )
    slomo_writer = None
    if not args.skip_video_output and args.vid_slomo:
        from v2e_tpu_torch.utils.video import video_writer

        slomo_writer = video_writer(
            os.path.join(args.output_folder, args.vid_slomo),
            output_height, output_width, frame_rate=args.avi_frame_rate,
        )
    try:
        for frames, times in reader.chunks(args.chunk_size):
            pipeline.push(frames, times)
            if slomo_writer is not None:
                _write_gray(slomo_writer, frames.astype(np.uint8))
            stats.n_frames += frames.shape[0]
            if stats.first_ts is None:
                stats.first_ts = float(times[0])
            stats.last_ts = float(times[-1])
    finally:
        pipeline.close()
        reader.close()
        if slomo_writer is not None:
            slomo_writer.release()
    logger.info(f"SloMo average upsampling factor (saved): {reader.avg_upsampling:.1f}")


def save_slomo_stats_plot(output_folder: str, stats_u) -> str:
    """Plot each chunk's upsampling factor against its source time to
    slomo-stats.png in `output_folder` (matplotlib, headless); returns the
    path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t, u = zip(*stats_u)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.step(t, u, where="post")
    ax.set_xlabel("source time (s)")
    ax.set_ylabel("upsampling factor")
    ax.set_title(f"SloMo upsampling (mean {float(np.mean(u)):.1f})")
    path = os.path.join(output_folder, "slomo-stats.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    logger.info(f"wrote SloMo statistics plot to {path}")
    return path
