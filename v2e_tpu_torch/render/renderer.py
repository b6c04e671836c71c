"""Accumulate AER event packets into histogram frames and write AVI video
(a copy of v2e_tpu/render/renderer.py with its numpy paths), in the four
exposure modes of the original v2e renderer:

* DURATION: fixed exposure time per frame;
* COUNT: fixed number of events per frame;
* AREA_COUNT: a frame ends when any NxN pixel area has M events;
* SOURCE: one DVS frame per event packet.

The histogram and the AREA_COUNT scan run in the port's native library
(v2e_tpu_torch/native) when it builds, else in numpy
(`accumulate_histogram_numpy`, `area_count_scan_numpy`, the plain
versions).
"""
from __future__ import annotations

import logging
import os
from enum import Enum
from typing import Optional

import numpy as np

from v2e_tpu_torch import native, tracing
from v2e_tpu_torch.utils.paths import check_add_suffix
from v2e_tpu_torch.utils.video import video_writer

logger = logging.getLogger(__name__)


class ExposureMode(Enum):
    DURATION = 1
    COUNT = 2
    AREA_COUNT = 3
    SOURCE = 4


def accumulate_histogram(
    frame: np.ndarray, events: np.ndarray, full_scale: float
) -> None:
    """Add this packet's ON-OFF event histogram into ``frame`` (float32) in
    place, then clip to +-full_scale."""
    if not len(events):
        np.clip(frame, -full_scale, full_scale, out=frame)
    elif native.have_native():
        native.hist2d_accumulate(frame, events, full_scale)
    else:
        tracing.count("numpy.hist2d_accumulate")
        accumulate_histogram_numpy(frame, events, full_scale)


def accumulate_histogram_numpy(
    frame: np.ndarray, events: np.ndarray, full_scale: float
) -> None:
    """The numpy version of `accumulate_histogram`."""
    H, W = frame.shape
    ev = np.asarray(events, dtype=np.float64)
    if ev.shape[0]:
        x = ev[:, 1].astype(np.int64)
        y = ev[:, 2].astype(np.int64)
        ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        flat = y[ok] * W + x[ok]
        sign = np.where(ev[ok, 3] > 0, 1.0, -1.0)
        frame += np.bincount(
            flat, weights=sign, minlength=H * W
        ).reshape(H, W).astype(np.float32)
    np.clip(frame, -full_scale, full_scale, out=frame)


class EventRenderer:
    """Stateful incremental renderer: feed event packets, frames come out."""

    def __init__(
        self,
        full_scale_count: int = 3,
        output_path: Optional[str] = None,
        dvs_vid: Optional[str] = None,
        preview: bool = False,  # accepted for parity; headless no-op
        exposure_mode: ExposureMode = ExposureMode.DURATION,
        exposure_value: float = 1 / 300.0,
        area_dimension: Optional[int] = None,
        frame_times_suffix: str = "-frame_times.txt",
        avi_frame_rate: int = 30,
    ):
        self.exposure_mode = exposure_mode
        self.exposure_value = exposure_value
        self.output_path = output_path
        self.width: Optional[int] = None
        self.height: Optional[int] = None
        self.full_scale_count = full_scale_count
        self.dvs_frame_times_suffix = frame_times_suffix
        self.avi_frame_rate = avi_frame_rate
        self.preview = preview

        self.frame_rate_hz = None
        self.event_count = None
        self.frameIntervalS = None
        self.area_counts: Optional[np.ndarray] = None
        self.area_count = None
        self.area_dimension = area_dimension
        if exposure_mode == ExposureMode.DURATION:
            self.frame_rate_hz = 1.0 / exposure_value
            self.frameIntervalS = exposure_value
        elif exposure_mode == ExposureMode.COUNT:
            self.event_count = int(exposure_value)
        elif exposure_mode == ExposureMode.AREA_COUNT:
            self.area_count = int(exposure_value)
        elif exposure_mode == ExposureMode.SOURCE:
            pass
        else:
            raise ValueError(f"unknown exposure mode {exposure_mode}")

        self.video_output_file_name = dvs_vid
        self.video_output_file = None
        self.frame_times_output_file = None
        self.numFramesWritten = 0
        self.currentFrameStartTime: Optional[float] = None
        self.currentFrame: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def _check_outputs_open(self) -> None:
        if self.video_output_file is not None:
            return
        if not self.height or not self.width:
            raise ValueError("height and width not set for output video")
        if self.output_path and isinstance(self.video_output_file_name, str):
            fn = check_add_suffix(
                os.path.join(self.output_path, self.video_output_file_name), ".avi"
            )
            logger.info("opening DVS video output file " + fn)
            self.video_output_file = video_writer(
                fn, self.height, self.width, frame_rate=self.avi_frame_rate
            )
            fn = check_add_suffix(
                os.path.join(self.output_path, self.video_output_file_name),
                self.dvs_frame_times_suffix,
            )
            self.frame_times_output_file = open(fn, "w")
            self.frame_times_output_file.write(
                "# frame times for {}\n# frame# time(s)\n".format(
                    self.video_output_file_name
                )
            )

    # ------------------------------------------------------------------
    def render_events_to_frames(
        self,
        event_arr: np.ndarray,
        height: int,
        width: int,
        return_frames: bool = False,
    ) -> Optional[np.ndarray]:
        """Incrementally render a packet of events into DVS frames.

        Returns stacked finished frames [n,h,w] in 0-1 range when
        return_frames is set, else None.
        """
        self.width = width
        self.height = height
        self._check_outputs_open()

        if event_arr is None or event_arr.shape[0] == 0:
            return None

        ts = event_arr[:, 0]
        num_events = len(ts)

        if self.exposure_mode == ExposureMode.DURATION:
            if self.currentFrameStartTime is None:
                self.currentFrameStartTime = float(ts[0])
        if self.exposure_mode == ExposureMode.AREA_COUNT and self.area_counts is None:
            nw = 1 + self.width // self.area_dimension
            nh = 1 + self.height // self.area_dimension
            self.area_counts = np.zeros((nw, nh), dtype=np.int64)

        returned = []
        this_frame_idx = 0
        done = False
        self.currentFrame = None  # accumulate from scratch per packet

        while not done:
            if self.exposure_mode == ExposureMode.DURATION:
                next_start = self.currentFrameStartTime + self.frameIntervalS
                start = int(np.searchsorted(ts, self.currentFrameStartTime, "left"))
                end = int(np.searchsorted(ts, next_start, "right"))
            elif self.exposure_mode == ExposureMode.COUNT:
                start = this_frame_idx
                end = start + self.event_count
            elif self.exposure_mode == ExposureMode.AREA_COUNT:
                start = this_frame_idx
                end = self._area_count_scan(event_arr, start)
            else:  # SOURCE
                start, end = 0, num_events

            if end >= num_events - 1:
                done = True
                end = num_events - 1  # reference quirk: final event held over

            self._accumulate(event_arr[start:end])

            if not done or self.exposure_mode == ExposureMode.SOURCE:
                if self.exposure_mode == ExposureMode.DURATION:
                    self.currentFrameStartTime += self.frameIntervalS
                elif self.exposure_mode in (
                    ExposureMode.COUNT,
                    ExposureMode.AREA_COUNT,
                ):
                    this_frame_idx = end

                img = (self.currentFrame + self.full_scale_count) / (
                    self.full_scale_count * 2.0
                )
                self.currentFrame = None
                if return_frames:
                    returned.append(img)
                self._write_frame(img, ts, start, end)

        if return_frames and returned:
            return np.stack(returned)
        return None

    # ------------------------------------------------------------------
    def _accumulate(self, events: np.ndarray) -> None:
        if self.currentFrame is None:
            self.currentFrame = np.zeros((self.height, self.width), dtype=np.float32)
        accumulate_histogram(self.currentFrame, events, self.full_scale_count)

    def _area_count_scan(self, events: np.ndarray, start: int) -> int:
        args = (events, start, self.area_dimension, self.area_count, self.area_counts)
        if native.have_native():
            return native.area_count_scan(*args)
        tracing.count("numpy.area_count_scan")
        return area_count_scan_numpy(*args)

    def _write_frame(self, img: np.ndarray, ts, start: int, end: int) -> None:
        if self.video_output_file is None:
            return
        import cv2

        self.video_output_file.write(
            cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_GRAY2BGR)
        )
        if self.exposure_mode == ExposureMode.SOURCE:
            t = float(ts[0]) if len(ts) else float("nan")
        elif self.exposure_mode in (ExposureMode.COUNT, ExposureMode.AREA_COUNT):
            t = (float(ts[start]) + float(ts[min(end, len(ts) - 1)])) / 2
        else:
            t = self.currentFrameStartTime + self.frameIntervalS / 2
        self.frame_times_output_file.write(
            "{}\t{:10.6f}\n".format(self.numFramesWritten, t)
        )
        self.numFramesWritten += 1

    # ------------------------------------------------------------------
    def cleanup(self) -> None:
        if self.video_output_file is not None:
            logger.info(
                f"closing DVS video output after writing {self.numFramesWritten} frames"
            )
            self.video_output_file.release()
            self.video_output_file = None
        if self.frame_times_output_file is not None:
            self.frame_times_output_file.close()
            self.frame_times_output_file = None


def area_count_scan_numpy(events: np.ndarray, start: int, area_dimension: int,
                          area_count: int, counts: np.ndarray) -> int:
    """The numpy version of `native.area_count_scan`: count events from
    `start` into `counts` [nw,nh] by area until one reaches `area_count`;
    returns that event's index (counts reset to 0) or N."""
    nw, nh = counts.shape
    for i in range(start, events.shape[0]):
        ax = int(events[i, 1] // area_dimension)
        ay = int(events[i, 2] // area_dimension)
        if 0 <= ax < nw and 0 <= ay < nh:
            counts[ax, ay] += 1
            if counts[ax, ay] >= area_count:
                counts[:] = 0
                return i
    return events.shape[0]
