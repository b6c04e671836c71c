"""Base class for synthetic input plugins (a copy of
v2e_tpu/synthetic/base.py).

Protocol (reference base_synthetic_input.py:17-105): the constructor takes
``(width, height, avi_path, preview, arg_list, parent_args)``; plugins parse
their own extra CLI arguments from ``arg_list``.  ``next_frame()`` returns
``(frame | None, time_s)`` with frame a [H, W] uint8/float array (y first,
origin upper-left); ``total_frames()`` the expected frame count.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class base_synthetic_input:
    """Prototype synthetic input: a constant background frame."""

    BACKGROUND = 127  # gray level of the background

    def __init__(
        self,
        width: int = 346,
        height: int = 260,
        avi_path: Optional[str] = None,
        preview: bool = False,
        arg_list: Optional[List[str]] = None,
        parent_args: Optional[argparse.Namespace] = None,
    ) -> None:
        self.width = width
        self.height = height
        self.avi_path = avi_path
        self.preview = preview  # headless environments: no-op
        self.args = arg_list
        self.parent_args = parent_args
        self.t_total = None
        self.time = 0.0
        self.frame_number = 0
        self.bg = base_synthetic_input.BACKGROUND
        self.pix_arr: np.ndarray = self.bg * np.ones(
            (self.height, self.width), dtype=np.uint8
        )
        self.log = sys.stdout
        self.video_writer = None
        if avi_path is not None:
            from v2e_tpu_torch.utils.video import video_writer

            if not avi_path.endswith("avi"):
                avi_path = avi_path + ".avi"
            self.video_writer = video_writer(avi_path, height, width, frame_rate=30)
            logger.info(f"writing synthetic input frame video to {avi_path}")

    def total_frames(self) -> int:
        """Total number of frames this input will produce."""
        return 0

    def next_frame(self) -> Tuple[Optional[np.ndarray], float]:
        """Return (frame, time) or (None, last_time) when finished."""
        return (self.pix_arr, self.time)

    def write_video_frame(self, frame: Optional[np.ndarray] = None) -> None:
        if self.video_writer is not None:
            import cv2

            img = frame if frame is not None else self.pix_arr
            self.video_writer.write(
                cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR)
            )

    def cleanup(self) -> None:
        if self.video_writer is not None:
            logger.info(f"closing AVI output file {self.avi_path}")
            self.video_writer.release()
            self.video_writer = None
