"""AVI video writing (a copy of v2e_tpu/utils/video.py)."""
from __future__ import annotations


def video_writer(output_path: str, height: int, width: int, frame_rate: int = 30):
    """A cv2 XVID VideoWriter of BGR frames."""
    import cv2

    fourcc = cv2.VideoWriter_fourcc(*"XVID")
    return cv2.VideoWriter(output_path, fourcc, frame_rate, (width, height))
