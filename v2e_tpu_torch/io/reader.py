"""Video and image-folder input with crop, resize and luma conversion (a
copy of v2e_tpu/io/reader.py): cv2 video decode or an ordered folder of
image files, an optional (left, right, top, bottom) crop, INTER_AREA resize
to the output size, and BGR -> gray."""
from __future__ import annotations

import logging
import os
from typing import Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".pgm")


class ImageFolderReader:
    """An ordered folder of frames behind cv2.VideoCapture's read/release."""

    def __init__(self, folder: str):
        import cv2

        files = [f for f in sorted(os.listdir(folder)) if f.lower().endswith(IMG_EXTENSIONS)]
        if not files:
            raise ValueError(f"no image files found in {folder}")
        self.files = [os.path.join(folder, f) for f in files]
        self.num_frames = len(self.files)
        self.idx = 0
        probe = cv2.imread(self.files[0])
        self.frame_height, self.frame_width = probe.shape[:2]

    def read(self):
        import cv2

        if self.idx >= self.num_frames:
            return False, None
        frame = cv2.imread(self.files[self.idx])
        self.idx += 1
        return True, frame

    def release(self) -> None:
        pass


def open_video_input(path: str, input_frame_rate: Optional[float] = None):
    """Open a video file or image folder; returns (cap, fps, n_frames, w, h)."""
    import cv2

    if os.path.isdir(path):
        if input_frame_rate is None:
            raise ValueError(
                "--input_frame_rate must be set when the input is a folder of images"
            )
        cap = ImageFolderReader(path)
        return cap, input_frame_rate, cap.num_frames, cap.frame_width, cap.frame_height
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"could not open video input {path}")
    fps = cap.get(cv2.CAP_PROP_FPS)
    if input_frame_rate is not None:
        logger.info(f"overriding video metadata frame rate {fps} with {input_frame_rate}")
        fps = input_frame_rate
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    return cap, fps, n, w, h


def luma_frames(
    cap,
    output_width: Optional[int],
    output_height: Optional[int],
    crop: Optional[Tuple[int, int, int, int]] = None,
    start_frame: int = 0,
    stop_frame: Optional[int] = None,
    hdr: bool = False,
) -> Iterator[np.ndarray]:
    """Yield gray frames, cropped and resized to the output size: uint8,
    or float32 for HDR input."""
    import cv2

    idx = 0
    while stop_frame is None or idx < stop_frame:
        ret, frame = cap.read()
        if not ret or frame is None:
            break
        idx += 1
        if idx <= start_frame:
            continue
        if frame.ndim == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        if crop is not None:
            left, right, top, bottom = crop
            h, w = frame.shape
            frame = frame[top: h - bottom if bottom else h, left: w - right if right else w]
        if output_width is not None and output_height is not None and (
            frame.shape[1] != output_width or frame.shape[0] != output_height
        ):
            frame = cv2.resize(frame, (output_width, output_height), interpolation=cv2.INTER_AREA)
        yield frame if frame.dtype == np.uint8 and not hdr else frame.astype(np.float32)
