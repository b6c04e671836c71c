"""DVS camera size presets (a copy of v2e_tpu/utils/cameras.py)."""
from __future__ import annotations

from typing import Optional, Tuple

DVS_SIZES = {
    "dvs128": (128, 128),
    "dvs240": (240, 180),
    "dvs346": (346, 260),
    "dvs640": (640, 480),
    "dvs1024": (1024, 768),
}


def set_size_from_camera(args) -> Tuple[Optional[int], Optional[int]]:
    """(width, height) from the --dvsXXX flags, else the explicit
    --output_width/--output_height."""
    for name, (w, h) in DVS_SIZES.items():
        if getattr(args, name, False):
            return w, h
    return args.output_width, args.output_height
