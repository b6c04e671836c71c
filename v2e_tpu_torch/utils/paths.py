"""Output folder management and path helpers (a copy of
v2e_tpu/utils/paths.py): unique output folders, suffix checks."""
from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def check_add_suffix(path: str, suffix: str) -> str:
    """Give `path` the extension `suffix`, replacing any other extension."""
    if path.endswith(suffix):
        return path
    return os.path.splitext(path)[0] + suffix


def _non_empty(folder: str) -> bool:
    return os.path.isdir(folder) and len(os.listdir(folder)) > 0


def set_output_folder(
    output_folder: Optional[str],
    input_file: Optional[str],
    unique_output_folder: bool,
    overwrite: bool,
    output_in_place: bool,
) -> str:
    """Resolve and create the output folder: the input's own folder with
    `output_in_place`; a non-empty folder is overwritten with `overwrite`,
    else uniquified with a -1, -2, ... suffix, else refused."""
    if output_in_place and input_file:
        parent = os.path.dirname(os.path.abspath(input_file))
        logger.info(f"writing output in place to {parent}")
        return parent
    folder = output_folder or "v2e-output"
    if _non_empty(folder):
        if overwrite:
            logger.warning(f"overwriting files in non-empty folder {folder}")
        elif unique_output_folder:
            base = folder
            i = 1
            while _non_empty(folder):
                folder = f"{base}-{i}"
                i += 1
            logger.info(f"using unique output folder {folder}")
        else:
            raise SystemExit(
                f"output folder {folder} is not empty; use --overwrite or "
                "--unique_output_folder"
            )
    os.makedirs(folder, exist_ok=True)
    return folder


def inputVideoFileDialog() -> Optional[str]:
    """The original v2e pops a file chooser when no input is given; the
    port runs headless, so it stops with a clear message instead."""
    raise SystemExit(
        "no --input specified and no display available for a file chooser; "
        "pass -i/--input"
    )
