"""Host-side helpers of the CLI: output folders, camera sizes, the lowpass
check and AVI writing (the port's own copies of v2e_tpu/utils)."""

from v2e_tpu_torch.utils.paths import (
    check_add_suffix,
    set_output_folder,
    inputVideoFileDialog,
)
from v2e_tpu_torch.utils.cameras import DVS_SIZES, set_size_from_camera
from v2e_tpu_torch.utils.lowpass import check_lowpass

__all__ = [
    "check_add_suffix",
    "set_output_folder",
    "inputVideoFileDialog",
    "DVS_SIZES",
    "set_size_from_camera",
    "check_lowpass",
]
