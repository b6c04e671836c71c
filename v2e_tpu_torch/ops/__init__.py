"""The DVS pixel model's elementwise math in PyTorch (port of
v2e_tpu/ops/), and under kernels/ the CUDA kernels' wrappers."""

from v2e_tpu_torch.ops.core import (
    lin_log,
    rescale_intensity_frame,
    low_pass_filter,
    subtract_leak_current,
    compute_event_map,
    generate_shot_noise,
    refractory_filter,
)
from v2e_tpu_torch.ops.noise import compute_photoreceptor_noise_voltage

__all__ = [
    "lin_log",
    "rescale_intensity_frame",
    "low_pass_filter",
    "subtract_leak_current",
    "compute_event_map",
    "generate_shot_noise",
    "refractory_filter",
    "compute_photoreceptor_noise_voltage",
]
