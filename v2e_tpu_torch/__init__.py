"""v2e_tpu_torch — the PyTorch/CUDA port of v2e_tpu (DVS event-camera
simulation) for NVIDIA Hopper.

The command line is ``python -m v2e_tpu_torch -i <video or image folder>``
or ``--synthetic_input <generator module>`` (cli.py), with v2e's flags.
The package mirrors v2e_tpu's layout (ops/, emulator/, models/, io/,
render/, synthetic/, analysis/, utils/, fused.py, args.py) and keeps its
public layouts ([F,H,W] frames, [N,2,H,W] flow), so
every ported function can be held against its JAX counterpart.  The TPU's
Pallas kernels become CUDA C++ kernels under csrc/, built with nvcc on first
use and bound through ctypes (ops/kernels/).  Each kernel wrapper runs its
plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors.

Entry points run on "cuda" unless the caller passes device="cpu"; with no
CUDA device they raise instead of carrying on on the CPU.

The library API is v2e_tpu's: ``from v2e_tpu_torch import EventEmulator``
(examples/library_embedding.py).
"""

__version__ = "0.1.0"

from v2e_tpu_torch.device import resolve_device
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.emulator import EventEmulator


def __getattr__(name):
    # SloMo and the renderer load on first use, so `import v2e_tpu_torch`
    # stays cheap
    if name == "SuperSloMo":
        from v2e_tpu_torch.models.slomo import SuperSloMo

        return SuperSloMo
    if name in ("EventRenderer", "ExposureMode"):
        from v2e_tpu_torch.render import renderer

        return getattr(renderer, name)
    raise AttributeError(f"module 'v2e_tpu_torch' has no attribute {name!r}")


__all__ = [
    "EmulatorConfig",
    "EventEmulator",
    "SuperSloMo",
    "EventRenderer",
    "ExposureMode",
    "__version__",
    "resolve_device",
]
