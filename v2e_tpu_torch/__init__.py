"""v2e_tpu_torch — the PyTorch/CUDA port of v2e_tpu (DVS event-camera
simulation) for NVIDIA Hopper.

The package mirrors v2e_tpu's layout (ops/, emulator/, models/, io/,
fused.py) and keeps its public layouts ([F,H,W] frames, [N,2,H,W] flow), so
every ported function can be held against its JAX counterpart.  The TPU's
Pallas kernels become CUDA C++ kernels under csrc/, built with nvcc on first
use and bound through ctypes (ops/kernels/).  Each kernel wrapper runs its
plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors.

Entry points run on "cuda" unless the caller passes device="cpu"; with no
CUDA device they raise instead of carrying on on the CPU.
"""
from v2e_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
