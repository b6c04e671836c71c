"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and there is no
    CUDA device; the CPU runs only when the caller passes "cpu".
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-d float32 tensor on `like`'s device.

    Elementwise ops take their scalar operands through this: PyTorch's CUDA
    division turns a division by a Python scalar into a multiplication by
    its reciprocal, which rounds differently from the reference's division.
    """
    return torch.tensor(value, dtype=torch.float32, device=like.device)
