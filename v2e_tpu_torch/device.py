"""Device selection for the port's entry points."""
from __future__ import annotations

import functools
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


def upload(x, device: torch.device) -> torch.Tensor:
    """`x` (an array or a tensor) on `device`, without waiting for the
    stream.  A host array bound for a CUDA device is first copied into
    pinned memory (`host_copy`), so the caller may overwrite `x` as soon as
    this returns, and then copied to the card asynchronously; PyTorch's
    pinned allocator keeps the staging block until that copy has run.  (A
    blocking copy from pageable memory would wait for all the work queued
    on the stream.)"""
    t = torch.as_tensor(x)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return host_copy(t).to(device, non_blocking=True)


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of the CPU tensor `t`, in pinned memory where CUDA is
    available.  The bytes are copied by memoryview assignment, which keeps
    the interpreter lock: with a copy that releases it (`Tensor.pin_memory`)
    the threads that collect chunks took the lock, and a DAVIS346
    conversion's submitting thread waited 2.4-3.9 ms a chunk to get it back
    (one H100)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=torch.cuda.is_available())
    memoryview(_bytes(out))[:] = memoryview(_bytes(t.contiguous()))
    return out


def _bytes(t: torch.Tensor):
    """The bytes of a contiguous CPU tensor, as a numpy array that shares
    them."""
    return t.reshape(-1).view(torch.uint8).numpy()


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-d float32 tensor on `like`'s device.

    Elementwise ops take their scalar operands through this: PyTorch's CUDA
    division turns a division by a Python scalar into a multiplication by
    its reciprocal, which rounds differently from the reference's division.
    The tensor is made once per value and device and shared, so callers
    must not write to it: making one on a CUDA device copies from the host
    and waits for the stream, which would stall a loop over frames.
    """
    return _scalar(float(value), like.device)


@functools.lru_cache(maxsize=None)
def _scalar(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)
