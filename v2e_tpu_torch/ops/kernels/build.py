"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` exposes plain C functions and is compiled
by nvcc into ``_build/lib<name>.so`` beside the package (a directory that
.gitignore lists), then loaded with ctypes: no PyTorch headers, so a build
takes seconds.  A library is rebuilt when its source is newer.  Stale
sources build in parallel, one nvcc process each.

`ENTRY_POINTS` lists every C function with its parameters; `load` binds a
library's functions once, when it opens it, and `call` is the one way the
kernel wrappers launch them: on a device's current stream, with the error
checked and the launch counted.

Nothing here runs at import time; the first call that needs a kernel
builds it.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from v2e_tpu_torch import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("emulator_scan", "warp", "warp_tiled", "conv3x3", "upsample", "conv_epilogue")

# sm_90a: Hopper.  --fmad=false and no fast math: the kernels must round
# every float operation as written (see the notes in the sources).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# The C entry points of csrc/<library>.cu: name -> (library, parameters).
# One code a parameter, a count repeating it: p a pointer, i int, I unsigned
# int, q long long, f float, s the stream (a pointer, always last).  Each
# returns an int: a cudaError_t (v2e_scan_plan_bytes: a size in bytes).
ENTRY_POINTS: Dict[str, Tuple[str, str]] = {
    "v2e_bilinear_warp": ("warp", "4p 3i q s"),
    "v2e_bilinear_warp_bwd": ("warp", "7p 3i 2q s"),
    "v2e_warp_tiled": ("warp_tiled", "4p 3i q i s"),
    "v2e_conv3x3": ("conv3x3", "4p 7i f 3i s"),
    "v2e_upsample_bilinear2x": ("upsample", "2p 6i s"),
    "v2e_upsample_bilinear2x_vjp": ("upsample", "2p 4i s"),
    "v2e_conv_bias_leaky": ("conv_epilogue", "4p q 2i s"),
    "v2e_refractory_scan_grid": ("emulator_scan", "i 3p"),
    "v2e_refractory_scan": ("emulator_scan", "12p 2i f s"),
    "v2e_refractory_strips_occupancy": ("emulator_scan", "2i p"),
    "v2e_host_device_ptr": ("emulator_scan", "2p"),
    "v2e_refractory_scan_strips": ("emulator_scan", "13p 2i I q 2i f 3i s"),
    "v2e_scan_plan_bytes": ("emulator_scan", ""),
    "v2e_scan": ("emulator_scan", "10p s"),
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "I": ctypes.c_uint,
           "q": ctypes.c_longlong, "f": ctypes.c_float, "s": ctypes.c_void_p}


def parameters(codes: str) -> List[str]:
    """One code per parameter: "2p i s" -> ["p", "p", "i", "s"]."""
    return [c for n, c in re.findall(r"(\d*)([piIqfs])", codes) for _ in range(int(n or 1))]


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# entry point -> (its bound function, whether it takes the stream)
_bound: Dict[str, Tuple[Callable[..., int], bool]] = {}
# ptxas register / spill report of each build, for the smoke script's log
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _paths(name: str):
    return os.path.join(CSRC, name + ".cu"), os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not os.path.isfile(lib) or os.path.getmtime(src) > os.path.getmtime(lib)


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the stale kernels, all nvcc processes started together.

    Returns the wall seconds spent (0.0 when nothing was stale) and prints
    it.  Raises with nvcc's output when a build fails.
    """
    names = [n for n in (names or KERNELS) if _stale(n)]
    if not names:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n in names:
        src, lib = _paths(n)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[n] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, lib,
        )
    failed = []
    for n, (p, tmp, lib) in procs.items():
        out, _ = p.communicate()
        BUILD_LOG[n] = out
        if p.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    dt = time.perf_counter() - t0
    print(f"[v2e_tpu_torch] built {', '.join(names)} with nvcc in {dt:.2f} s",
          file=sys.stderr, flush=True)
    return dt


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if stale, its
    entry points bound from ENTRY_POINTS."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            for entry, (lib_name, codes) in ENTRY_POINTS.items():
                if lib_name == name:
                    fn = getattr(lib, entry)
                    fn.argtypes = [_CTYPES[c] for c in parameters(codes)]
                    fn.restype = ctypes.c_int
                    _bound[entry] = (fn, codes.endswith("s"))
            _libs[name] = lib
        return lib


def entry(name: str) -> Callable[..., int]:
    """The bound C function of entry point `name`, its library loaded
    first."""
    if name not in _bound:
        load(ENTRY_POINTS[name][0])
    return _bound[name][0]


def call(name: str, device, *args, counter: Optional[str] = None) -> None:
    """Call entry point `name` on `device` (a torch.device or an index):
    a tensor passes its data pointer and None a null pointer, and an entry
    point that takes the stream gets the device's current stream last.
    Raises through `check` on a CUDA error; counts one launch under the
    tracing counter `counter`, if given."""
    entry(name)
    fn, streamed = _bound[name]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        if streamed:
            args.append(torch.cuda.current_stream(device).cuda_stream)
        err = fn(*args)
    check(err, name)
    if counter:
        tracing.count(counter)


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
