"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C function and is compiled
by nvcc into ``_build/lib<name>.so`` beside the package (a directory that
.gitignore lists), then loaded with ctypes: no PyTorch headers, so a build
takes seconds.  A library is rebuilt when its source is newer.  Stale
sources build in parallel, one nvcc process each.

Nothing here runs at import time; the first call that needs a kernel
builds it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("emulator_scan", "warp")

# sm_90a: Hopper.  --fmad=false and no fast math: the kernels must round
# every float operation as written (see the notes in the sources).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
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
    """The loaded library of kernel `name`, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
