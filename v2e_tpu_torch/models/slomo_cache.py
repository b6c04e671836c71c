"""Interpolated-frame cache for ``--slomo_use_saved`` (the port's copy of
v2e_tpu/models/slomo_cache.py).

Repeated conversions of the same input with different emulator parameters
(a threshold sweep) spend most of their time in SuperSloMo.  With
``--slomo_use_saved`` the first run records the quantized interpolated
frame stream to an HDF5 cache; later runs with the same input and SloMo
settings replay it straight into the emulator, with no checkpoint load and
no UNet.

The cache key covers everything that shapes the interpolated stream: input
file identity (path, size, mtime), geometry (crop, output size), timing
flags and SloMo settings; it equals the JAX package's for the same
arguments.  Frames are stored as uint8, losslessly: the pipeline's
postprocess step already quantizes to 8-bit levels.  h5py is imported only
when a cache is opened.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1


def cache_key(args, src_frame_interval: float, H: int, W: int) -> str:
    """Hash of every argument that determines the interpolated stream."""
    try:
        st = os.stat(args.input)
        ident = (os.path.abspath(args.input), st.st_size, st.st_mtime)
    except OSError:
        ident = (args.input, 0, 0)
    model = args.slomo_model
    try:
        mt = os.path.getmtime(model)
    except (OSError, TypeError):
        mt = 0
    key = {
        "v": _FORMAT_VERSION,
        "input": ident,
        "model": (model, mt),
        "H": H, "W": W,
        "crop": args.crop,
        "interval": round(src_frame_interval, 9),
        "timestamp_resolution": args.timestamp_resolution,
        "auto_timestamp_resolution": args.auto_timestamp_resolution,
        "batch_size": args.batch_size,
        "start": args.start_time, "stop": args.stop_time,
        "hdr": args.hdr,
    }
    return hashlib.sha256(
        json.dumps(key, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def cache_path_for(args, src_frame_interval: float, H: int, W: int) -> str:
    """Cache file next to the output folder (shared by sweep runs that put
    each probe point in a sibling folder)."""
    parent = os.path.dirname(os.path.abspath(args.output_folder)) or "."
    return os.path.join(
        parent,
        f"slomo-cache-{cache_key(args, src_frame_interval, H, W)}.h5",
    )


class SlomoCacheWriter:
    """Records (frames, times) slices during a staged conversion run."""

    def __init__(self, path: str, H: int, W: int):
        import h5py

        self.path = path
        self._tmp = path + ".tmp"
        self.f = h5py.File(self._tmp, "w")
        self.frames = self.f.create_dataset(
            "frames", shape=(0, H, W), maxshape=(None, H, W),
            dtype=np.uint8, chunks=(64, H, W), compression="gzip",
            compression_opts=1,
        )
        self.times = self.f.create_dataset(
            "times", shape=(0,), maxshape=(None,), dtype=np.float64,
        )
        self.f.attrs["complete"] = False

    def append(self, frames: np.ndarray, times: np.ndarray) -> None:
        n0 = self.frames.shape[0]
        n = frames.shape[0]
        self.frames.resize(n0 + n, axis=0)
        self.frames[n0:] = np.asarray(frames).astype(np.uint8)
        self.times.resize((n0 + n,))
        self.times[n0:] = times

    def finalize(self, avg_upsampling: float) -> None:
        n = self.frames.shape[0]
        self.f.attrs["avg_upsampling"] = float(avg_upsampling)
        self.f.attrs["complete"] = True
        self.f.close()
        os.replace(self._tmp, self.path)  # atomic: partial runs never count
        logger.info(f"saved SloMo frame cache ({n} frames) to {self.path}")

    def abort(self) -> None:
        try:
            self.f.close()
        finally:
            if os.path.exists(self._tmp):
                os.remove(self._tmp)


class SlomoCacheReader:
    """Replays a recorded interpolated stream chunk by chunk."""

    def __init__(self, path: str):
        import h5py

        self.f = h5py.File(path, "r")
        self.n = self.f["frames"].shape[0]
        self.avg_upsampling = float(self.f.attrs.get("avg_upsampling", 0.0))

    @staticmethod
    def usable(path: str) -> bool:
        if not os.path.isfile(path):
            return False
        try:
            import h5py

            with h5py.File(path, "r") as f:
                return bool(f.attrs.get("complete", False))
        except OSError:
            return False

    def chunks(
        self, chunk_size: int
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for s in range(0, self.n, chunk_size):
            yield (
                self.f["frames"][s : s + chunk_size].astype(np.float32),
                self.f["times"][s : s + chunk_size],
            )

    def close(self) -> None:
        self.f.close()
