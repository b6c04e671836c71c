"""HDF5 event database writer, DDD-style layout (the port's copy of
v2e_tpu/io/hdf5.py), with the datasets of the original v2e emulator:

* ``events``: uint32 [N,4] — (t_us, x, y, p(0/1)), gzip, appendable
* optional DDD frame storage: ``frame`` uint8 [F,H,W], ``frame_ts`` uint32
  [F] (us), ``frame_idx`` uint64 [F] (event index at each frame)
"""
from __future__ import annotations

import atexit
import logging
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class DVSH5Output:
    """Appends events, and with `prepare_frame_storage` the source frames
    (--ddd_output), to one HDF5 file.  h5py is imported when a file is
    opened, so the package imports without it."""

    def __init__(self, filepath: str):
        import h5py

        self.filepath = filepath
        self.file = h5py.File(filepath, "w")
        # finalize on interpreter exit; close() is idempotent
        atexit.register(self.close)
        self.events_dataset = self.file.create_dataset(
            name="events",
            shape=(0, 4),
            maxshape=(None, 4),
            dtype="uint32",
            compression="gzip",
        )
        self.frame_dataset = None
        self.frame_ts_dataset = None
        self.frame_ev_idx_dataset = None
        self.numEventsWritten = 0
        self._frame_counter = 0

    def prepare_frame_storage(
        self,
        n_frames: Optional[int],
        frame_ts: Optional[Sequence[float]],
        height: int,
        width: int,
    ) -> None:
        """Create the DDD-style frame datasets.

        ``n_frames``/``frame_ts`` may be None for streaming pipelines where
        the frame count isn't known up front: the datasets then grow as
        frames arrive and timestamps come from appendFrame.
        """
        n0 = n_frames or 0
        self.frame_dataset = self.file.create_dataset(
            name="frame", shape=(n0, height, width),
            maxshape=(None, height, width), dtype="uint8", compression="gzip",
        )
        if frame_ts is not None:
            ts_us = (np.asarray(frame_ts, dtype=np.float64) * 1e6).astype(np.uint32)
        else:
            ts_us = np.zeros(n0, np.uint32)
        self.frame_ts_dataset = self.file.create_dataset(
            name="frame_ts", shape=(n0,), maxshape=(None,), data=ts_us,
            dtype="uint32", compression="gzip",
        )
        self.frame_ev_idx_dataset = self.file.create_dataset(
            name="frame_idx", shape=(n0,), maxshape=(None,), dtype="uint64",
            compression="gzip",
        )

    def appendFrame(
        self,
        frame: np.ndarray,
        ts: Optional[float] = None,
        ev_idx: Optional[int] = None,
    ) -> None:
        """Append a frame; ``ev_idx`` is the cumulative event count INCLUDING
        this frame's events (the event dataset's size once they are
        stored)."""
        if self.frame_dataset is None:
            self._frame_counter += 1
            return
        k = self._frame_counter
        if k >= self.frame_dataset.shape[0]:
            self.frame_dataset.resize(k + 1, axis=0)
            self.frame_ts_dataset.resize(k + 1, axis=0)
            self.frame_ev_idx_dataset.resize(k + 1, axis=0)
        self.frame_dataset[k] = np.clip(frame, 0, 255).astype(np.uint8)
        if ts is not None:
            self.frame_ts_dataset[k] = np.uint32(ts * 1e6)
        self.frame_ev_idx_dataset[k] = (
            ev_idx if ev_idx is not None else self.numEventsWritten
        )
        self._frame_counter += 1

    def appendEvents(
        self, events: np.ndarray, signnoise_label: Optional[np.ndarray] = None
    ) -> None:
        if len(events) == 0:
            return
        tmp = np.empty((events.shape[0], 4), dtype=np.float64)
        tmp[:, 0] = events[:, 0] * 1e6
        tmp[:, 1:] = events[:, 1:]
        tmp[tmp[:, 3] == -1, 3] = 0
        tmp_u32 = tmp.astype(np.uint32)
        n0 = self.events_dataset.shape[0]
        self.events_dataset.resize(n0 + tmp_u32.shape[0], axis=0)
        self.events_dataset[n0:] = tmp_u32
        self.numEventsWritten += tmp_u32.shape[0]

    def close(self) -> None:
        if self.file is not None:
            logger.info(
                f"closing {self.filepath} after writing {self.numEventsWritten} events"
            )
            self.file.close()
            self.file = None

    def cleanup(self) -> None:
        self.close()
