"""AEDAT-2.0 (jAER) event file writer.

A numpy copy of v2e_tpu/io/aedat2.py (its g++ packing path is not ported
yet), byte-compatible with the original v2e writer: an ASCII header of
``#``-prefixed CRLF lines followed by big-endian ``int32 address, int32
timestamp`` pairs, timestamps in microseconds.  Address bit layouts per
camera follow the inivation AEDAT-2.0 spec and jAER chip classes:

* 346x260 / 240x180 (DAVIS): y<<22 | x<<12 | pol<<11
* 640x480 (DVS640):          y<<11 | x<<1  | pol

x and y are flipped (jAER uses lower-left origin), and noise events can be
labeled by setting the special-event bit 10.
"""
from __future__ import annotations

import atexit
import logging
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


class AEDat2Output:
    """Streams AER events to an AEDAT-2.0 file."""

    SUPPORTED_SIZES = ((346, 260), (240, 180), (640, 480))
    NOISE_SPECIAL_EVENT_BIT = 1 << 10

    def __init__(
        self,
        filepath: str,
        output_width: int = 346,
        output_height: int = 260,
        label_signal_noise: bool = False,
    ):
        self.filepath = filepath
        self.file = None
        # finalize on interpreter exit; close() is idempotent
        atexit.register(self.close)
        self.label_signal_noise = label_signal_noise
        if (output_width, output_height) in ((346, 260), (240, 180)):
            self.yShiftBits, self.xShiftBits, self.polShiftBits = 22, 12, 11
        elif (output_width, output_height) == (640, 480):
            self.yShiftBits, self.xShiftBits, self.polShiftBits = 11, 1, 0
        else:
            raise ValueError(
                f"AEDAT-2.0 output size {output_width}x{output_height} not "
                f"supported; use one of {self.SUPPORTED_SIZES}"
            )
        self.sizex = output_width
        self.sizey = output_height
        self.flipx = True
        self.flipy = True
        self.numEventsWritten = 0
        self.numOnEvents = 0
        self.numOffEvents = 0
        self.file = open(filepath, "wb")
        self._write_header()

    def _write_header(self) -> None:
        import datetime
        import getpass
        import time as _time

        date = datetime.datetime.now().strftime(
            "# Creation time: %I:%M%p %B %d %Y\r\n"
        )
        tline = "# Creation time: System.currentTimeMillis() {}\r\n".format(
            int(_time.time() * 1000.0)
        )
        try:
            user = "# User name: {}\r\n".format(getpass.getuser())
        except Exception:
            user = "# User name: unknown\r\n"
        sn = (
            "# noise events are labeled as addressed external input events when "
            "the --label_signal_noise option is selected for output\r\n"
            if self.label_signal_noise
            else ""
        )
        header = (
            "#!AER-DAT2.0\r\n",
            "# This is a raw AE data file created by v2e_tpu_torch "
            "as specified at https://inivation.com/support/software/fileformat/#aedat-20\r\n",
            "# Data format is int32 address, int32 timestamp (8 bytes total), "
            "repeated for each event\r\n",
            "# Timestamps tick is 1 us\r\n",
            sn,
            date,
            tline,
            user,
        )
        for s in header:
            self.file.write(s.encode("UTF-8"))

    def appendEvents(
        self, events: np.ndarray, signnoise_label: Optional[np.ndarray] = None
    ) -> None:
        """Append ``[N,4] = [t(s), x, y, p(+-1)]`` events."""
        if self.file is None or len(events) == 0:
            return
        n = events.shape[0]

        t = (1e6 * events[:, 0]).astype(np.int32)
        if np.any(np.diff(t) < 0):
            logger.warning("nonmonotonic timestamp in AEDAT-2 output")
        x = events[:, 1].astype(np.int32)
        if self.flipx:
            x = (self.sizex - 1) - x
        y = events[:, 2].astype(np.int32)
        if self.flipy:
            y = (self.sizey - 1) - y
        p = ((events[:, 3] + 1) / 2).astype(np.int32)

        a = x << self.xShiftBits | y << self.yShiftBits | p << self.polShiftBits
        if self.label_signal_noise and signnoise_label is not None:
            noise_mask = np.logical_not(signnoise_label.astype(bool))
            a[noise_mask] |= self.NOISE_SPECIAL_EVENT_BIT

        out = np.empty(2 * n, dtype=np.int32)
        out[0::2] = a
        out[1::2] = t
        data = out.byteswap().tobytes(order="C")  # jAER is Java big-endian
        if self.numEventsWritten == 0:
            # jAER would misparse a file whose first data byte is '#'
            while data[0:1] == b"#":
                logger.warning(
                    "first event would write a '#' comment char, dropping it"
                )
                data = data[8:]
                n -= 1
        self.file.write(data)
        self.numEventsWritten += n
        on = int(np.count_nonzero(p))
        self.numOnEvents += on
        self.numOffEvents += n - on
        self.file.flush()

    def close(self) -> None:
        if self.file:
            logger.info(
                f"closing {self.filepath} after writing {self.numEventsWritten} "
                f"events ({self.numOnEvents} on, {self.numOffEvents} off)"
            )
            self.file.close()
            self.file = None

    # reference API alias
    def cleanup(self) -> None:
        self.close()
