"""AEDAT-2.0 (jAER) event file writer.

The port's copy of v2e_tpu/io/aedat2.py, byte-compatible with the
original v2e writer: an ASCII header of
``#``-prefixed CRLF lines followed by big-endian ``int32 address, int32
timestamp`` pairs, timestamps in microseconds.  Address bit layouts per
camera follow the inivation AEDAT-2.0 spec and jAER chip classes:

* 346x260 / 240x180 (DAVIS): y<<22 | x<<12 | pol<<11
* 640x480 (DVS640):          y<<11 | x<<1  | pol

x and y are flipped (jAER uses lower-left origin), and noise events can be
labeled by setting the special-event bit 10.  The words are packed by the
port's native library when it builds (`native.pack_aedat2`), else by
`pack_aedat2_numpy`, its plain version.
"""
from __future__ import annotations

import atexit
import logging
from typing import Optional

import numpy as np

from v2e_tpu_torch import native, tracing

logger = logging.getLogger(__name__)


def pack_aedat2_numpy(events: np.ndarray, sizex: int, sizey: int, xshift: int,
                      yshift: int, polshift: int, flipx: bool, flipy: bool,
                      noise_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """The (address, timestamp) int32 pairs [2N] of `native.pack_aedat2`,
    in numpy, with x and y mirrored each on its own flag; bit 10 is set
    where `noise_mask` is 0."""
    t = (1e6 * events[:, 0]).astype(np.int32)
    x = events[:, 1].astype(np.int32)
    y = events[:, 2].astype(np.int32)
    if flipx:
        x = (sizex - 1) - x
    if flipy:
        y = (sizey - 1) - y
    p = ((events[:, 3] + 1) / 2).astype(np.int32)
    a = x << xshift | y << yshift | p << polshift
    if noise_mask is not None:
        a[np.logical_not(noise_mask.astype(bool))] |= AEDat2Output.NOISE_SPECIAL_EVENT_BIT
    out = np.empty(2 * events.shape[0], dtype=np.int32)
    out[0::2] = a
    out[1::2] = t
    return out


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

        mask = signnoise_label if self.label_signal_noise else None
        if np.any(np.diff(events[:, 0]) < 0):
            logger.warning("nonmonotonic timestamp in AEDAT-2 output")
        args = (events, self.sizex, self.sizey, self.xShiftBits, self.yShiftBits,
                self.polShiftBits)
        if self.flipx == self.flipy and native.have_native():
            out = native.pack_aedat2(*args, self.flipx, mask)
        else:
            tracing.count("numpy.pack_aedat2")
            out = pack_aedat2_numpy(*args, self.flipx, self.flipy, mask)
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
        on = int(np.count_nonzero(events[:, 3] > 0))
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
