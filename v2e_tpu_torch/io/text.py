"""RPG-format text event writer (one ``t x y p`` line per event).

A copy of v2e_tpu/io/text.py, format-compatible with the original v2e
writer, including the optional signal(1)/noise(0) label column.
"""
from __future__ import annotations

import atexit
import logging
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


class DVSTextOutput:
    def __init__(self, filepath: str, label_signal_noise: bool = False):
        self.filepath = filepath
        self.numEventsWritten = 0
        self.label_signal_noise = label_signal_noise
        self.flipx = False
        self.flipy = False
        self.sizex = 346
        self.sizey = 260
        self.file = open(filepath, "w")
        # finalize on interpreter exit; close() is idempotent
        atexit.register(self.close)
        self._write_header()

    def _write_header(self) -> None:
        import datetime
        import getpass
        import time as _time

        if not self.label_signal_noise:
            fmt = (
                "# Format is time (float s), x, y, polarity (0=off, 1=on) as "
                "specified at http://rpg.ifi.uzh.ch/davis_data.html\n"
            )
        else:
            fmt = (
                "# Format is time (float s), x, y, polarity (0=off, 1=on), "
                "signal/noise (1/0)\n#  as specified at "
                "http://rpg.ifi.uzh.ch/davis_data.html\n"
            )
        date = datetime.datetime.now().strftime("# Creation time: %I:%M%p %B %d %Y\n")
        tline = "# Creation time: System.currentTimeMillis() {}\n".format(
            int(_time.time() * 1000.0)
        )
        try:
            user = "# User name: {}\n".format(getpass.getuser())
        except Exception:
            user = "# User name: unknown\n"
        for s in (
            "#!events.txt\n",
            "# This is a text DVS created by v2e_tpu_torch\n",
            fmt,
            date,
            tline,
            user,
        ):
            self.file.write(s)

    def appendEvents(
        self, events: np.ndarray, signnoise_label: Optional[np.ndarray] = None
    ) -> None:
        if self.file is None:
            raise Exception("output file closed already")
        if len(events) == 0:
            return
        n = events.shape[0]
        t = events[:, 0].astype(np.float64)
        x = events[:, 1].astype(np.int32)
        if self.flipx:
            x = (self.sizex - 1) - x
        y = events[:, 2].astype(np.int32)
        if self.flipy:
            y = (self.sizey - 1) - y
        p = ((events[:, 3] + 1) / 2).astype(np.int32)
        if signnoise_label is None:
            lines = "\n".join(
                f"{t[i]} {x[i]} {y[i]} {p[i]}" for i in range(n)
            )
        else:
            sn = signnoise_label.astype(np.int32)
            lines = "\n".join(
                f"{t[i]} {x[i]} {y[i]} {p[i]} {sn[i]}" for i in range(n)
            )
        self.file.write(lines + "\n")
        self.numEventsWritten += n

    def close(self) -> None:
        if self.file:
            logger.info(
                f"closing {self.filepath} after writing {self.numEventsWritten} events"
            )
            self.file.close()
            self.file = None

    def cleanup(self) -> None:
        self.close()
