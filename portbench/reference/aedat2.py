"""Read an AEDAT-2.0 file (jAER's format, inivation's spec): '#' header
lines ending in CRLF, then big-endian int32 (address, timestamp in us)
pairs.  For the DAVIS346 and DAVIS240 the address is y<<22 | x<<12 |
pol<<11, with x and y mirrored (jAER's origin is the lower left)."""
from __future__ import annotations

import numpy as np


def read_events(path: str, width: int = 346, height: int = 260):
    """(t_us int64, x int64, y int64, on bool) of every event in the file."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while data[pos:pos + 1] == b"#":
        pos = data.index(b"\n", pos) + 1
    words = np.frombuffer(data, dtype=">i4", offset=pos).astype(np.int64)
    addr, t = words[0::2], words[1::2]
    x = (width - 1) - ((addr >> 12) & 0x3FF)
    y = (height - 1) - ((addr >> 22) & 0x1FF)
    on = ((addr >> 11) & 1).astype(bool)
    return t, x, y, on
