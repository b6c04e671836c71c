"""DDD17/DDD20 driving-dataset HDF5 reading (DAVIS caer packet streams); a
copy of v2e_tpu/io/ddd.py, numpy and h5py only.

Recordings store raw caer packets in an HDF5 ``dvs/data`` table (the
original v2e's ddd20_utils/ddd_h5_reader.py and ddd20_interfaces/caer.py
read them); each row is (sys_ts, header, payload) with the 28-byte caer
header describing the packet type.  Polarity packets hold uint32 (addr,
ts_us) pairs with DAVIS346 bit layout (pol bit 1, y bits 2-16, x bits
17+); frame packets hold a 36-byte header + uint16 APS image.  h5py is
imported when a file opens.

The live-camera TCP interfaces of the original are not ported.
"""
from __future__ import annotations

import logging
import struct
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

DVS_SHAPE = (260, 346)  # DAVIS346B

HEADER_FIELDS = (
    "etype", "esource", "esize", "eoffset", "eoverflow", "ecapacity",
    "enumber", "evalid",
)

EVENT_TYPES = {
    0: "special_event",
    1: "polarity_event",
    2: "frame_event",
    3: "imu6_event",
    4: "imu9_event",
}


def unpack_header(header_raw: bytes) -> Dict:
    """Decode the 28-byte caer packet header."""
    vals = struct.unpack("hhiiiiii", header_raw)
    obj = dict(zip(HEADER_FIELDS, vals))
    obj["etype"] = EVENT_TYPES.get(obj["etype"], obj["etype"])
    return obj


def unpack_events(packet: Dict, rotate180: bool = True):
    """Polarity packet -> (first_ts_s, [N,4] array of (ts_us, x, y, pol))."""
    if packet["etype"] != "polarity_event":
        return False
    arr = np.frombuffer(packet["dvs_data"], dtype=np.uint32)
    arr = arr.reshape((packet["ecapacity"], packet["esize"] // 4))
    data, ts = arr[:, 0], arr[:, 1]
    pol = (data >> 1) & 0b1
    y = (data >> 2) & 0b111111111111111
    x = data >> 17
    if rotate180:
        x = DVS_SHAPE[1] - x - 1
        y = DVS_SHAPE[0] - y - 1
    return ts[0] * 1e-6, np.array([ts, x, y, pol]).T


def unpack_frame(packet: Dict, rotate180: bool = True):
    """APS frame packet -> (ts_s, uint16 [260,346] image)."""
    if packet["etype"] != "frame_event":
        return False
    head = np.frombuffer(packet["dvs_data"][:36], dtype=np.uint32)
    img = np.frombuffer(packet["dvs_data"][36:], dtype=np.uint16).reshape(DVS_SHAPE)
    if rotate180:
        img = np.rot90(img, k=2)
    return head[2] * 1e-6, img


def unpack_special(packet: Dict, rotate180: bool = True):
    """Special packet -> (ts_s, type ids) — e.g. timestamp resets (id 0)."""
    if packet["etype"] != "special_event":
        return False
    arr = np.frombuffer(packet["dvs_data"], dtype=np.uint32)
    arr = arr.reshape((packet["ecapacity"], packet["esize"] // 4))
    data, ts = arr[:, 0], arr[:, 1]
    typeid = data & 254
    return ts[0] * 1e-6, typeid


_UNPACKERS = {
    "polarity_event": unpack_events,
    "frame_event": unpack_frame,
    "special_event": unpack_special,
}


def unpack_data(packet: Dict, rotate180: bool = True):
    fn = _UNPACKERS.get(packet["etype"])
    if fn is None:
        return False
    packet["timestamp"], packet["data"] = fn(packet, rotate180)
    return packet


def filter_frame(packet: Dict) -> np.ndarray:
    """16-bit APS image -> 8-bit (as the original ddd_h5_reader.py)."""
    return (packet["data"] / 256).astype(np.uint8)


class DDD20SimpleReader:
    """Sequential reader over a DDD recording's caer packets."""

    ETYPE_DVS = "polarity_event"
    ETYPE_APS = "frame_event"
    ETYPE_IMU = "imu6_event"

    def __init__(self, fname: str, rotate180: bool = True):
        import h5py

        logger.info(f"opening DDD recording {fname}")
        self.rotate180 = rotate180
        self.f_in = h5py.File(fname, "r")
        if "dvs" not in self.f_in:
            raise ValueError(f"{fname} does not contain DAVIS data (key 'dvs')")
        self.davisData = self.f_in["dvs"]["data"]
        self.shape: Optional[Tuple[int, int]] = None
        self.numPackets = self.davisData.shape[0]

        # leading/trailing packets can be empty or unparseable
        self.firstPacketNumber = 0
        first = self.readPacket(self.firstPacketNumber)
        while first is False:
            self.firstPacketNumber += 1
            first = self.readPacket(self.firstPacketNumber)
        self.firstTimeS = first["timestamp"]
        last = self.readPacket(self.numPackets - 1)
        while last is False:
            self.numPackets -= 1
            last = self.readPacket(self.numPackets - 1)
        self.lastTimeS = last["timestamp"]
        self.durationS = self.lastTimeS - self.firstTimeS
        logger.info(
            f"{fname}: {self.numPackets} packets, t=[{self.firstTimeS:.2f}, "
            f"{self.lastTimeS:.2f}]s (duration {self.durationS:.1f}s)"
        )
        self._last_search: Optional[Tuple[float, int]] = None

    def readPacket(self, number: int):
        """Read and unpack packet `number`; False if empty/unparseable."""
        if number >= self.numPackets or number < 0:
            return False
        row = self.davisData[number]
        header_raw = row[1]
        if header_raw.shape[0] == 0:
            return False
        packet = {"dvs_header": header_raw}
        packet.update(unpack_header(packet["dvs_header"].tobytes()))
        packet["dvs_data"] = row[2].tobytes()
        return unpack_data(packet, self.rotate180)

    def search(self, timeS: Optional[float]):
        """Find the first packet at or after relative time `timeS`."""
        if timeS is None:
            return self.firstPacketNumber
        start = self.firstPacketNumber
        if self._last_search is not None and self._last_search[0] < timeS:
            start = self._last_search[1]
        for k in range(start, self.numPackets):
            packet = self.readPacket(k)
            if packet is False:
                continue
            if packet["timestamp"] >= self.firstTimeS + timeS:
                self._last_search = (timeS, k)
                return k
        logger.warning(f"could not find time {timeS} before end of file")
        return False

    def readEntire(self, startTimeS: Optional[float] = None,
                   stopTimeS: Optional[float] = None):
        """Read all frames+events in a window, handling timestamp resets.

        Returns (frames structured array with 'ts'/'frame', events [N,4]
        float (t_s, x, y, p(+-1))), both rebased to start at 0.
        """
        start = self.search(startTimeS)
        stop = self.search(stopTimeS) if stopTimeS is not None else self.numPackets
        if start is False or stop is False:
            raise ValueError("start/stop time outside recording")
        t_offset, current = 0.0, 0.0
        frames, events = [], []
        for k in range(start, stop):
            d = self.readPacket(k)
            if d is False:
                continue
            if d["etype"] == "special_event":
                if np.any(d["data"] == 0):  # timestamp reset
                    logger.info("timestamp reset detected")
                    t_offset += current
                continue
            if d["etype"] == "frame_event":
                ts = d["timestamp"] + t_offset
                frame = filter_frame(d)
                frames.append(
                    np.array(
                        [(ts, frame)],
                        dtype=np.dtype(
                            [("ts", np.float64), ("frame", np.uint8, frame.shape)]
                        ),
                    )
                )
                self.shape = frame.shape
                current = ts
                continue
            if d["etype"] == "polarity_event":
                data = d["data"]
                events.append(
                    np.hstack(
                        (
                            data[:, 0][:, None] * 1e-6 + t_offset,
                            data[:, 1][:, None],
                            data[:, 2][:, None],
                            data[:, 3].astype(np.int64)[:, None] * 2 - 1,
                        )
                    )
                )
        frames_arr = np.hstack(frames) if frames else np.array([])
        if frames:
            frames_arr["ts"] -= frames_arr["ts"][0]
        events_arr = np.vstack(events) if events else np.empty((0, 4))
        if events:
            events_arr[:, 0] -= events_arr[0, 0]
        return frames_arr, events_arr

    def close(self) -> None:
        self.f_in.close()


class DDD20StreamingReader:
    """Background-prefetching packet stream over a DDD recording.

    Equivalent of the reference's multiprocessing reader stack
    (ddd_h5_reader.py:226-546: HDF5Stream + MergedStream processes with
    queues): a single producer thread reads and unpacks packets ahead of
    the consumer into a bounded queue.  Threads suffice here — h5py reads
    release the GIL and the unpacking is numpy — so the queue/Event
    discipline of the reference collapses to queue.Queue.
    """

    _SENTINEL = object()

    def __init__(self, fname: str, rotate180: bool = True, bufsize: int = 256,
                 start_time_s: Optional[float] = None,
                 stop_time_s: Optional[float] = None):
        import queue
        import threading

        self.reader = DDD20SimpleReader(fname, rotate180=rotate180)
        self.q: "queue.Queue" = queue.Queue(bufsize)
        self._stop = threading.Event()
        start = self.reader.search(start_time_s) if start_time_s else self.reader.firstPacketNumber
        stop = (
            self.reader.search(stop_time_s)
            if stop_time_s is not None
            else self.reader.numPackets
        )
        if start is False or stop is False:
            raise ValueError("start/stop time outside recording")
        self._range = (start, stop)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        start, stop = self._range
        for k in range(start, stop):
            if self._stop.is_set():
                break
            packet = self.reader.readPacket(k)
            if packet is False:
                continue
            self.q.put(packet)
        self.q.put(self._SENTINEL)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._SENTINEL:
                return
            yield item

    def close(self) -> None:
        self._stop.set()
        # drain so the producer can exit
        try:
            while True:
                if self.q.get_nowait() is self._SENTINEL:
                    break
        except Exception:
            pass
        self._thread.join(timeout=5)
        self.reader.close()


class DDDH5Writer:
    """Append-structured DDD-style HDF5 recorder.

    Chunked-append equivalent of the reference's multiprocessing HDF5 writer
    (ddd20_utils/datasets.py): rows are buffered and flushed in chunks; no
    writer process is needed since h5py appends are cheap at chunk size.
    """

    CHUNK_SIZE = 128

    def __init__(self, filename: str, dvs_shape: Tuple[int, int] = DVS_SHAPE):
        import h5py

        self.f = h5py.File(filename, "w")
        self.group = self.f.create_group("dvs")
        self.datasets: Dict[str, object] = {}
        self.counts: Dict[str, int] = {}

    def append(self, dataset: str, ts: float, data: np.ndarray) -> None:
        import h5py

        data = np.asarray(data)
        if dataset not in self.datasets:
            self.datasets[dataset] = self.group.create_dataset(
                dataset,
                shape=(0,),
                maxshape=(None,),
                chunks=(self.CHUNK_SIZE,),
                dtype=np.dtype(
                    [("ts", np.float64), ("data", data.dtype, data.shape)]
                ),
            )
            self.counts[dataset] = 0
        ds = self.datasets[dataset]
        n = self.counts[dataset]
        ds.resize(n + 1, axis=0)
        ds[n] = (ts, data)
        self.counts[dataset] = n + 1

    def append_packet(self, header: bytes, data: bytes) -> None:
        """Append one raw caer packet as a DDD recording row.

        Writes the [seq, header, payload] vlen-uint8 triplet layout that
        DDD20 recordings store under ``dvs/data`` (the same rows
        `DDD20SimpleReader.readPacket` unpacks), so a file written this way
        round-trips through the reader.
        """
        import h5py

        if "data" not in self.datasets:
            dt = h5py.special_dtype(vlen=np.dtype("uint8"))
            self.datasets["data"] = self.group.create_dataset(
                "data",
                shape=(0, 3),
                maxshape=(None, 3),
                chunks=(self.CHUNK_SIZE, 3),
                dtype=dt,
            )
            self.counts["data"] = 0
        ds = self.datasets["data"]
        n = self.counts["data"]
        ds.resize(n + 1, axis=0)
        import struct

        ds[n, 0] = np.frombuffer(struct.pack("<q", n), dtype=np.uint8)
        ds[n, 1] = np.frombuffer(header, dtype=np.uint8)
        ds[n, 2] = np.frombuffer(data, dtype=np.uint8)
        self.counts["data"] = n + 1

    def close(self) -> None:
        self.f.close()
