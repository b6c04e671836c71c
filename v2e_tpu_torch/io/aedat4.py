"""AEDAT-4.0 event file writer and reader (the port's copy of
v2e_tpu/io/aedat4.py), with no dv-processing and no flatbuffers package.

File layout (inivation AEDAT-4.0 spec):
  1. version line ``#!AER-DAT4.0\r\n``
  2. size-prefixed ``IOHeader`` flatbuffer (compression enum, data-table file
     position, outInfo XML describing the streams)
  3. a sequence of packets: ``int32 streamID, int32 size`` then ``size``
     bytes holding a (compressed) size-prefixed ``EventPacket`` flatbuffer
     whose elements are 16-byte structs ``{int64 t_us, int16 x, int16 y,
     int8 polarity, pad[3]}``
  4. at close, the ``FileDataTable`` seek index, whose file position is
     patched into the IOHeader.

All three flatbuffer tables are laid out here by hand.  The IOHeader and
EventPacket have fixed layouts; the seek index has one table per packet,
so it is written back to front as ``flatbuffers.Builder`` writes it
(`_BackBuilder`: the same alignment, the same omission of zero fields and
the same sharing of equal vtables), and the file is byte-identical to
v2e_tpu's.  The event structs are packed with one numpy structured-array
write.

Compression NONE is written by default; ``zstd`` (the ``zstandard``
package, imported only then) via the ``compression`` argument.
"""
from __future__ import annotations

import atexit
import logging
import struct
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

# CompressionType enum from the dv IOHeader schema
_COMPRESSION = {"none": 0, "lz4": 1, "lz4_high": 2, "zstd": 4, "zstd_high": 8}

_EVENT_DTYPE = np.dtype(
    [
        ("t", "<i8"),
        ("x", "<i2"),
        ("y", "<i2"),
        ("p", "i1"),
        ("_pad", "V3"),
    ]
)
assert _EVENT_DTYPE.itemsize == 16

# byte position of the IOHeader's dataTablePosition int64 within the file:
# 14-byte version line + size prefix(4) + root offset(4) + 'IOHE'(4) +
# vtable(10) + pad(2) + soffset(4) + compression(4) — see
# _io_header_flatbuffer's layout
_VERSION_LINE = b"#!AER-DAT4.0\r\n"
_DTP_FILE_OFFSET = len(_VERSION_LINE) + 32


class _BackBuilder:
    """The subset of ``flatbuffers.Builder`` the seek index needs: a buffer
    written back to front, offsets counted from its end.  `prep` pads so
    that a `size`-byte value written after `extra` more bytes is aligned,
    and the finished buffer is aligned to the largest size prepared."""

    def __init__(self):
        self.chunks = []  # in writing order, i.e. from the buffer's end
        self.size = 0
        self.minalign = 1
        self.vtables = {}

    def put(self, data: bytes) -> None:
        self.chunks.append(data)
        self.size += len(data)

    def prep(self, size: int, extra: int = 0) -> None:
        self.minalign = max(self.minalign, size)
        pad = (-(self.size + extra)) & (size - 1)
        if pad:
            self.put(bytes(pad))

    def scalar(self, fmt: str, value) -> int:
        self.prep(struct.calcsize(fmt))
        self.put(struct.pack("<" + fmt, value))
        return self.size

    def end_table(self, start: int, slots) -> int:
        """Close a table begun at offset `start` whose fields sit at the
        offsets `slots` (0: absent), writing its vtable or pointing it at an
        equal one written before.  Returns the table's offset."""
        self.prep(4)
        obj = self.size + 4
        fields = [obj - s if s else 0 for s in slots]
        while fields and not fields[-1]:
            fields.pop()
        key = (tuple(fields), obj - start)
        shared = self.vtables.get(key)
        if shared is not None:
            self.put(struct.pack("<i", shared - obj))
        else:
            vbytes = 2 * (2 + len(fields))
            self.put(struct.pack("<i", vbytes))
            self.put(struct.pack(f"<{2 + len(fields)}H", vbytes, obj - start, *fields))
            self.vtables[key] = self.size
        return obj

    def uoffset(self, target: int) -> int:
        self.prep(4)
        return self.scalar("I", self.size - target + 4)

    def finish_size_prefixed(self, root: int, ident: bytes) -> bytes:
        self.prep(self.minalign, 12)
        self.prep(4, 4)
        self.put(ident)
        self.uoffset(root)
        self.scalar("i", self.size)
        return b"".join(reversed(self.chunks))


def _file_data_table_flatbuffer(entries) -> bytes:
    """Serialize the dv FileDataTable (seek index), byte for byte as the
    generic flatbuffers builder does.

    Schema (dv-processing IODataTable.fbs):
      struct PacketHeader { StreamID:int32; Size:int32; }
      table FileDataDefinition { ByteOffset:int64; PacketInfo:PacketHeader;
        NumElements:int64; TimestampStart:int64; TimestampEnd:int64; }
      table FileDataTable { Table:[FileDataDefinition]; }  // id "IODT"

    entries: iterable of (byte_offset, stream_id, size, num, ts0_us, ts1_us).
    An int64 field equal to its default 0 is left out of its table.
    """
    b = _BackBuilder()
    offs = []
    for byte_offset, stream_id, size, num, ts0, ts1 in entries:
        start = b.size
        slots = [0] * 5
        for slot, value in ((4, ts1), (3, ts0), (2, num)):
            if int(value):
                slots[slot] = b.scalar("q", int(value))
        # field 1: the inline PacketHeader struct
        b.prep(4, 8)
        b.put(struct.pack("<ii", int(stream_id), int(size)))
        slots[1] = b.size
        if int(byte_offset):
            slots[0] = b.scalar("q", int(byte_offset))
        offs.append(b.end_table(start, slots))
    b.prep(4, 4 * len(offs))
    for off in reversed(offs):
        b.uoffset(off)
    b.put(struct.pack("<I", len(offs)))
    vec = b.size
    start = b.size
    root = b.end_table(start, [b.uoffset(vec)])
    return b.finish_size_prefixed(root, b"IODT")


def _event_packet_flatbuffer(events_struct: np.ndarray) -> bytes:
    """Serialize an EventPacket table as a size-prefixed flatbuffer.

    Layout (little-endian):
      0  u32 size prefix (= total-4)
      4  u32 root table offset (relative to position 4)
      8  'EVTS' file identifier
      12 vtable [u16 vtable_size=6][u16 object_size=8][u16 field0_off=4] + 2 pad
      20 table  [i32 soffset_to_vtable=8][u32 uoffset_to_vector=4]
      28 vector [u32 count][count x 16-byte Event structs]
    """
    n = events_struct.shape[0]
    total = 32 + 16 * n
    head = struct.pack(
        "<IIs3sHHHHiII",
        total - 4,  # size prefix
        16,  # root offset (table at 20, relative to 4)
        b"E", b"VTS",  # identifier
        6, 8, 4,  # vtable
        0,  # pad
        8,  # table soffset to vtable
        4,  # uoffset to vector (at 28, from 24)
        n,  # vector count
    )
    assert len(head) == 32
    return head + events_struct.tobytes()


def _io_header_flatbuffer(
    compression: int, data_table_position: int, info_node: str
) -> bytes:
    """Serialize the IOHeader table as a size-prefixed flatbuffer.

    Fields: compression:int32 (id 0), dataTablePosition:int64 (id 1),
    infoNode:string (id 2).
    """
    info = info_node.encode("utf-8")
    str_payload = struct.pack("<I", len(info)) + info + b"\x00"
    pad = (-len(str_payload)) % 4
    str_payload += b"\x00" * pad
    # vtable at 12 (10 bytes + 2 pad), table at 24 (8-aligned for the int64)
    buf = bytearray()
    buf += struct.pack("<I", 44 + len(str_payload) - 4)  # size prefix
    buf += struct.pack("<I", 20)  # root table offset
    buf += b"IOHE"
    buf += struct.pack("<HHHHH", 10, 20, 4, 8, 16)  # vtable
    buf += b"\x00\x00"  # pad to table at 24
    buf += struct.pack("<i", 12)  # soffset to vtable
    buf += struct.pack("<i", compression)  # field 0 at 28
    buf += struct.pack("<q", data_table_position)  # field 1 at 32
    buf += struct.pack("<I", 44 - 40)  # field 2 at 40: uoffset to string at 44
    buf += str_payload
    assert len(buf) == 44 + len(str_payload)
    return bytes(buf)


def _out_info_xml(size_x: int, size_y: int, compression: str, source: str) -> str:
    comp = compression.upper()
    return (
        '<dv version="2.0">'
        '<node name="outInfo" path="/mainloop/outInfo/">'
        '<node name="0" path="/mainloop/outInfo/0/">'
        f'<attr key="compression" type="string">{comp}</attr>'
        '<attr key="originalModuleName" type="string">v2e_tpu</attr>'
        '<attr key="originalOutputName" type="string">events</attr>'
        '<attr key="typeDescription" type="string">Array of events (polarity ON/OFF).</attr>'
        '<attr key="typeIdentifier" type="string">EVTS</attr>'
        '<node name="info" path="/mainloop/outInfo/0/info/">'
        f'<attr key="sizeX" type="int">{size_x}</attr>'
        f'<attr key="sizeY" type="int">{size_y}</attr>'
        f'<attr key="source" type="string">{source}</attr>'
        '<attr key="tsOffset" type="long">0</attr>'
        "</node></node></node></dv>"
    )


class AEDat4Output:
    """Streams AER events into an AEDAT-4.0 container, one packet per
    `appendEvents`, so memory stays bounded for long conversions.  The
    outInfo XML names the module ``v2e_tpu`` by default (`source_name`),
    as the JAX package's writer does, so the two write the same bytes."""

    STREAM_ID = 0

    def __init__(
        self,
        filepath: str,
        output_width: int = 640,
        output_height: int = 480,
        compression: str = "none",
        source_name: str = "v2e_tpu",
        data_table: bool = True,
    ):
        if compression not in ("none", "zstd"):
            raise ValueError("compression must be 'none' or 'zstd'")
        self.filepath = filepath
        self.compression = compression
        self.sizex = output_width
        self.sizey = output_height
        self.flipx = False
        self.flipy = False
        self.numEventsWritten = 0
        self.numOnEvents = 0
        self.numOffEvents = 0
        self._zctx = None
        if compression == "zstd":
            import zstandard

            self._zctx = zstandard.ZstdCompressor()
        # seek index written at close when enabled (dv-processing writes
        # one by default; dataTablePosition -1 means absent)
        self._data_table = [] if data_table else None

        self.file = open(filepath, "wb")
        # finalize on interpreter exit; close() is idempotent
        atexit.register(self.close)
        self.file.write(_VERSION_LINE)
        info = _out_info_xml(output_width, output_height, compression, source_name)
        self.file.write(
            _io_header_flatbuffer(_COMPRESSION[compression], -1, info)
        )

    def appendEvents(
        self, events: np.ndarray, signnoise_label: Optional[np.ndarray] = None
    ) -> None:
        if self.file is None or len(events) == 0:
            return
        n = events.shape[0]
        rec = np.zeros(n, dtype=_EVENT_DTYPE)  # zeroed: the 3 pad bytes are written too
        rec["t"] = (events[:, 0] * 1e6).astype(np.int64)
        x = events[:, 1].astype(np.int16)
        y = events[:, 2].astype(np.int16)
        if self.flipx:
            x = (self.sizex - 1) - x
        if self.flipy:
            y = (self.sizey - 1) - y
        rec["x"] = x
        rec["y"] = y
        p = ((events[:, 3] + 1) / 2).astype(np.int8)
        rec["p"] = p

        body = _event_packet_flatbuffer(rec)
        if self._zctx is not None:
            body = self._zctx.compress(body)
        if self._data_table is not None:
            self._data_table.append((
                self.file.tell(), self.STREAM_ID, len(body), n,
                int(rec["t"][0]), int(rec["t"][-1]),
            ))
        self.file.write(struct.pack("<ii", self.STREAM_ID, len(body)))
        self.file.write(body)

        self.numEventsWritten += n
        on = int(np.count_nonzero(p))
        self.numOnEvents += on
        self.numOffEvents += n - on

    def close(self) -> None:
        if self.file is not None:
            if self._data_table is not None:
                table_pos = self.file.tell()
                body = _file_data_table_flatbuffer(self._data_table)
                if self._zctx is not None:
                    body = self._zctx.compress(body)
                self.file.write(body)
                # patch the IOHeader's dataTablePosition in place
                self.file.seek(_DTP_FILE_OFFSET)
                self.file.write(struct.pack("<q", table_pos))
            logger.info(
                f"closing {self.filepath} after writing {self.numEventsWritten} "
                f"events ({self.numOnEvents} on, {self.numOffEvents} off)"
            )
            self.file.close()
            self.file = None

    def cleanup(self) -> None:
        self.close()


def read_aedat4(filepath: str) -> np.ndarray:
    """Minimal AEDAT-4.0 reader for round-trip validation.

    Returns events as float64 [N,4] = [t_seconds, x, y, p(+-1)].  Only
    handles files produced by `AEDat4Output` (single EVTS stream,
    none/zstd compression).
    """
    with open(filepath, "rb") as f:
        version = f.readline()
        if not version.startswith(b"#!AER-DAT4.0"):
            raise ValueError(f"not an AEDAT-4.0 file: {version!r}")
        (hdr_size,) = struct.unpack("<I", f.read(4))
        hdr = f.read(hdr_size)
        # root table offset relative to buffer start
        (root_off,) = struct.unpack_from("<I", hdr, 0)
        (soff,) = struct.unpack_from("<i", hdr, root_off)
        vt = root_off - soff
        vt_size, obj_size = struct.unpack_from("<HH", hdr, vt)
        comp = 0
        data_table_pos = -1
        if vt_size >= 6:
            (f0,) = struct.unpack_from("<H", hdr, vt + 4)
            if f0:
                (comp,) = struct.unpack_from("<i", hdr, root_off + f0)
        if vt_size >= 8:
            (f1,) = struct.unpack_from("<H", hdr, vt + 6)
            if f1:
                (data_table_pos,) = struct.unpack_from("<q", hdr, root_off + f1)
        dctx = None
        if comp in (4, 8):
            import zstandard

            dctx = zstandard.ZstdDecompressor()
        elif comp != 0:
            raise NotImplementedError(f"compression enum {comp} unsupported")

        chunks = []
        while True:
            # the FileDataTable (when present) sits at data_table_pos with
            # no packet header in front of it — stop the packet scan there
            if data_table_pos >= 0 and f.tell() >= data_table_pos:
                break
            ph = f.read(8)
            if len(ph) < 8:
                break
            stream_id, size = struct.unpack("<ii", ph)
            body = f.read(size)
            if dctx is not None:
                body = dctx.decompress(body)
            (root_off,) = struct.unpack_from("<I", body, 4)
            root = 4 + root_off
            (soff,) = struct.unpack_from("<i", body, root)
            vt = root - soff
            (f0,) = struct.unpack_from("<H", body, vt + 4)
            (vec_rel,) = struct.unpack_from("<I", body, root + f0)
            vec = root + f0 + vec_rel
            (count,) = struct.unpack_from("<I", body, vec)
            rec = np.frombuffer(
                body, dtype=_EVENT_DTYPE, count=count, offset=vec + 4
            )
            chunks.append(rec)
    if not chunks:
        return np.empty((0, 4), dtype=np.float64)
    rec = np.concatenate(chunks)
    out = np.empty((rec.shape[0], 4), dtype=np.float64)
    out[:, 0] = rec["t"] * 1e-6
    out[:, 1] = rec["x"]
    out[:, 2] = rec["y"]
    out[:, 3] = rec["p"] * 2.0 - 1.0
    return out


def read_aedat4_data_table(filepath: str):
    """Parse the FileDataTable seek index (generic vtable walk).

    Returns a list of dicts or None when the file has no table
    (dataTablePosition == -1).
    """
    with open(filepath, "rb") as f:
        version = f.readline()
        if not version.startswith(b"#!AER-DAT4.0"):
            raise ValueError(f"not an AEDAT-4.0 file: {version!r}")
        (hdr_size,) = struct.unpack("<I", f.read(4))
        hdr = f.read(hdr_size)
        (root_off,) = struct.unpack_from("<I", hdr, 0)
        (soff,) = struct.unpack_from("<i", hdr, root_off)
        vt = root_off - soff
        (vt_size,) = struct.unpack_from("<H", hdr, vt)
        comp = 0
        pos = -1
        if vt_size >= 6:
            (f0,) = struct.unpack_from("<H", hdr, vt + 4)
            if f0:
                (comp,) = struct.unpack_from("<i", hdr, root_off + f0)
        if vt_size >= 8:
            (f1,) = struct.unpack_from("<H", hdr, vt + 6)
            if f1:
                (pos,) = struct.unpack_from("<q", hdr, root_off + f1)
        if pos < 0:
            return None
        f.seek(pos)
        body = f.read()
    if comp in (4, 8):
        import zstandard

        body = zstandard.ZstdDecompressor().decompress(body)
    elif comp != 0:
        raise NotImplementedError(f"compression enum {comp} unsupported")

    def table_fields(buf, tab):
        (soff,) = struct.unpack_from("<i", buf, tab)
        vt = tab - soff
        (vsz,) = struct.unpack_from("<H", buf, vt)
        n_fields = (vsz - 4) // 2
        return [
            struct.unpack_from("<H", buf, vt + 4 + 2 * i)[0]
            for i in range(n_fields)
        ]

    (root_rel,) = struct.unpack_from("<I", body, 4)
    root = 4 + root_rel
    fields = table_fields(body, root)
    (vec_rel,) = struct.unpack_from("<I", body, root + fields[0])
    vec = root + fields[0] + vec_rel
    (count,) = struct.unpack_from("<I", body, vec)
    out = []
    for i in range(count):
        (ent_rel,) = struct.unpack_from("<I", body, vec + 4 + 4 * i)
        ent = vec + 4 + 4 * i + ent_rel
        ef = table_fields(body, ent)

        def fld(idx, fmt, default=0):
            if idx >= len(ef) or ef[idx] == 0:
                return default
            return struct.unpack_from(fmt, body, ent + ef[idx])[0]

        stream_id = size = 0
        if len(ef) > 1 and ef[1]:
            stream_id, size = struct.unpack_from("<ii", body, ent + ef[1])
        out.append({
            "byte_offset": fld(0, "<q"),
            "stream_id": stream_id,
            "size": size,
            "num_elements": fld(2, "<q"),
            "timestamp_start": fld(3, "<q"),
            "timestamp_end": fld(4, "<q"),
        })
    return out
