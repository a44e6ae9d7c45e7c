"""LIME (Lattice QCD Interchange Message Encapsulation) record framing.

The port's own copy of `tmlqcd_tpu/io/lime.py` (the two packages never import
each other).  LIME is the container format of ILDG gauge configurations and
SciDAC propagators:

    record = header(144 bytes) + data (padded to 8)
    header = magic u32 BE (0x456789ab) | version u16 | flags u16 (MB|ME bits)
             | data length u64 BE | type string (128 bytes, NUL padded)

A *message* is a sequence of records from one MB (message-begin) flag to the
next ME (message-end).  This implementation reads/writes the framing exactly
byte-compatible with c-lime so configurations interchange with any LQCD code.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
import struct

__all__ = ["LimeRecord", "read_lime", "write_lime", "LIME_MAGIC"]

LIME_MAGIC = 0x456789AB
_HDR = struct.Struct(">IHHQ128s")  # magic, version, flags, length, type


@dataclasses.dataclass
class LimeRecord:
    type: str
    data: bytes
    msg_begin: bool = True
    msg_end: bool = True


def read_lime(path: str | os.PathLike) -> list[LimeRecord]:
    """Parse all LIME records of a file."""
    records = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(144)
            if len(hdr) < 144:
                break
            magic, version, flags, length, rtype = _HDR.unpack(hdr)
            if magic != LIME_MAGIC:
                raise ValueError(f"{path}: bad LIME magic {magic:#x} at {f.tell()-144}")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"{path}: truncated record {rtype!r}")
            pad = (-length) % 8
            if pad:
                f.seek(pad, 1)
            records.append(
                LimeRecord(
                    type=rtype.split(b"\x00", 1)[0].decode("ascii", "replace"),
                    data=data,
                    msg_begin=bool(flags & 0x8000),
                    msg_end=bool(flags & 0x4000),
                )
            )
    return records


def write_lime(path: str | os.PathLike, records: list[LimeRecord]) -> None:
    """Write records with c-lime-compatible framing; atomic via temp+rename."""
    buf = _io.BytesIO()
    for r in records:
        flags = (0x8000 if r.msg_begin else 0) | (0x4000 if r.msg_end else 0)
        rtype = r.type.encode("ascii")
        if len(rtype) > 128:
            raise ValueError(f"LIME type too long: {r.type!r}")
        buf.write(_HDR.pack(LIME_MAGIC, 1, flags, len(r.data), rtype))
        buf.write(r.data)
        buf.write(b"\x00" * ((-len(r.data)) % 8))
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
