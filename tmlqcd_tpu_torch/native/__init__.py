"""Host helpers for the I/O layer: the SciDAC (DML) checksum.

Port of the numpy route of `tmlqcd_tpu/native/__init__.py`
(`scidac_checksum`).  Each site's bytes get a CRC32 (zlib's, the same
polynomial as DML's); the site of global rank n contributes its CRC rotated
left by n % 29 to `suma` and by n % 31 to `sumb`, and the contributions xor
together.  The reference's C++ helper (`native/checksum.cpp`) is host code
and not ported.
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["scidac_checksum"]


def scidac_checksum(data: np.ndarray, rank0: int = 0) -> tuple[int, int]:
    """(suma, sumb) of the SciDAC checksum of per-site binary records.

    data: uint8 [nsites, site_bytes] in the exact on-disk byte order; rank0:
    the global lexicographic rank of the first site (partial checksums of
    disjoint site ranges xor together)."""
    data = np.ascontiguousarray(data, np.uint8)
    if data.ndim != 2:
        raise ValueError("expected [nsites, site_bytes]")
    nsites = data.shape[0]
    crc = np.fromiter((zlib.crc32(row) for row in data), np.uint32, nsites)
    ranks = rank0 + np.arange(nsites, dtype=np.uint64)
    out = []
    for mod in (29, 31):
        s = (ranks % mod).astype(np.uint32)
        rot = np.where(s == 0, crc, (crc << s) | (crc >> (np.uint32(32) - s)))
        out.append(int(np.bitwise_xor.reduce(rot)) if nsites else 0)
    return out[0], out[1]
