"""Host helpers for the I/O layer: the SciDAC (DML) checksum.

Port of `tmlqcd_tpu/native/__init__.py`.  Each site's bytes get a CRC32
(zlib's, the same polynomial as DML's); the site of global rank n
contributes its CRC rotated left by n % 29 to `suma` and by n % 31 to
`sumb`, and the contributions xor together.

`scidac_checksum` runs the host C++ loop of `checksum.cpp`, which g++
builds at first use into `native/build/` (named by a hash of the source,
moved into place atomically) and ctypes loads.  Its plain version,
`scidac_checksum_plain`, is numpy with zlib's crc32 per site; it serves
when the build fails, and then one line on stderr says so and names that
route.  `checksum_route()` says which route is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
import zlib

import numpy as np

__all__ = ["scidac_checksum", "scidac_checksum_plain", "checksum_route"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "checksum.cpp")
_BUILD = os.path.join(_HERE, "build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def _library():
    """The checksum library, built on first use; None when the build or the
    load failed (reported once on stderr)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            with open(_SRC, "rb") as f:
                digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
            so = os.path.join(_BUILD, f"libtm_checksum_{digest}.so")
            if not os.path.exists(so):
                os.makedirs(_BUILD, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
                os.close(fd)
                try:
                    res = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], capture_output=True,
                                         text=True, timeout=120)
                    if res.returncode != 0:
                        raise RuntimeError(f"g++ exited {res.returncode}: "
                                           f"{res.stderr.strip().splitlines()[-1:]}")
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(so)
            u64, p32 = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32)
            lib.tm_scidac_checksum.argtypes = [ctypes.c_void_p, u64, u64, u64, p32, p32]
            lib.tm_scidac_checksum.restype = None
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            print(f"tmlqcd_tpu_torch.native: building checksum.cpp failed ({exc}); the SciDAC "
                  f"checksum takes the plain numpy/zlib route", file=sys.stderr, flush=True)
            _lib = None
        return _lib


def checksum_route() -> str:
    """'native' when the C++ checksum is in use, else 'plain'."""
    return "native" if _library() is not None else "plain"


def _as_sites(data: np.ndarray) -> np.ndarray:
    data = np.ascontiguousarray(data, np.uint8)
    if data.ndim != 2:
        raise ValueError("expected [nsites, site_bytes]")
    return data


def scidac_checksum_plain(data: np.ndarray, rank0: int = 0) -> tuple[int, int]:
    """`scidac_checksum` in numpy, with zlib's crc32 per site."""
    data = _as_sites(data)
    nsites = data.shape[0]
    crc = np.fromiter((zlib.crc32(row) for row in data), np.uint32, nsites)
    ranks = rank0 + np.arange(nsites, dtype=np.uint64)
    out = []
    for mod in (29, 31):
        s = (ranks % mod).astype(np.uint32)
        rot = np.where(s == 0, crc, (crc << s) | (crc >> (np.uint32(32) - s)))
        out.append(int(np.bitwise_xor.reduce(rot)) if nsites else 0)
    return out[0], out[1]


def scidac_checksum(data: np.ndarray, rank0: int = 0) -> tuple[int, int]:
    """(suma, sumb) of the SciDAC checksum of per-site binary records.

    data: uint8 [nsites, site_bytes] in the exact on-disk byte order; rank0:
    the global lexicographic rank of the first site (partial checksums of
    disjoint site ranges xor together)."""
    data = _as_sites(data)
    lib = _library()
    if lib is None:
        return scidac_checksum_plain(data, rank0)
    suma, sumb = ctypes.c_uint32(0), ctypes.c_uint32(0)
    lib.tm_scidac_checksum(data.ctypes.data, data.shape[1], data.shape[0], rank0,
                           ctypes.byref(suma), ctypes.byref(sumb))
    return int(suma.value), int(sumb.value)
