"""Propagator / spinor-field LIME I/O (SciDAC binary records).

Port of `tmlqcd_tpu/io/propagator.py`: LIME messages with an
`etmc-propagator-format` XML record followed by one `scidac-binary-data`
record per source spin-colour component, each with its `scidac-checksum`.

On-disk spinor layout (interop contract): big-endian IEEE, site order
t slowest / x fastest (as gauge ILDG), per site 4 spin x 3 color complex.
Internal layout [4, 3, T, X, Y*Z] <-> disk transposes in numpy.
"""

from __future__ import annotations

import re

import numpy as np

from tmlqcd_tpu_torch.io.lime import LimeRecord, read_lime, write_lime
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.native import scidac_checksum
from tmlqcd_tpu_torch.utils import to_host

__all__ = ["write_propagator", "read_propagator"]


def _spinor_to_disk(s: np.ndarray, lat: Lattice) -> np.ndarray:
    """[4,3,T,X,Y*Z] -> [T,Z,Y,X,4,3]."""
    t, x, y, z = lat.dims
    a = s.reshape(4, 3, t, x, y, z)
    return a.transpose(2, 5, 4, 3, 0, 1)


def _spinor_from_disk(a: np.ndarray, lat: Lattice) -> np.ndarray:
    t, x, y, z = lat.dims
    return a.transpose(4, 5, 0, 3, 2, 1).reshape(4, 3, t, x, y * z)


def _format_xml(lat: Lattice, precision: int, nflavours: int = 1) -> str:
    t, x, y, z = lat.dims
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        "<etmcFormat><field>diracFermion</field>"
        f"<precision>{precision}</precision><flavours>{nflavours}</flavours>"
        f"<lx>{x}</lx><ly>{y}</ly><lz>{z}</lz><lt>{t}</lt>"
        "<spin>4</spin><colour>3</colour></etmcFormat>"
    )


def write_propagator(path: str, components, lat: Lattice, precision: int = 64) -> None:
    """components: iterable of full-lattice spinor fields [4,3,T,X,Y*Z]
    (one per source spin-colour; torch or numpy); writes the multi-record
    LIME file."""
    comps = [to_host(c) for c in components]
    fdtype = np.float64 if precision == 64 else np.float32
    records = [
        LimeRecord("etmc-propagator-format", _format_xml(lat, precision).encode(), True, False)
    ]
    site_bytes = 4 * 3 * 2 * (8 if precision == 64 else 4)
    for i, c in enumerate(comps):
        a = _spinor_to_disk(c, lat)
        reim = np.stack([a.real, a.imag], axis=-1).astype(fdtype)
        payload = reim.astype(reim.dtype.newbyteorder(">")).tobytes()
        data2d = np.frombuffer(payload, np.uint8).reshape(lat.volume, site_bytes)
        suma, sumb = scidac_checksum(data2d, rank0=0)
        last = i == len(comps) - 1
        records.append(LimeRecord("scidac-binary-data", payload, False, False))
        records.append(
            LimeRecord(
                "scidac-checksum",
                (
                    '<?xml version="1.0" encoding="UTF-8"?>'
                    "<scidacChecksum><version>1.0</version>"
                    f"<suma>{suma:x}</suma><sumb>{sumb:x}</sumb></scidacChecksum>"
                ).encode(),
                False,
                last,
            )
        )
    write_lime(path, records)


def read_propagator(path: str, lat: Lattice):
    """Returns (list of [4,3,T,X,Y*Z] complex128 arrays, precision);
    verifies every per-record checksum."""
    recs = read_lime(path)
    precision = 64
    for r in recs:
        if r.type == "etmc-propagator-format":
            m = re.search(r"<precision>\s*(\d+)\s*</precision>", r.data.decode("utf-8", "replace"))
            if m:
                precision = int(m.group(1))
    fbytes = 8 if precision == 64 else 4
    site_bytes = 4 * 3 * 2 * fbytes
    fdtype = np.dtype(np.float64 if precision == 64 else np.float32).newbyteorder(">")

    out = []
    pending = None
    for r in recs:
        if r.type == "scidac-binary-data":
            if len(r.data) != lat.volume * site_bytes:
                raise ValueError(f"{path}: bad spinor record size {len(r.data)}")
            pending = r.data
            t, x, y, z = lat.dims
            reim = (
                np.frombuffer(r.data, fdtype)
                .astype(np.float64)
                .reshape(t, z, y, x, 4, 3, 2)
            )
            out.append(_spinor_from_disk(reim[..., 0] + 1j * reim[..., 1], lat))
        elif r.type == "scidac-checksum" and pending is not None:
            xml = r.data.decode("utf-8", "replace")
            ma = re.search(r"<suma>\s*([0-9a-fA-F]+)\s*</suma>", xml)
            mb = re.search(r"<sumb>\s*([0-9a-fA-F]+)\s*</sumb>", xml)
            if ma and mb:
                data2d = np.frombuffer(pending, np.uint8).reshape(lat.volume, site_bytes)
                suma, sumb = scidac_checksum(data2d, rank0=0)
                if (suma, sumb) != (int(ma.group(1), 16), int(mb.group(1), 16)):
                    raise ValueError(f"{path}: spinor checksum mismatch")
            pending = None
    return out, precision
