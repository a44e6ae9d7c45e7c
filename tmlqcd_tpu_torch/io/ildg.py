"""ILDG gauge-configuration reader/writer (LIME container, SciDAC checksum).

Port of `tmlqcd_tpu/io/ildg.py`: the same records and byte order, so a file
written by either package (or any ILDG code) reads in the other.

On-disk contract (byte-exact interop):
  * LIME records: `xlf-info` (text: plaquette, trajectory, beta, kappa, mu,
    timestamp), `ildg-format` (XML: precision + dims), `ildg-binary-data`
    (big-endian IEEE, site-lexicographic with x fastest / t slowest, per
    site 4 links in direction order mu = x, y, z, t, each a row-major 3x3
    complex), `scidac-checksum` (XML: suma/sumb hex).
  * Internal layout <-> disk layout transposes happen host-side in numpy
    (our layout: [3, 3, 4 (t,x,y,z), T, X, Y*Z] — see tmlqcd_tpu_torch.lattice).

`xlf-info` carries the date of writing, so two files of one field differ in
that record and nowhere else.
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass

import numpy as np

from tmlqcd_tpu_torch.io.lime import LimeRecord, read_lime, write_lime
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.native import scidac_checksum
from tmlqcd_tpu_torch.utils import to_host

__all__ = ["write_gauge_field", "read_gauge_field", "GaugeHeader"]

# our direction order (t,x,y,z) -> ILDG order (x,y,z,t)
_MU_TO_ILDG = [1, 2, 3, 0]
_MU_FROM_ILDG = [3, 0, 1, 2]


@dataclass
class GaugeHeader:
    """Metadata recovered from / written to the LIME records."""

    lat: Lattice
    precision: int = 64
    plaquette: float | None = None
    trajectory: int | None = None
    beta: float | None = None
    kappa: float | None = None
    mu: float | None = None


def _to_disk_order(u: np.ndarray, lat: Lattice) -> np.ndarray:
    """[3,3,4,T,X,Y*Z] -> [T,Z,Y,X,4(ildg mu),3,3]."""
    t, x, y, z = lat.dims
    a = u.reshape(3, 3, 4, t, x, y, z)
    a = a.transpose(3, 6, 5, 4, 2, 0, 1)  # [T,Z,Y,X,mu,3,3]
    return a[..., _MU_TO_ILDG, :, :]


def _from_disk_order(a: np.ndarray, lat: Lattice) -> np.ndarray:
    """[T,Z,Y,X,4(ildg mu),3,3] -> [3,3,4,T,X,Y*Z]."""
    t, x, y, z = lat.dims
    a = a[..., _MU_FROM_ILDG, :, :]
    a = a.transpose(5, 6, 4, 0, 3, 2, 1)  # [3,3,mu,T,X,Y,Z]
    return a.reshape(3, 3, 4, t, x, y * z)


def _xlf_info(hdr: GaugeHeader) -> str:
    now = datetime.datetime.now(datetime.timezone.utc).strftime("%a %b %d %H:%M:%S %Y")
    lines = [
        f" plaquette = {hdr.plaquette if hdr.plaquette is not None else 0.0:.12f}",
        f" trajectory nr = {hdr.trajectory or 0}",
        f" beta = {hdr.beta if hdr.beta is not None else 0.0:f}, "
        f"kappa = {hdr.kappa if hdr.kappa is not None else 0.0:f}, "
        f"mu = {hdr.mu if hdr.mu is not None else 0.0:f}, c2_rec = 0.000000",
        " time = 0, hmcversion = tmlqcd_tpu_torch-0.1.0, mubar = 0.000000, "
        f"epsilonbar = 0.000000, date = {now}",
    ]
    return "\n".join(lines)


def _ildg_format_xml(hdr: GaugeHeader) -> str:
    t, x, y, z = hdr.lat.dims
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<ildgFormat xmlns="http://www.lqcd.org/ildg" '
        'xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
        'xsi:schemaLocation="http://www.lqcd.org/ildg/filefmt.xsd">'
        "<version>1.0</version><field>su3gauge</field>"
        f"<precision>{hdr.precision}</precision>"
        f"<lx>{x}</lx><ly>{y}</ly><lz>{z}</lz><lt>{t}</lt>"
        "</ildgFormat>"
    )


def _checksum_xml(suma: int, sumb: int) -> str:
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        "<scidacChecksum><version>1.0</version>"
        f"<suma>{suma:x}</suma><sumb>{sumb:x}</sumb></scidacChecksum>"
    )


def write_gauge_field(path: str, u, lat: Lattice, precision: int = 64, **meta) -> None:
    """Write an ILDG configuration.

    u: [3,3,4,T,X,Y*Z] complex (torch or numpy); meta: plaquette, trajectory,
    beta, kappa, mu forwarded to the xlf-info record.
    """
    hdr = GaugeHeader(lat=lat, precision=precision, **meta)
    a = _to_disk_order(to_host(u), lat)
    fdtype = np.float64 if precision == 64 else np.float32
    # complex -> interleaved re/im floats at target precision, big-endian
    reim = np.stack([a.real, a.imag], axis=-1).astype(fdtype)
    be = reim.astype(reim.dtype.newbyteorder(">"))
    payload = be.tobytes()
    site_bytes = 4 * 9 * 2 * (8 if precision == 64 else 4)
    data2d = np.frombuffer(payload, np.uint8).reshape(lat.volume, site_bytes)
    suma, sumb = scidac_checksum(data2d, rank0=0)
    records = [
        LimeRecord("xlf-info", _xlf_info(hdr).encode(), True, False),
        LimeRecord("ildg-format", _ildg_format_xml(hdr).encode(), False, False),
        LimeRecord("ildg-binary-data", payload, False, False),
        LimeRecord("scidac-checksum", _checksum_xml(suma, sumb).encode(), False, True),
    ]
    write_lime(path, records)


def read_gauge_field(path: str, expect_lat: Lattice | None = None):
    """Read an ILDG configuration; verifies the SciDAC checksum and returns
    (u [3,3,4,T,X,Y*Z] complex128 numpy, GaugeHeader)."""
    recs = {r.type: r for r in read_lime(path)}
    if "ildg-binary-data" not in recs:
        raise ValueError(f"{path}: no ildg-binary-data record")

    precision, dims = 64, None
    if "ildg-format" in recs:
        xml = recs["ildg-format"].data.decode("utf-8", "replace")
        g = lambda tag: re.search(rf"<{tag}>\s*(\d+)\s*</{tag}>", xml)
        if g("precision"):
            precision = int(g("precision").group(1))
        if all(g(k) for k in ("lx", "ly", "lz", "lt")):
            dims = (
                int(g("lt").group(1)),
                int(g("lx").group(1)),
                int(g("ly").group(1)),
                int(g("lz").group(1)),
            )
    if dims is None:
        if expect_lat is None:
            raise ValueError(f"{path}: no ildg-format record and no expected lattice")
        dims = expect_lat.dims
    lat = Lattice(dims)
    if expect_lat is not None and lat.dims != expect_lat.dims:
        raise ValueError(f"{path}: lattice {lat.dims} != expected {expect_lat.dims}")

    payload = recs["ildg-binary-data"].data
    fbytes = 8 if precision == 64 else 4
    site_bytes = 4 * 9 * 2 * fbytes
    if len(payload) != lat.volume * site_bytes:
        raise ValueError(
            f"{path}: binary size {len(payload)} != volume*{site_bytes}"
        )

    if "scidac-checksum" in recs:
        xml = recs["scidac-checksum"].data.decode("utf-8", "replace")
        ma = re.search(r"<suma>\s*([0-9a-fA-F]+)\s*</suma>", xml)
        mb = re.search(r"<sumb>\s*([0-9a-fA-F]+)\s*</sumb>", xml)
        if ma and mb:
            data2d = np.frombuffer(payload, np.uint8).reshape(lat.volume, site_bytes)
            suma, sumb = scidac_checksum(data2d, rank0=0)
            if (suma, sumb) != (int(ma.group(1), 16), int(mb.group(1), 16)):
                raise ValueError(
                    f"{path}: SciDAC checksum mismatch "
                    f"(file {ma.group(1)}/{mb.group(1)}, data {suma:x}/{sumb:x})"
                )

    fdtype = np.dtype(np.float64 if precision == 64 else np.float32).newbyteorder(">")
    t, x, y, z = lat.dims
    reim = np.frombuffer(payload, fdtype).astype(np.float64).reshape(t, z, y, x, 4, 3, 3, 2)
    a = reim[..., 0] + 1j * reim[..., 1]
    u = _from_disk_order(a, lat)

    hdr = GaugeHeader(lat=lat, precision=precision)
    if "xlf-info" in recs:
        txt = recs["xlf-info"].data.decode("utf-8", "replace")
        for key, attr, cast in [
            ("plaquette", "plaquette", float),
            ("trajectory nr", "trajectory", int),
            ("beta", "beta", float),
            ("kappa", "kappa", float),
            ("mu", "mu", float),
        ]:
            m = re.search(rf"{key}\s*=\s*([-+0-9.eE]+)", txt)
            if m:
                setattr(hdr, attr, cast(float(m.group(1))))
    return u, hdr
