"""ILDG/LIME gauge files, SciDAC propagator files and the checksum of the
port against the JAX reference (tmlqcd_tpu), on the CPU.

Files are byte-level contracts, so the checks are exact: equal records, equal
checksums, arrays equal to the last bit at 64-bit precision (and to f32
rounding of the payload, 6e-8 relative, at 32-bit precision).  Only the
`xlf-info` record may differ between two writes of one field: it carries the
writing package's name and the date.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tmlqcd_tpu import native as jnative
from tmlqcd_tpu.io import checkpoint as jckpt
from tmlqcd_tpu.io import ildg as jildg
from tmlqcd_tpu.io import lime as jlime
from tmlqcd_tpu.io import propagator as jprop
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.io import checkpoint, ildg, lime, propagator
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.native import scidac_checksum

torch.set_num_threads(1)

FROZEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "frozen_2x2x2x2.lime")
DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)


@pytest.fixture(scope="module")
def gauge():
    return bridge.numpy_su3(np.random.default_rng(40), (4,) + JL.site_shape)


@pytest.mark.parametrize("shape, rank0", [((16, 576), 0), ((31 * 29 + 5, 192), 0), ((7, 96), 12345)])
def test_scidac_checksum_matches_reference(shape, rank0):
    data = np.random.default_rng(41).integers(0, 256, shape, dtype=np.uint8)
    assert scidac_checksum(data, rank0) == jnative._checksum_numpy(data, rank0)
    assert scidac_checksum(data, rank0) == jnative.scidac_checksum(data, rank0)


def test_scidac_checksum_combines_over_site_ranges():
    data = np.random.default_rng(42).integers(0, 256, (100, 48), dtype=np.uint8)
    a, b = scidac_checksum(data)
    a1, b1 = scidac_checksum(data[:37], 0)
    a2, b2 = scidac_checksum(data[37:], 37)
    assert (a1 ^ a2, b1 ^ b2) == (a, b)
    with pytest.raises(ValueError):
        scidac_checksum(data[0])


def test_frozen_file_reads_like_reference():
    recs, jrecs = lime.read_lime(FROZEN), jlime.read_lime(FROZEN)
    assert [(r.type, r.data, r.msg_begin, r.msg_end) for r in recs] == \
        [(r.type, r.data, r.msg_begin, r.msg_end) for r in jrecs]
    u, hdr = ildg.read_gauge_field(FROZEN)
    ju, jhdr = jildg.read_gauge_field(FROZEN)
    np.testing.assert_array_equal(u, ju)
    assert hdr.lat.dims == jhdr.lat.dims == (2, 2, 2, 2)
    assert (hdr.precision, hdr.plaquette, hdr.trajectory, hdr.beta, hdr.kappa, hdr.mu) == \
        (jhdr.precision, jhdr.plaquette, jhdr.trajectory, jhdr.beta, jhdr.kappa, jhdr.mu)
    with pytest.raises(ValueError, match="lattice"):
        ildg.read_gauge_field(FROZEN, LAT)


def test_frozen_file_round_trips_byte_for_byte(tmp_path):
    """Reading the frozen file and writing it again gives its records back."""
    u, hdr = ildg.read_gauge_field(FROZEN)
    out = tmp_path / "again.lime"
    ildg.write_gauge_field(str(out), u, hdr.lat, precision=hdr.precision,
                           plaquette=hdr.plaquette, trajectory=hdr.trajectory, beta=hdr.beta,
                           kappa=hdr.kappa, mu=hdr.mu)
    old = {r.type: r.data for r in lime.read_lime(FROZEN)}
    new = {r.type: r.data for r in lime.read_lime(str(out))}
    assert list(new) == list(old)
    for ty in ("ildg-format", "ildg-binary-data", "scidac-checksum"):
        assert new[ty] == old[ty]


@pytest.mark.parametrize("precision", [64, 32])
def test_written_gauge_files_equal_record_by_record(tmp_path, gauge, precision):
    meta = dict(plaquette=0.5871, trajectory=12, beta=5.3, kappa=0.13, mu=0.01)
    p_out, p_ref = str(tmp_path / "torch.lime"), str(tmp_path / "jax.lime")
    ildg.write_gauge_field(p_out, torch.as_tensor(gauge), LAT, precision=precision, **meta)
    jildg.write_gauge_field(p_ref, jnp.asarray(gauge), JL, precision=precision, **meta)
    out, ref = lime.read_lime(p_out), lime.read_lime(p_ref)
    assert [(r.type, r.msg_begin, r.msg_end) for r in out] == \
        [(r.type, r.msg_begin, r.msg_end) for r in ref]
    for a, b in zip(out, ref):
        if a.type == "xlf-info":  # package name and date differ, the numbers do not
            cut = lambda d: d.decode().split(" time = ")[0]  # noqa: E731
            assert cut(a.data) == cut(b.data)
        else:
            assert a.data == b.data
    # each package reads the other's file, checksum verified on the way
    u_out, hdr = ildg.read_gauge_field(p_ref, LAT)
    u_ref, jhdr = jildg.read_gauge_field(p_out, JL)
    np.testing.assert_array_equal(u_out, u_ref)
    tol = 0 if precision == 64 else 1e-7
    assert float(np.max(np.abs(u_out - gauge))) <= tol
    assert (hdr.trajectory, hdr.plaquette, hdr.precision) == (12, 0.5871, precision)
    assert (jhdr.trajectory, jhdr.plaquette) == (12, 0.5871)


def test_corrupted_gauge_file_fails_its_checksum(tmp_path, gauge):
    path = str(tmp_path / "conf.lime")
    ildg.write_gauge_field(path, gauge, LAT)
    recs = lime.read_lime(path)
    data = bytearray(recs[2].data)
    data[1000] ^= 0x01
    recs[2].data = bytes(data)
    lime.write_lime(path, recs)
    with pytest.raises(ValueError, match="checksum mismatch"):
        ildg.read_gauge_field(path, LAT)


def test_ildg_checkpoints_cross_read(tmp_path, gauge):
    """A conf.NNNNNN.lime written by either package resumes in the other."""
    p_ref = jckpt.save_checkpoint(str(tmp_path / "jax"), jnp.asarray(gauge), 7, 44, JL,
                                  fmt="ildg", plaquette=0.5)
    arr, traj, _ = checkpoint.load_checkpoint(p_ref, LAT)
    np.testing.assert_array_equal(arr, gauge.astype(np.complex128))
    assert traj == 7
    p_out = checkpoint.save_checkpoint(str(tmp_path / "torch"), torch.as_tensor(gauge), 9, 45,
                                       LAT, fmt="ildg", plaquette=0.5, beta=5.3)
    assert os.path.basename(p_out) == "conf.000009.lime"
    arr, traj, _ = jckpt.load_checkpoint(p_out, JL)
    np.testing.assert_array_equal(arr, gauge.astype(np.complex128))
    assert traj == 9
    assert jckpt.latest_checkpoint(str(tmp_path / "torch")).trajectory == 9
    assert checkpoint.latest_checkpoint(str(tmp_path / "jax")).path == p_ref
    assert checkpoint.checkpoint_at(str(tmp_path / "torch"), 9).path == p_out


@pytest.mark.parametrize("precision", [64, 32])
def test_propagator_files_round_trip_and_cross_read(tmp_path, precision):
    cols = [bridge.numpy_spinor(np.random.default_rng(43 + i), (4, 3) + JL.site_shape)
            for i in range(3)]
    p_out, p_ref = str(tmp_path / "torch.lime"), str(tmp_path / "jax.lime")
    propagator.write_propagator(p_out, [torch.as_tensor(c) for c in cols], LAT, precision)
    jprop.write_propagator(p_ref, [jnp.asarray(c) for c in cols], JL, precision)
    with open(p_out, "rb") as f, open(p_ref, "rb") as g:
        assert f.read() == g.read()  # no date in a propagator file
    for read, path, lat in ((propagator.read_propagator, p_ref, LAT),
                            (jprop.read_propagator, p_out, JL),
                            (propagator.read_propagator, p_out, LAT)):
        got, prec = read(path, lat)
        assert prec == precision and len(got) == 3
        for g, c in zip(got, cols):
            np.testing.assert_array_equal(g.astype(np.complex64), c)
    recs = lime.read_lime(p_out)
    data = bytearray(recs[3].data)
    data[77] ^= 0x10
    recs[3].data = bytes(data)
    lime.write_lime(p_out, recs)
    with pytest.raises(ValueError, match="checksum mismatch"):
        propagator.read_propagator(p_out, LAT)
