"""The port's slab mesh (tmlqcd_tpu_torch.parallel) against the reference's
device mesh (tmlqcd_tpu.parallel) on the CPU: the mesh built from the
input's NrTProcs..NrZProcs and the automatic one, with the reference's
errors; the halo byte counts; the checkpoint staging round trips; the slab
index helpers against the reference's shards on its 8 virtual devices; and
the random draws, which do not depend on the decomposition.  No reference
program is compiled here.

Deliberate differences, checked as such: a port mesh puts all its slabs on
one device, so it never asks for more devices than there are (the reference
raises), and it checks at construction that T and Y split into even slabs,
which the reference checks in its sharded kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from tmlqcd_tpu import parallel as jpar
from tmlqcd_tpu.io.checkpoint import save_checkpoint as jsave
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu_torch import bridge, parallel, rng
from tmlqcd_tpu_torch.io.checkpoint import save_checkpoint
from tmlqcd_tpu_torch.lattice import Lattice

torch.set_num_threads(1)

DIMS = (8, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)


@pytest.mark.parametrize("procs, shape", [
    ((4, 0, 2, 0), (4, 2)),
    ((2, 1, 1, 1), (2, 1)),
    ((2, 0, 2, 0), (2, 2)),
    ((1, 1, 2, 1), (1, 2)),
    ((0, 0, 0, 0), None),
    ((1, 1, 1, 1), None),
])
def test_mesh_from_procs_matches_reference(procs, shape):
    ref = jpar.mesh_from_procs(procs, JL)
    mine = parallel.mesh_from_procs(procs, LAT, "cpu")
    if shape is None:
        assert ref is None and mine is None
        return
    assert dict(ref.shape) == mine.shape == {"t": shape[0], "m": shape[1]}
    assert (mine.t, mine.y, mine.n_slabs) == (shape[0], shape[1], shape[0] * shape[1])
    assert mine.device == torch.device("cpu")
    loc = mine.local(LAT)
    assert loc.dims == (DIMS[0] // shape[0], DIMS[1], DIMS[2] // shape[1], DIMS[3])


@pytest.mark.parametrize("procs, match", [
    ((2, 2, 1, 1), "NrXProcs=2/NrZProcs=1 unsupported"),
    ((1, 1, 1, 2), "NrXProcs=1/NrZProcs=2 unsupported"),
    ((3, 1, 1, 1), "not divisible by mesh 3x1"),
    ((1, 1, 3, 1), "not divisible by mesh 1x3"),
])
def test_mesh_from_procs_raises_as_reference(procs, match):
    with pytest.raises(ValueError, match=match):
        jpar.mesh_from_procs(procs, JL)
    with pytest.raises(ValueError, match=match):
        parallel.mesh_from_procs(procs, LAT, "cpu")


@pytest.mark.parametrize("procs, match", [
    ((8, 1, 1, 1), "T=8 must split into even slabs over 8 shards"),
    ((1, 1, 4, 1), "Y=4 must split into even slabs over 4 shards"),
])
def test_odd_slabs_raise_at_construction(procs, match):
    """The reference builds these meshes and its sharded kernel raises the
    same message at the first hop; the port raises when the mesh is built."""
    assert jpar.mesh_from_procs(procs, JL) is not None
    with pytest.raises(ValueError, match=match):
        parallel.mesh_from_procs(procs, LAT, "cpu")


def test_more_slabs_than_devices():
    """The reference needs a device per slab; a port mesh holds any number
    of slabs on its one device."""
    lat = JLattice((16, 4, 4, 4))
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        jpar.mesh_from_procs((8, 1, 2, 1), lat)
    mesh = parallel.mesh_from_procs((8, 1, 2, 1), Lattice((16, 4, 4, 4)), "cpu")
    assert mesh.shape == {"t": 8, "m": 2} and mesh.n_slabs == 16


@pytest.mark.parametrize("dims", [(8, 4, 4, 4), (4, 4, 4, 4), (16, 4, 8, 4), (6, 4, 2, 4),
                                  (2, 4, 4, 4)])
def test_auto_shape_matches_reference(dims):
    ref = jpar.auto_mesh(JLattice(dims))
    mine = parallel.auto_shape(Lattice(dims), len(jax.devices()))
    assert (None if ref is None else (ref.shape["t"], ref.shape["m"])) == mine
    # on one device there is no automatic mesh, as in the reference
    assert parallel.auto_mesh(Lattice(dims), ["cpu"]) is None


def test_meshes_over_several_devices_are_not_ported():
    with pytest.raises(NotImplementedError, match="S15b"):
        parallel.auto_mesh(LAT, ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="S15b"):
        parallel.make_mesh((2, 1), ["cpu", "cpu"])
    assert parallel.make_mesh((2, 2), ["cpu"]).shape == {"t": 2, "m": 2}


def test_default_device_raises_without_a_card(monkeypatch):
    """Without a card a mesh's default device raises, naming `device=`,
    where it chose the CPU quietly; the CPU is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: parallel.Mesh(2, 2), lambda: parallel.make_mesh((2, 2)),
                  lambda: parallel.mesh_from_procs((2, 0, 2, 0), LAT),
                  lambda: parallel.auto_mesh(LAT)):
        with pytest.raises(RuntimeError, match="device="):
            build()
    assert parallel.Mesh(2, 2, "cpu").device == torch.device("cpu")


@pytest.mark.parametrize("dims, shape, halfspinor", [
    ((8, 4, 4, 4), (4, 2), True), ((8, 4, 4, 4), (2, 1), False),
    ((64, 32, 32, 32), (4, 2), True), ((32, 16, 16, 16), (1, 2), True),
])
def test_halo_bytes_match_reference(dims, shape, halfspinor):
    ref = jpar.halo_bytes_per_dslash(JLattice(dims), shape, halfspinor)
    assert parallel.halo_bytes_per_dslash(Lattice(dims), shape, halfspinor) == ref


def test_checkpoint_staging_round_trips(tmp_path):
    """gather_to_host / place_from_host / load_gauge_sharded, with a native
    checkpoint written by each package."""
    mesh = parallel.mesh_from_procs((4, 0, 2, 0), LAT, "cpu")
    u = bridge.numpy_su3(np.random.default_rng(5), (4,) + JL.site_shape)
    ut = parallel.place_from_host(u, mesh)
    assert ut.dtype == torch.complex64 and ut.device == mesh.device
    np.testing.assert_array_equal(parallel.gather_to_host(ut), u)
    for path in (save_checkpoint(str(tmp_path / "port"), ut, 3, 17, LAT),
                 jsave(str(tmp_path / "ref"), jnp.asarray(u), trajectory=3, seed=17, lat=JL)):
        back, traj, seed = parallel.load_gauge_sharded(path, mesh, LAT)
        assert (traj, seed) == (3, 17) and back.device == mesh.device
        np.testing.assert_array_equal(back.numpy(), u)


def test_slabs_match_reference_shards():
    """split_slabs gives the reference's per-device shards of a spinor placed
    on its (t, m) mesh, in device order; join_slabs puts them back."""
    psi = bridge.numpy_spinor(np.random.default_rng(6), (4, 3) + JL.eo_site_shape)
    jmesh = jpar.mesh_from_procs((4, 0, 2, 0), JL)
    sharded = jax.device_put(jnp.asarray(psi), NamedSharding(jmesh, jpar.SPINOR_EO_SPEC))
    by_device = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    ref = [by_device[d] for d in jmesh.devices.flat]
    mesh = parallel.mesh_from_procs((4, 0, 2, 0), LAT, "cpu")
    slabs = parallel.split_slabs(torch.as_tensor(psi), LAT, mesh)
    assert len(slabs) == len(ref) == 8
    for mine, theirs in zip(slabs, ref):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    np.testing.assert_array_equal(parallel.join_slabs(slabs, LAT, mesh).numpy(), psi)
    ts, ms = parallel.slab_slices(LAT, mesh, 3, 1)
    assert (ts, ms) == (slice(6, 8), slice(4, 8))


def test_rng_decomposition_independence():
    """The port of tests/test_sharding.py::test_rng_decomposition_independence.
    A draw is a pure function of its key; the slabs of a mesh are views of
    the one drawn field, so the same key gives the same numbers with or
    without a decomposition, slab by slab (the reference's test: its draw is
    the same whether or not the output is sharded).  The trajectory with and
    without a mesh from one key: tests/test_torch_shard_hmc.py."""
    shape = (4, 3) + LAT.eo_site_shape
    key = rng.Key(3, (1, 2))
    whole = rng.normal_spinor(key, shape, "cpu")
    for procs in ((4, 0, 2, 0), (2, 0, 2, 0), (2, 0, 1, 0)):
        mesh = parallel.mesh_from_procs(procs, LAT, "cpu")
        again = rng.normal_spinor(key, shape, mesh.device)
        for a, b in zip(parallel.split_slabs(again, LAT, mesh),
                        parallel.split_slabs(whole, LAT, mesh)):
            assert torch.equal(a, b)
