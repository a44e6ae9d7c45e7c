"""KH (`dslash_cuda.halo_pack`), the halo exchange of a sharded hop in one
kernel, on the CPU.  Its plain version is the torch exchange (`_y_halos`,
`_t_halos`: slice, project, roll, rebuild); here each halo it returns is
held, element for element, to the slab the kernel reads it from by index
(the y-row or timeslice of the neighbouring slab) and to the dense
projector 0.5 (1 -/+ gamma_mu) on it, on meshes (2,1), (2,2) and (4,2),
with half-spinor halos and without, for one spinor, a batch (`r_axis=3`)
and a flavour doublet (`r_axis=1`).  The sharded hop with the overlap runs
through it.  The port alone: no reference program is compiled here (the
sharded hop's parity with the reference is held by `test_torch_shard.py`).
The kernel is held to the torch exchange on the card by
`test_torch_cuda.py` and `chip_smoke.py`."""

import dataclasses

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import parallel, rng, su3
from tmlqcd_tpu_torch.gamma import GAMMA
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.wilson import DiracParams

torch.set_num_threads(1)

# T = 16 (T_loc 8 or 4), Y = 8 (Y_loc 8 or 4): both y halo sides distinct
LAT = Lattice((16, 4, 8, 4))


def _fields() -> dict:
    g = np.random.default_rng(21)
    site = LAT.eo_site_shape

    def draw(shape):
        return torch.tensor(g.standard_normal(shape), dtype=torch.float32)

    return {None: draw((2, 4, 3) + site), 1: draw((2, 2, 4, 3) + site),
            3: draw((2, 4, 3, 3) + site)}


def _projected(src: torch.Tensor, d: int, spin_axis: int, halfspinor: bool) -> torch.Tensor:
    """The halo of direction d (0, 1: t forward / backward; 4, 5: y) the
    receiving slab holds for the source rows `src`: 0.5 (1 -/+ gamma_mu) src
    with the half-spinor halo (the projector is real for mu = 0, 2), else
    src itself."""
    if not halfspinor:
        return src
    mu = d // 2
    proj = np.eye(4) - GAMMA[mu] if d % 2 == 0 else np.eye(4) + GAMMA[mu]
    assert not proj.imag.any()
    pm = torch.tensor(0.5 * proj.real, dtype=src.dtype)
    return torch.tensordot(pm, src.movedim(spin_axis, 0), dims=1).movedim(0, spin_axis)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2)])
def test_halo_pack_equals_the_torch_exchange(shape):
    """halo_pack on CPU tensors (its plain version, the torch exchange)
    puts into every slab's halo slots the rows KH reads by index: below
    slab row i the last timeslice of row i-1 (direction 1), above it the
    first of row i+1 (direction 0); below slab column j the last y-row of
    column j-1 (direction 5), above it the first of column j+1 (direction
    4), projected with the half-spinor halo.  One spinor, the doublet and a
    batch of 3, half-spinor halos on and off; no y halo with one y slab."""
    dc.reset_counters()
    n = 0
    t, x_len, _, _ = LAT.dims
    mt, my = shape
    tl, ml, zh = t // mt, LAT.m // my, LAT.zh
    for hs in (True, False):
        mesh = parallel.Mesh(*shape, device="cpu", halfspinor=hs)
        for r_axis, x in _fields().items():
            ax = 2 if r_axis == 1 else 1
            mh, th = dc.halo_pack(x, LAT, mesh, r_axis)
            th = th.unflatten(-3, (2, mt))
            for i in range(mt):
                for side, d, row in ((0, 1, ((i - 1) % mt) * tl + tl - 1),
                                     (1, 0, ((i + 1) % mt) * tl)):
                    want = _projected(x[..., row, :, :], d, ax, hs)
                    assert torch.equal(th[..., side, i, :, :], want), (hs, r_axis, i, side)
            if my == 1:
                assert mh is None
            else:
                mh = mh.unflatten(-3, (2, t)).unflatten(-1, (my, zh))
                for j in range(my):
                    for side, d, m0 in ((0, 5, ((j - 1) % my) * ml + ml - zh),
                                        (1, 4, ((j + 1) % my) * ml)):
                        want = _projected(x[..., m0:m0 + zh], d, ax, hs)
                        assert torch.equal(mh[..., side, :, :, j, :], want), (hs, r_axis, j, side)
            assert float(th.abs().max()) > 0.1
            n += 1
    assert dc.halo_pack.plain_calls == n and dc.halo_pack.launches == 0


def test_sharded_hop_runs_kh_and_equals_the_torch_exchange_route():
    """hopping_shard with the overlap takes its halos from halo_pack (its
    plain version here) and gives, bit for bit, K3-I and K4 on those halos;
    without the overlap it runs K3 on the torch exchange directly."""
    u = su3.random_su3(rng.generator(rng.Key(5), "cpu"), (4,) + LAT.site_shape)
    fg = wf.make_fast_gauge(u, DiracParams(kappa=0.13, mu=0.01), LAT)
    for r_axis, x in _fields().items():
        for shape in ((4, 2), (2, 1)):
            mesh = parallel.Mesh(*shape, device="cpu")
            dc.reset_counters()
            out = dc.hopping_shard(fg.ug_odd, x, 1, LAT, mesh, fg.gcomp, r_axis)
            assert dc.halo_pack.plain_calls == 1
            mh = dc._y_halos(x, LAT, mesh, True, r_axis)
            ref = torch.empty_like(x)
            kw = dict(mh=mh, gcomp=fg.gcomp, r_axis=r_axis)
            dc.hopping_slab_split_plain(fg.ug_odd, x, 1, LAT, mesh, "int", ref, **kw)
            dc.hopping_slab_split_plain(fg.ug_odd, x, 1, LAT, mesh, "bnd", ref,
                                        th=dc._t_halos(x, LAT, mesh, True, r_axis), **kw)
            assert torch.equal(out, ref), (r_axis, shape)
            flat = dataclasses.replace(mesh, overlap=False)
            dc.reset_counters()
            dc.hopping_shard(fg.ug_odd, x, 1, LAT, flat, fg.gcomp, r_axis)
            assert dc.halo_pack.plain_calls == 0 and dc.hopping_slab_split_plain.calls == 1


def test_halo_pack_raises():
    """KH's wrapper raises on a field of the wrong shape or type, a mesh
    that does not split the lattice into even slabs, an R axis the kernels
    do not take, and a device with no kernel (no fallback)."""
    x = _fields()[None]
    mesh = parallel.Mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="psi has shape"):
        dc.halo_pack(x[:, :, :, :8].contiguous(), LAT, mesh)
    with pytest.raises(TypeError, match="psi must be float32"):
        dc.halo_pack(x.double(), LAT, mesh)
    with pytest.raises(ValueError, match="even slabs"):
        dc.halo_pack(x, LAT, parallel.Mesh(3, 1, device="cpu"))
    with pytest.raises(ValueError, match="r_axis = 2"):
        dc.halo_pack(_fields()[3], LAT, mesh, r_axis=2)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        dc.halo_pack(x.to("meta"), LAT, parallel.Mesh(2, 2, device="meta"))
