"""The port's domain-decomposed hopping (`dslash_cuda.hopping_shard`,
`hopping_tshard`, the slab kernels' plain versions and the `_shard`
operators of `wilson_fast`) against its own whole-lattice hop and against
the JAX reference (tmlqcd_tpu) on the CPU, at 8x4^3 with meshes (2,1),
(2,2) and (4,2) (T_loc = 4, 4, 2: the first two run the interior kernel
K3-I and the surface kernel K4, the last K4 alone), every (halfspinor,
overlap) pair, one spinor, a batch of R = 3 and a flavour doublet, on the
18-real, 12-real and bf16 gauge copies.

Tolerances:
- sharded against the port's whole-lattice hop: 1e-6 of max|H psi|.  Both
  are the same f32 arithmetic on the same values, except that a
  half-spinor halo reaches the plain stencil rebuilt as 0.5 W (W^+ psi) (the
  dense projector then sums other f32 values), and that the CPU's complex
  multiply takes its vectorised or its scalar path by the layout of its
  operands: a few ulp at outputs of ~10.  (The CUDA kernels agree with K1
  bit for bit: tests/test_torch_cuda.py, chip_smoke.py phase 2.)
- against the reference's jnp hop (`ops/wilson.dslash_packed`, complex64):
  1e-5, the bound of the port's other hop tests (f32 rounding of outputs
  of ~10 in another order);
- one case against the reference's `hopping_pallas_shard` in interpret mode
  on its 8-device rig (mesh (2,2), R = 3, both of its kernels; 1e-5) is in
  tests/test_torch_shard_pallas.py.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.lattice import Lattice as JLattice, pack_gauge_eo as jpack
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge, parallel
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.ndoublet import NDParams
from tmlqcd_tpu_torch.ops.wilson import DiracParams

torch.set_num_threads(1)

DIMS = (8, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
PARAMS = dict(kappa=0.13, mu=0.04, theta=(1.0, 0.3, 0.0, 0.0))
RTOL_PORT = 1e-6
ATOL_REF = 1e-5
MESHES = [(2, 1), (2, 2), (4, 2)]
PAIRS = list(itertools.product((True, False), (True, False)))


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _data():
    """The gauge copies and the inputs of the checks, from numpy seeds."""
    u = bridge.numpy_su3(np.random.default_rng(61), (4,) + JL.site_shape)
    gen = np.random.default_rng(62)
    psi = bridge.numpy_spinor(gen, (4, 3) + JL.eo_site_shape)
    cols = bridge.numpy_spinor(gen, (3, 4, 3) + JL.eo_site_shape)
    chi = bridge.numpy_spinor(gen, (2, 4, 3) + JL.eo_site_shape)
    ut = bridge.gauge_from_numpy(u, LAT)
    tp = DiracParams(**PARAMS)
    fg12 = wf.make_fast_gauge(ut, tp, LAT)
    gauges = {"18": wf.make_fast_gauge(ut, tp, LAT, compress=False), "12": fg12,
              "bf16": wf.sloppy_gauge(fg12)}
    inputs = {None: wf.to_split(torch.as_tensor(psi)),
              3: wf.to_split_rhs(torch.as_tensor(cols)),
              1: wf.to_split(torch.as_tensor(chi))}
    return dict(u=u, ut=ut, tp=tp, gauges=gauges, inputs=inputs, psi=psi, cols=cols, chi=chi)


@pytest.fixture(scope="module")
def fields():
    f = _data()
    # the reference's jnp hop of every input column, both parities, in one
    # batch: [psi, cols 0..2, chi flavours 0..1]
    batch = np.concatenate([f["psi"][None], f["cols"], f["chi"]])
    ph = jw.boundary_phases(jw.DiracParams(**PARAMS), JL)
    ueo = jpack(jnp.asarray(f["u"]), JL)
    ref = {p: np.asarray(jax.jit(jax.vmap(lambda x, p=p: jw.dslash_packed(ueo, x, p, JL, ph)))(
        batch)) for p in (EVEN, ODD)}
    return dict(f, ref=ref)


def _ref_of(ref_p: np.ndarray, r_axis) -> np.ndarray:
    """The reference's hop of one input, in the port's complex layout."""
    if r_axis is None:
        return ref_p[0]
    if r_axis == 3:
        return np.moveaxis(ref_p[1:4], 0, 2)  # [4, 3, R, *sites]
    return ref_p[4:6]  # [2 flavour, 4, 3, *sites]


def _whole(fg, x, p, r_axis):
    ug = fg.ug_even if p == EVEN else fg.ug_odd
    if r_axis is None:
        return dc.hopping_split(ug, x, p, LAT, gcomp=fg.gcomp)
    return dc.hopping_split_rhs(ug, x, p, LAT, gcomp=fg.gcomp, r_axis=r_axis)


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("halfspinor, overlap", PAIRS, ids=lambda v: str(int(v)))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_shard_matches_whole_lattice_hop_and_reference(fields, shape, halfspinor, overlap):
    """The assembled sharded hop against the port's whole-lattice hop (f32
    and bf16 gauges) and the reference's jnp hop (f32 gauges), for one
    spinor, R = 3 and the doublet, both parities."""
    mesh = parallel.Mesh(*shape, device="cpu", halfspinor=halfspinor, overlap=overlap)
    dc.reset_counters()
    for (gname, fg), (r_axis, x), p in itertools.product(fields["gauges"].items(),
                                                         fields["inputs"].items(), (EVEN, ODD)):
        ug = fg.ug_even if p == EVEN else fg.ug_odd
        out = dc.hopping_shard(ug, x, p, LAT, mesh, fg.gcomp, r_axis)
        whole = _whole(fg, x, p, r_axis)
        assert out.shape == x.shape
        scale = float(whole.abs().max())
        err = float((out - whole).abs().max())
        assert err <= RTOL_PORT * scale, (gname, r_axis, p, err)
        if gname != "bf16":
            got = wf.from_split(out) if r_axis != 3 else wf.from_split_rhs(out).movedim(0, 2)
            assert _maxdiff(got, _ref_of(fields["ref"][p], r_axis)) < ATOL_REF, (gname, r_axis, p)
    # the CPU path ran the kernels' plain versions, one slab call per hop:
    # K3 without overlap, else KH's halos and K3-I+K4 over every row
    assert dc.hopping_slab_split_plain.calls == 3 * 3 * 2
    assert dc.halo_pack.plain_calls == (3 * 3 * 2 if overlap else 0)
    assert sum(dc.hopping_slab_split.launches.values()) == 0


@pytest.mark.parametrize("halfspinor", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("t_shards", [2, 4])
def test_tshard_matches_reference(fields, t_shards, halfspinor):
    """K1-T (`hopping_tshard`, t slabs with concatenated t halos, y hops
    wrapping inside the slab) against the reference's jnp hop and the port's
    whole-lattice hop."""
    mesh = parallel.Mesh(t_shards, 1, "cpu", halfspinor=halfspinor)
    dc.reset_counters()
    fg, x = fields["gauges"]["12"], fields["inputs"][None]
    for p, ug in ((EVEN, fg.ug_even), (ODD, fg.ug_odd)):
        out = dc.hopping_tshard(ug, x, p, LAT, mesh, fg.gcomp)
        whole = _whole(fg, x, p, None)
        assert float((out - whole).abs().max()) <= RTOL_PORT * float(whole.abs().max())
        assert _maxdiff(wf.from_split(out), fields["ref"][p][0]) < ATOL_REF
    assert dc.hopping_slab_split_plain.calls == 2
    with pytest.raises(ValueError, match="t only"):
        dc.hopping_tshard(fg.ug_even, x, EVEN, LAT, parallel.Mesh(2, 2, "cpu"))


def test_mesh_options_pick_the_kernel(fields, monkeypatch):
    """The mesh's `overlap` and `halfspinor` set the sharded hop:
    overlap runs KH's halos and K3-I+K4 (the slab kernel over every row), no
    overlap K3; on t slabs alone no y halo is built and the y hops wrap
    inside the slab (without overlap: K1-T)."""
    seen = []
    plain = dc.hopping_slab_split_plain

    def spy(*a, **k):
        seen.append((a[5], a[8] is not None))  # (variant, y halos given)
        return plain(*a, **k)

    spy.calls = 0  # the plain version counts its calls on the module attribute
    monkeypatch.setattr(dc, "hopping_slab_split_plain", spy)
    fg, x = fields["gauges"]["12"], fields["inputs"][None]
    whole = _whole(fg, x, EVEN, None)
    for mesh, want in ((parallel.Mesh(2, 2, "cpu"), [("all", True)]),
                       (parallel.Mesh(2, 2, "cpu", overlap=False), [("ext", True)]),
                       (parallel.Mesh(2, 1, "cpu", overlap=False), [("ext", False)]),
                       (parallel.Mesh(2, 1, "cpu", halfspinor=False), [("all", False)])):
        seen.clear()
        out = wf.hop_shard(fg, x, EVEN, LAT, mesh)
        assert seen == want, (mesh, seen)
        assert float((out - whole).abs().max()) <= RTOL_PORT * float(whole.abs().max())


def test_slab_wrapper_checks_inputs(fields):
    fg, x = fields["gauges"]["12"], fields["inputs"][None]
    mesh = parallel.Mesh(4, 2, "cpu")
    out = torch.empty_like(x)
    with pytest.raises(ValueError, match="needs T_loc >= 4"):
        dc.hopping_slab_split(fg.ug_even, x, EVEN, LAT, mesh, "int", out, gcomp=fg.gcomp,
                              mh=torch.zeros((2, 4, 3, 16, 4, 4)))
    with pytest.raises(ValueError, match="needs the t halos"):
        dc.hopping_slab_split(fg.ug_even, x, EVEN, LAT, mesh, "bnd", out, gcomp=fg.gcomp,
                              mh=torch.zeros((2, 4, 3, 16, 4, 4)))
    with pytest.raises(ValueError, match="needs the y halos"):
        dc.hopping_slab_split(fg.ug_even, x, EVEN, LAT, mesh, "ext", out, gcomp=fg.gcomp)
    with pytest.raises(ValueError, match="needs the t halos"):
        dc.hopping_slab_split(fg.ug_even, x, EVEN, LAT, mesh, "all", out, gcomp=fg.gcomp,
                              mh=torch.zeros((2, 4, 3, 16, 4, 4)))
    with pytest.raises(ValueError, match="unknown slab variant"):
        dc.hopping_slab_split(fg.ug_even, x, EVEN, LAT, mesh, "rows", out)
    with pytest.raises(ValueError, match="shape"):  # psi is not the extended field
        dc.hopping_slab_split(fg.ug_even, x, EVEN, LAT, parallel.Mesh(2, 1, "cpu"), "ext", out,
                              gcomp=fg.gcomp)
    with pytest.raises(TypeError, match="float32"):
        dc.hopping_shard(fg.ug_even, x.double(), EVEN, LAT, mesh, gcomp=fg.gcomp)
    with pytest.raises(ValueError, match="even slabs"):
        dc.hopping_shard(fg.ug_even, x, EVEN, LAT, parallel.Mesh(8, 1, "cpu"), gcomp=fg.gcomp)


def test_shard_operators_match_whole_lattice(fields):
    """The `_shard` operators on mesh (2,2) against the whole-lattice
    operators: Qhat_pm (one spinor and a batch), Mhat(-), Qsw_pm, Q_nd^2 and
    Q_nd^sw^2.  The diagonals are the same tensor arithmetic on both sides;
    1e-6 of the output scale."""
    mesh = parallel.Mesh(2, 2, "cpu")
    ut, tp, fg = fields["ut"], fields["tp"], fields["gauges"]["12"]
    cp = DiracParams(kappa=0.13, mu=0.04, c_sw=1.3, theta=PARAMS["theta"])
    ndp = NDParams(kappa=0.13, mubar=0.12, epsbar=0.15, theta=PARAMS["theta"])
    ndc = NDParams(kappa=0.13, mubar=0.12, epsbar=0.15, c_sw=1.3, theta=PARAMS["theta"])
    fc, fcn = wf.make_fast_clover(ut, cp, LAT), wf.make_fast_clover_nd(ut, ndc, LAT)
    x, xs, chi = fields["inputs"][None], fields["inputs"][3], fields["inputs"][1]
    cases = [
        (wf.q_hat_pm_fast_shard(fg, x, tp, LAT, mesh), wf.q_hat_pm_fast(fg, x, tp, LAT)),
        (wf.q_hat_pm_fast_shard(fg, xs, tp, LAT, mesh, r_axis=3),
         wf.q_hat_pm_fast(fg, xs, tp, LAT, r_axis=3)),
        (wf.m_hat_fast_shard(fg, x, tp, LAT, dataclasses.replace(mesh, overlap=False),
                             sign=-1.0),
         wf.m_hat_fast(fg, x, tp, LAT, -1.0)),
        (wf.q_hat_pm_clover_fast_shard(fc, x, cp, LAT, dataclasses.replace(mesh, halfspinor=False)),
         wf.q_hat_pm_clover_fast(fc, x, cp, LAT)),
        (wf.q_hat_pm_clover_fast_shard(fc, xs, cp, LAT, mesh, r_axis=3),
         wf.q_hat_pm_clover_fast(fc, xs, cp, LAT, r_axis=3)),
        (wf.q_nd_sq_fast_shard(fg, chi, ndp, LAT, mesh), wf.q_nd_sq_fast(fg, chi, ndp, LAT)),
        (wf.q_nd_sq_clover_fast_shard(fcn, chi, ndc, LAT, mesh),
         wf.q_nd_sq_clover_fast(fcn, chi, ndc, LAT)),
    ]
    for k, (mine, whole) in enumerate(cases):
        assert mine.shape == whole.shape
        assert float((mine - whole).abs().max()) <= RTOL_PORT * float(whole.abs().max()), k


@pytest.mark.parametrize("compress", [True, False], ids=["12real", "18real"])
def test_rhs_bf16_plain_equals_columns_of_k1b(fields, compress):
    """1R-B: the plain multi-RHS hop on a bf16 gauge equals R single hops on
    it bit for bit, in the twisted-mass epilogues and on the doublet axis;
    its CUDA kernel is held to R launches of K1-B on the card
    (tests/test_torch_cuda.py, chip_smoke.py phase 2)."""
    fg = wf.sloppy_gauge(wf.make_fast_gauge(fields["ut"], fields["tp"], LAT, compress=compress))
    xs, chi = fields["inputs"][3], fields["inputs"][1]
    tp = fields["tp"]
    for epi in (("none",), ("mee_inv", tp.mutld, 1.0), ("mhat", tp.mutld, -1.0, 0.0169, True)):
        psi_o = xs.flip(3).contiguous() if epi[0] == "mhat" else None
        out = dc.hopping_split_rhs(fg.ug_odd, xs, ODD, LAT, epi=epi, psi_o=psi_o,
                                   gcomp=fg.gcomp)
        for r in range(xs.shape[3]):
            one = dc.hopping_split(fg.ug_odd, xs[:, :, :, r].contiguous(), ODD, LAT, epi=epi,
                                   psi_o=None if psi_o is None else psi_o[:, :, :, r].contiguous(),
                                   gcomp=fg.gcomp)
            assert torch.equal(out[:, :, :, r], one), (epi[0], r)
    out = dc.hopping_split_rhs(fg.ug_even, chi, EVEN, LAT, gcomp=fg.gcomp, r_axis=1)
    for f in range(2):
        assert torch.equal(out[:, f],
                           dc.hopping_split(fg.ug_even, chi[:, f].contiguous(), EVEN, LAT,
                                            gcomp=fg.gcomp))
