"""Parity of the PyTorch port's Dirac operator and of its kernels' plain
versions with the JAX reference (tmlqcd_tpu), on the CPU.

The same inputs, drawn from a seeded numpy generator (`bridge.numpy_su3`,
`bridge.numpy_spinor`), go through the JAX function and its port.  The
hopping (epilogue none, 18-real), the gauge-cotangent kernel and the
differentiable hopping are checked against the reference's Pallas kernels in
interpret mode (one `hopping_diff` VJP, as the reference's own tests run the
kernels on the CPU); every (epilogue x 18/12-real) variant on the main path
is checked against the reference's jnp composition (dslash_packed + mee_*),
which for the 12-real copy also checks the row-2 reconstruction against the
full links.

Tolerance: ATOL = 1e-5 absolute on unit-normal inputs.  Both sides compute
in f32 (complex64); an output component sums ~50 products of O(1) numbers in
a different order, so the two differ by f32 rounding of outputs of O(10)
(measured 1e-7 .. 2e-6), while an indexing, sign or phase error is O(1).
"""

import re

import jax
import numpy as np
import pytest
import torch

from tmlqcd_tpu import gamma as jgamma
from tmlqcd_tpu import su3 as jsu3
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import eo_pack as j_eo_pack
from tmlqcd_tpu.lattice import hop_packed as j_hop_packed
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import dslash_pallas as jdp
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import bridge, gamma, su3
from tmlqcd_tpu_torch.lattice import Lattice, eo_pack, eo_unpack, hop_packed, pack_gauge_eo
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf

torch.set_num_threads(1)

ATOL = 1e-5
DIMS = [(4, 4, 4, 4), (8, 4, 4, 4)]  # 4^4 and 4^3 x 8 (M = 8)
KAPPA, MU = 0.15, 0.03


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _gauge(seed, jl):
    return bridge.numpy_su3(np.random.default_rng(seed), (4,) + jl.site_shape)


def _spinor(seed, shape):
    return bridge.numpy_spinor(np.random.default_rng(seed), shape)


@pytest.fixture(scope="module", params=DIMS, ids=["4x4x4x4", "8x4x4x4"])
def fields(request):
    dims = request.param
    jl, lat = JLattice(dims), Lattice(dims)
    u = _gauge(0, jl)
    psi = _spinor(1, (4, 3) + jl.eo_site_shape)
    psi_o = _spinor(2, (4, 3) + jl.eo_site_shape)
    return dict(jl=jl, lat=lat, u=u, psi=psi, psi_o=psi_o,
                jp=jw.DiracParams(kappa=KAPPA, mu=MU), tp=w.DiracParams(kappa=KAPPA, mu=MU))


# ---------------------------------------------------------------------------
# foundations
# ---------------------------------------------------------------------------


def test_gamma_matrices_match_reference():
    np.testing.assert_array_equal(gamma.GAMMA, jgamma.GAMMA)
    np.testing.assert_allclose(gamma.GAMMA5, jgamma.GAMMA5, atol=0)
    psi = _spinor(3, (4, 3, 2, 2, 2))
    out = gamma.apply_gamma5(torch.as_tensor(psi)).numpy()
    np.testing.assert_allclose(out, np.asarray(jgamma.apply_gamma5(psi)), atol=0)


def test_cuda_source_w_table_matches_gamma():
    """The CUDA kernel hard-codes the half-spinor maps W (1 -/+ gamma_mu =
    W W^+) as integer codes; they must equal the maps derived from GAMMA."""
    with open(dc._CSRC + "/hopping.cu") as f:
        rows = re.findall(r"W-TABLE d=(\d) 2:(\d),(\d) 3:(\d),(\d)", f.read())
    assert len(rows) == 8
    value = {0: 0, 1: 1, 2: -1, 3: 1j, 4: -1j}
    for d, c20, c21, c30, c31 in rows:
        wd = np.array([[1, 0], [0, 1], [value[int(c20)], value[int(c21)]],
                       [value[int(c30)], value[int(c31)]]])
        np.testing.assert_array_equal(wd, dc.W[int(d)])
        mu, fb = int(d) // 2, int(d) % 2
        proj = np.eye(4) + (1 if fb else -1) * gamma.GAMMA[mu]
        np.testing.assert_allclose(wd @ wd.conj().T, proj, atol=1e-14)


def test_su3_algebra_matches_reference():
    p = np.array(jax.jit(jsu3.random_momenta, static_argnums=1)(jax.random.key(4), (2, 3, 4)))
    a = torch.as_tensor(p)
    ref = jax.jit(lambda p: (jsu3.expm_ta(p), jsu3.kinetic_energy(p), jsu3.expm_ta(1.5 * p) * 1.01))
    e_ref, k_ref, m = (np.array(x) for x in ref(p))
    pt_ref, ta_ref = (np.asarray(x) for x in jax.jit(
        lambda m: (jsu3.project_su3(m), jsu3.ta_project(m)))(m))
    np.testing.assert_allclose(su3.expm_ta(a).numpy(), e_ref, atol=2e-6)
    np.testing.assert_allclose(su3.project_su3(torch.as_tensor(m)).numpy(), pt_ref, atol=2e-6)
    np.testing.assert_allclose(float(su3.kinetic_energy(a)), float(k_ref), rtol=1e-12)
    np.testing.assert_allclose(su3.ta_project(torch.as_tensor(m)).numpy(), ta_ref, atol=2e-6)
    u = su3.random_su3(torch.Generator().manual_seed(1), (3, 5))
    assert float(su3.unitarity_defect(u)) < 1e-5
    mom = su3.random_momenta(torch.Generator().manual_seed(2), (2000,))
    # traceless anti-hermitian, <|P_ij|^2> summed = 8 per site (8 generators)
    assert float(torch.abs(su3.trace(mom)).max()) < 1e-6
    assert float(torch.abs(mom + su3.adj(mom)).max()) < 1e-6
    assert abs(float(su3.kinetic_energy(mom)) / 2000 - 4.0) < 0.3


def test_eo_packing_and_hops_match_reference(fields):
    jl, lat = fields["jl"], fields["lat"]
    full = _spinor(5, (4, 3) + jl.site_shape)
    ft = torch.as_tensor(full)
    e, o = eo_pack(ft, lat)
    je, jo = j_eo_pack(full, jl)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(eo_unpack(e, o, lat).numpy(), full)
    psi = torch.as_tensor(fields["psi"])
    for p in (0, 1):
        for mu in range(4):
            for d in (+1, -1):
                np.testing.assert_array_equal(hop_packed(psi, p, mu, d, lat).numpy(),
                                              np.asarray(j_hop_packed(fields["psi"], p, mu, d, jl)))


def test_gauge_copy_and_fast_gauge_match_reference(fields):
    jl, lat, u = fields["jl"], fields["lat"], fields["u"]
    ut = bridge.gauge_from_numpy(u, lat)
    ph = jw.boundary_phases(fields["jp"], jl)
    ug = dc.gauge_copy(pack_gauge_eo(ut, lat), lat, ph).numpy()
    assert _maxdiff(ug, jdp.gauge_copy(j_pack(u, jl), jl, ph)) < 1e-6
    for compress in (False, True):
        fj = jwf.make_fast_gauge(u, fields["jp"], jl, compress=compress)
        ft = wf.make_fast_gauge(ut, fields["tp"], lat, compress=compress)
        assert ft.gcomp == fj.gcomp
        assert ft.ug_even.is_contiguous() and ft.ug_odd.is_contiguous()
        assert _maxdiff(ft.ug_even, fj.ug_even) < 1e-6
        assert _maxdiff(ft.ug_odd, fj.ug_odd) < 1e-6
        # the reference's own copy, carried over by the bridge, drives the port's K1
        fb = bridge.fast_gauge_from_numpy(fj.ug_even, fj.ug_odd, fj.gcomp)
        assert fb.gcomp == ft.gcomp
        np.testing.assert_array_equal(bridge.to_numpy(fb.ug_odd), np.asarray(fj.ug_odd))
        psi2 = wf.to_split(torch.as_tensor(fields["psi"]))
        assert _maxdiff(wf.q_hat_pm_fast(fb, psi2, fields["tp"], lat),
                        wf.q_hat_pm_fast(ft, psi2, fields["tp"], lat)) < ATOL


def test_dslash_packed_matches_reference(fields):
    jl, lat = fields["jl"], fields["lat"]
    ph = jw.boundary_phases(fields["jp"], jl)
    ueo_t = pack_gauge_eo(bridge.gauge_from_numpy(fields["u"], lat), lat)
    for p in (0, 1):
        ref = jw.dslash_packed(j_pack(fields["u"], jl), fields["psi"], p, jl, ph)
        out = w.dslash_packed(ueo_t, torch.as_tensor(fields["psi"]), p, lat, ph)
        assert _maxdiff(out, ref) < ATOL


# ---------------------------------------------------------------------------
# K1 plain version: every (epilogue x 18/12-real) variant on the main path
# ---------------------------------------------------------------------------

_EPIS = {
    "none": lambda mt: ("none",),
    "mee_inv+": lambda mt: ("mee_inv", mt, 1.0),
    "mee_inv-": lambda mt: ("mee_inv", mt, -1.0),
    "mhat+g5": lambda mt: ("mhat", mt, 1.0, KAPPA * KAPPA, True),
    "mhat-g5": lambda mt: ("mhat", mt, -1.0, KAPPA * KAPPA, True),
    "mhat+": lambda mt: ("mhat", mt, 1.0, KAPPA * KAPPA, False),
}


def _jnp_reference(fields, p, epi):
    """The reference's jnp composition of K1 + epilogue, complex64."""
    jl = fields["jl"]
    ph = jw.boundary_phases(fields["jp"], jl)
    h = jw.dslash_packed(j_pack(fields["u"], jl), fields["psi"], p, jl, ph)
    if epi[0] == "none":
        return h
    if epi[0] == "mee_inv":
        return jw.mee_inv_packed(h, epi[1], epi[2])
    out = jw.mee_packed(fields["psi_o"], epi[1], epi[2]) - epi[3] * h
    return jgamma.apply_gamma5(out) if epi[4] else out


@pytest.mark.parametrize("compress", [False, True], ids=["18real", "12real"])
@pytest.mark.parametrize("variant", list(_EPIS))
def test_hopping_plain_matches_jnp_composition(fields, variant, compress):
    lat = fields["lat"]
    epi = _EPIS[variant](fields["tp"].mutld)
    fg = wf.make_fast_gauge(bridge.gauge_from_numpy(fields["u"], lat), fields["tp"], lat,
                            compress=compress)
    psi2 = wf.to_split(torch.as_tensor(fields["psi"]))
    psi_o2 = wf.to_split(torch.as_tensor(fields["psi_o"]))
    for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
        out = dc.hopping_split(ug, psi2, p, lat, epi=epi,
                               psi_o=psi_o2 if epi[0] == "mhat" else None, gcomp=fg.gcomp)
        assert _maxdiff(wf.from_split(out), _jnp_reference(fields, p, epi)) < ATOL


# ---------------------------------------------------------------------------
# K2 and HoppingDiff against the reference's hopping_diff VJP (interpret)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hopping_vjp():
    """One reference VJP of hopping_diff at 4^4, parity 0: its forward is the
    Pallas K1 (none, 18-real), its ug cotangent is the Pallas K2."""
    jl, lat = JLattice((4, 4, 4, 4)), Lattice((4, 4, 4, 4))
    u = _gauge(9, jl)
    fg = jwf.make_fast_gauge(u, jw.DiracParams(kappa=KAPPA, mu=MU), jl, compress=False)
    psi2 = jwf.to_split(_spinor(10, (4, 3) + jl.eo_site_shape))
    g2 = jwf.to_split(_spinor(11, (4, 3) + jl.eo_site_shape))
    out, vjp = jax.vjp(lambda a, b: jdp.hopping_diff(a, fg.ug_odd, b, 0, jl, True),
                       fg.ug_even, psi2)
    dug, dpsi = vjp(g2)
    arrays = dict(ug_e=fg.ug_even, ug_o=fg.ug_odd, psi2=psi2, g2=g2, out=out, dug=dug, dpsi=dpsi)
    return lat, {k: np.array(v) for k, v in arrays.items()}


def test_hopping_plain_none_18real_matches_pallas_kernel(hopping_vjp):
    lat, a = hopping_vjp
    out = dc.hopping_split(torch.as_tensor(a["ug_e"]), torch.as_tensor(a["psi2"]), 0, lat)
    assert _maxdiff(out, a["out"]) < ATOL


def test_ug_vjp_plain_matches_pallas_kernel(hopping_vjp):
    lat, a = hopping_vjp
    out = dc.hopping_ug_vjp(torch.as_tensor(a["g2"]), torch.as_tensor(a["psi2"]), 0, lat)
    assert _maxdiff(out, a["dug"]) < ATOL


def test_hopping_diff_gradients_match_reference_vjp(hopping_vjp):
    lat, a = hopping_vjp
    ug_e = torch.tensor(a["ug_e"], requires_grad=True)
    psi2 = torch.tensor(a["psi2"], requires_grad=True)
    out = dc.HoppingDiff.apply(ug_e, torch.as_tensor(a["ug_o"]), psi2, 0, lat)
    dug, dpsi = torch.autograd.grad(out, (ug_e, psi2), torch.as_tensor(a["g2"]))
    assert _maxdiff(out.detach(), a["out"]) < ATOL
    assert _maxdiff(dug, a["dug"]) < ATOL
    assert _maxdiff(dpsi, a["dpsi"]) < ATOL


# ---------------------------------------------------------------------------
# the fast operator and the wrapper's contract
# ---------------------------------------------------------------------------


def test_q_hat_pm_fast_matches_reference(fields):
    jl, lat = fields["jl"], fields["lat"]
    ph = jw.boundary_phases(fields["jp"], jl)
    ueo = j_pack(fields["u"], jl)
    fg = wf.make_fast_gauge(bridge.gauge_from_numpy(fields["u"], lat), fields["tp"], lat)
    psi2 = wf.to_split(torch.as_tensor(fields["psi"]))
    out = wf.from_split(wf.q_hat_pm_fast(fg, psi2, fields["tp"], lat))
    assert _maxdiff(out, jw.q_hat_pm(ueo, fields["psi"], fields["jp"], jl, ph)) < ATOL
    for sign in (+1.0, -1.0):
        out = wf.from_split(wf.q_hat_fast(fg, psi2, fields["tp"], lat, sign))
        assert _maxdiff(out, jw.q_hat(ueo, fields["psi"], fields["jp"], jl, ph, sign)) < ATOL


def test_wrapper_routes_cpu_tensors_to_plain_and_checks_inputs():
    lat = Lattice((4, 4, 4, 4))
    ug = torch.randn((2, 8, 3, 3) + lat.eo_site_shape)
    psi = torch.randn((2, 4, 3) + lat.eo_site_shape)
    dc.reset_counters()
    dc.hopping_split(ug, psi, 0, lat)
    dc.hopping_ug_vjp(psi, psi, 0, lat)
    assert (dc.hopping_split_plain.calls, dc.hopping_ug_vjp_plain.calls) == (1, 1)
    assert (dc.hopping_split.launches, dc.hopping_ug_vjp.launches) == (0, 0)
    with pytest.raises(TypeError):
        dc.hopping_split(ug, psi.double(), 0, lat)
    with pytest.raises(ValueError):
        dc.hopping_split(ug, psi.transpose(-1, -2).contiguous().transpose(-1, -2), 0, lat)
    with pytest.raises(ValueError):
        dc.hopping_split(ug[:, :, :2].contiguous(), psi, 0, lat)  # 12-real without gcomp
    with pytest.raises(ValueError):
        dc.hopping_split(ug, psi, 0, lat, epi=("mhat", 0.1, 1.0, 0.02, True))  # no psi_o
    with pytest.raises(ValueError):
        dc.hopping_split(ug, psi, 0, lat, epi=("clov_inv",))
    with pytest.raises(ValueError):
        dc.hopping_ug_vjp(psi[:, :, :, :2], psi, 0, lat)
