"""The cases of tests/test_deflation.py and test_dflgcr.py on the port
(CPU), on one deflation setup of the ill-conditioned point, and the
solvers' dispatch seam: the costly part of tests/test_torch_solvers.py,
whose systems (`easy`, `light`) these cases share, in a file of at most 8
tests, which the test runner queues behind tests/test_multirhs.py.
"""

import pytest
import torch

from test_torch_solvers import LAT, _rel, easy, light  # noqa: F401  (fixtures)
from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.solvers import dispatch
from tmlqcd_tpu_torch.solvers.deflation import deflated_fgmres, setup_deflation, vcycle
from tmlqcd_tpu_torch.solvers.krylov import fgmres

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def light_setup(light):
    return setup_deflation(light["mhat_batch"], (4, 3) + LAT.eo_site_shape, rng.Key(2),
                           device="cpu", n_vectors=6, blocks=(2, 2, 2), inv_iters=3,
                           smooth_iters=4)


def test_deflated_fgmres_converges_and_beats_plain(light, light_setup):
    plain = fgmres(light["mhat"], light["b2"], tol=1e-7, restart=10, max_restarts=40)
    defl = deflated_fgmres(light["mhat"], light["b2"], light_setup, tol=1e-7, restart=10,
                           max_restarts=40)
    assert _rel(light["mhat"], defl.x, light["b2"]) < 1e-6
    assert defl.iterations <= plain.iterations


def test_vcycle_reduces_residual(light, light_setup):
    c = vcycle(light_setup, light["mhat"], light["b2"])
    assert _rel(light["mhat"], c, light["b2"]) < 1.0


def test_dflgcr_via_dispatch_converges(light, light_setup):
    x, iters, _ = dispatch.solve_degenerate(light["mhat"], light["b2"], solver="dflgcr",
                                            tol=1e-7, maxiter=400,
                                            deflation_setup=light_setup, restart=10)
    assert _rel(light["mhat"], x, light["b2"]) < 1e-6 and iters >= 1


def test_dispatch_carries_every_route(easy, light, light_setup):
    """Every name of the reference's seam resolves here; the deflated ones
    need their setup; the mixed ones take the low operator."""
    assert sorted(dispatch.SOLVERS) == sorted(
        ["cg", "mixedcg", "rgmixedcg", "bicgstab", "cgs", "fgmres", "gmres", "gcr", "mr",
         "dfl", "dflfgmres", "dflgcr"])
    for name in ("cg", "mixedcg", "rgmixedcg"):
        x, iters, rs = dispatch.solve_degenerate(easy["qpm"], easy["b2"], solver=name.upper(),
                                                 tol=1e-6, maxiter=500)
        assert _rel(easy["qpm"], x, easy["b2"]) < 5e-6 and iters > 0
    for name in ("bicgstab", "cgs", "fgmres", "gmres", "gcr", "mr"):
        x, iters, rs = dispatch.solve_degenerate(easy["mhat"], easy["b2"], solver=name,
                                                 tol=1e-6, maxiter=500)
        assert _rel(easy["mhat"], x, easy["b2"]) < 5e-6 and iters > 0
    for name in ("dfl", "dflfgmres", "dflgcr"):
        with pytest.raises(ValueError, match="deflation_setup"):
            dispatch.solve_degenerate(light["mhat"], light["b2"], solver=name)
        x, _, _ = dispatch.solve_degenerate(light["mhat"], light["b2"], solver=name, tol=1e-7,
                                            maxiter=400, deflation_setup=light_setup,
                                            restart=5)
        assert _rel(light["mhat"], x, light["b2"]) < 1e-6
    seen = []
    lo = lambda x2: seen.append(1) or easy["qpm"](x2)  # noqa: E731
    dispatch.solve_degenerate(easy["qpm"], easy["b2"], solver="mixedcg", tol=1e-6,
                              maxiter=500, matvec_lo=lo)
    assert seen
    with pytest.raises(ValueError, match="unknown solver"):
        dispatch.solve_degenerate(easy["qpm"], easy["b2"], solver="no-such-solver")
