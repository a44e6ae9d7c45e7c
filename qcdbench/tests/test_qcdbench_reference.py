"""The benchmark's plain reference against the port's plain CPU routes at 4^4:
the full twisted-mass and twisted-clover operators, the Schur complement,
the gauge action and plaquette, one HMC trajectory on the same draws, and a
propagator of the port's batched inverter held to the reference operator.
The test imports both; the reference imports nothing of the port."""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import fields  # noqa: E402
import workload  # noqa: E402
from reference import hmc as ref_hmc  # noqa: E402
from reference import ops  # noqa: E402
from tmlqcd_tpu_torch import lattice as plat  # noqa: E402
from tmlqcd_tpu_torch.ops import clover as pcl  # noqa: E402
from tmlqcd_tpu_torch.ops import gauge_action as pga  # noqa: E402
from tmlqcd_tpu_torch.ops import wilson as pw  # noqa: E402

DIMS = (4, 4, 4, 4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def gauge():
    """A rough but not random field: a hot field half way smoothed."""
    gen = fields.generator(CPU, "test", 1)
    hot = fields.random_su3((4,) + DIMS, gen, CPU)
    eye = torch.eye(3, dtype=torch.complex64).reshape(3, 3, 1, 1, 1, 1, 1)
    return ref_hmc.reunitarize(0.5 * hot + eye).to(torch.complex128)


def _spinor(shape, seed):
    return fields.gaussian(shape, fields.generator(CPU, "psi", seed), CPU).to(torch.complex128)


def _prog(f):
    return f.reshape(f.shape[:-2] + (f.shape[-2] * f.shape[-1],))


@pytest.mark.parametrize("c_sw", [0.0, 1.74])
def test_full_operator_matches_port(gauge, c_sw):
    kappa, mutld = 0.16, 0.013
    psi = _spinor((4, 3) + DIMS, 2)
    lat = plat.Lattice(DIMS)
    params = pw.DiracParams(kappa=kappa, mu=mutld / (2 * kappa), c_sw=c_sw)
    ug = _prog(gauge)
    if c_sw:
        want = (pcl.sw_apply(pcl.sw_blocks(ug, kappa, c_sw, lat), _prog(psi), mutld)
                - kappa * pw.dslash_full(ug, _prog(psi), pw.boundary_phases(params, lat), lat))
    else:
        want = pw.d_full(ug, _prog(psi), params, lat)
    got = ops.Operator(gauge, kappa, mutld, c_sw)(psi)
    np.testing.assert_allclose(_prog(got).numpy(), want.numpy(), atol=1e-12)
    dag = ops.Operator(gauge, kappa, mutld, c_sw).dagger
    chi = _spinor((4, 3) + DIMS, 3)
    m = ops.Operator(gauge, kappa, mutld, c_sw)
    lhs = torch.vdot(chi.flatten(), m(psi).flatten())
    rhs = torch.vdot(dag(chi).flatten(), psi.flatten())
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


def test_schur_matches_port(gauge):
    kappa, mutld = 0.16, 0.013
    lat = plat.Lattice(DIMS)
    params = pw.DiracParams(kappa=kappa, mu=mutld / (2 * kappa))
    ph = pw.boundary_phases(params, lat)
    eta = _spinor((4, 3, 4, 4, 8), 4)
    x = ref_hmc.unpack_odd(eta, DIMS)
    sch = ops.Schur(gauge, kappa, mutld)
    ueo = plat.pack_gauge_eo(_prog(gauge), lat)
    for sign in (+1.0, -1.0):
        got = plat.eo_pack(_prog(sch.q_hat(x, sign)), lat)[1]
        want = pw.q_hat(ueo, eta, params, lat, ph, sign)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)
    assert float(_prog(sch.q_hat(x, 1.0)).abs()[..., ~_prog(ops.odd_mask(DIMS, CPU))].max()) == 0


@pytest.mark.parametrize("action,c1", [("tlsym", -1.0 / 12.0), ("iwasaki", -0.331)])
def test_gauge_action_and_plaquette_match_port(gauge, action, c1):
    lat = plat.Lattice(DIMS)
    assert ref_hmc.GAUGE_C1[action] == c1
    got = float(ops.gauge_action(gauge, 3.9, c1))
    want = float(pga.gauge_action(_prog(gauge), 3.9, lat, c1))
    assert abs(got - want) < 1e-10 * abs(want)
    assert abs(ops.plaquette(gauge) - float(pga.plaquette(_prog(gauge), lat))) < 1e-12


def _mini_cfg():
    import json

    with open(os.path.join(HERE, "configs", "b40.24.json")) as fh:
        cfg = json.load(fh)
    cfg["lattice"] = {"T": 4, "LX": 4, "LY": 4, "LZ": 4}
    cfg["hmc"]["integrator"]["steps"] = [1, 1, 2]
    cfg["field"].update(trajectories=3, steps=4)
    return cfg


def test_trajectory_matches_port():
    """The reference follows the port's trajectory on its draws from a hot
    start: dH to f32 rounding of the energy the trajectory moved."""
    w = workload.Trajectories(_mini_cfg(), {"kind": "trajectories", "start": "hot"}, 11, CPU,
                              lambda m: None)
    rec = w.unit(0)
    w.release()
    assert abs(rec["dh"]) > 0.1
    assert w.check([rec], 11)["dh_rel"] < 1e-6


def test_propagator_residual_against_reference(tmp_path, monkeypatch):
    """A batched 12-column solve of the port meets the reference operator."""
    monkeypatch.setattr(fields, "CACHE", str(tmp_path))
    cfg = _mini_cfg()
    cfg["_path"] = os.path.join(HERE, "configs", "b40.24.json")
    w = workload.Propagators(cfg, {"kind": "propagators", "source": "point", "columns": 12,
                                   "sites": 8, "site_seed": 1, "warmup_iterations": 2}, 5, CPU, lambda m: None)
    rec = w.unit(0)
    w.release()
    assert w.check([rec], 5)["resid"] < 1e-5
