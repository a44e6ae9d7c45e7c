"""Parity of the port's doublet inverter with the JAX reference (tmlqcd_tpu),
on the CPU: `invert_doublet_eo` for the DBTMWILSON and DBCLOVER operators and
`cli.invert` on sample-input/invert0-doublet.input cut to 4^4.

Inputs come from seeded numpy generators through `bridge`.  The port runs
its plain path (CPU tensors: split f32 doublets); the reference its complex
jnp operator.  At tol 1e-7: equal iteration counts (f64 norms on both
sides), solutions to 1e-5 on entries of O(1), and the true residual
|M_nd x - b| / |b| <= 1e-5 with the plain unpreconditioned doublet operator
on the full lattice.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.inverter import invert_doublet_eo as j_invert_doublet_eo
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import ndoublet as jnd
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd
from tmlqcd_tpu_torch.inverter import invert_doublet_eo
from tmlqcd_tpu_torch.io import checkpoint
from tmlqcd_tpu_torch.io.propagator import read_propagator
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import wilson as w

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
SAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "sample-input")
# invert0-doublet's operators: kappa, 2Kappamubar, 2Kappaepsbar, CSW
KAPPA = 0.1400645
ND = dict(kappa=KAPPA, mubar=0.0390 / (2 * KAPPA), epsbar=0.0333 / (2 * KAPPA))
CSW = {"DBTMWILSON": 0.0, "DBCLOVER": 1.74}


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _m_nd_full(u, x, params, lat):
    """The unpreconditioned doublet operator on the full lattice:
    (1 [+ T] + i mubar g5 tau3 + epsbar tau1) x - kappa H x."""
    if params.c_sw != 0.0:
        diag = cl.mee_nd_clover(cl.sw_blocks(u, params.kappa, params.c_sw, lat), x,
                                params.mubar_t, params.epsbar_t)
    else:
        diag = nd.mee_nd(x, params.mubar_t, params.epsbar_t)
    ph = w.boundary_phases(params.wilson, lat)
    return diag - params.kappa * torch.stack([w.dslash_full(u, x[f], ph, lat) for f in range(2)])


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(90), (4,) + JL.site_shape)
    return u, bridge.gauge_from_numpy(u, LAT)


@pytest.fixture(scope="module")
def sources():
    """A point source in the upper flavour (what the CLI solves) and a
    gaussian doublet."""
    src = np.zeros((2, 2, 4, 3) + JL.site_shape, np.complex64)
    src[0, 0, 0, 0, 0, 0, 0] = 1.0
    src[1] = bridge.numpy_spinor(np.random.default_rng(91), (2, 4, 3) + JL.site_shape)
    return src


@pytest.mark.parametrize("op", ["DBTMWILSON", "DBCLOVER"])
def test_invert_doublet_eo_matches_reference(gauge, sources, op):
    u, ut = gauge
    jp, tp = jnd.NDParams(c_sw=CSW[op], **ND), nd.NDParams(c_sw=CSW[op], **ND)
    solve = jax.jit(lambda b: j_invert_doublet_eo(jnp.asarray(u), b, jp, JL, tol=1e-7,
                                                  maxiter=500))
    for r in range(2):
        ref = solve(jnp.asarray(sources[r]))
        b = torch.as_tensor(sources[r])
        out = invert_doublet_eo(ut, b, tp, LAT, tol=1e-7, maxiter=500)
        assert out.iterations == int(ref.iterations) and 5 < out.iterations < 500
        assert tuple(out.x.shape) == (2, 4, 3) + LAT.site_shape and out.x.dtype == torch.complex64
        assert _maxdiff(out.x, ref.x) < 1e-5
        res = _m_nd_full(ut, out.x, tp, LAT) - b
        assert float(torch.linalg.vector_norm(res) / torch.linalg.vector_norm(b)) < 1e-5
        # epsbar mixes the flavours: a source in the upper flavour alone
        # has a solution in both
        assert float(out.x[1].abs().max()) > 1e-4


def test_doublet_operators_pass_the_inverter_check():
    with open(os.path.join(SAMPLES, "invert0-doublet.input")) as f:
        cfg = config_tmlqcd.parse_input(f.read())
    config.check_invert_ported(cfg)
    assert [(o.type, o.csw, o.two_kappa_mubar, o.two_kappa_epsbar) for o in cfg.operators] == \
        [("DBTMWILSON", 0.0, 0.039, 0.0333), ("DBCLOVER", 1.74, 0.039, 0.0333)]
    assert cfg.lat.dims == (16, 8, 8, 8)


@pytest.mark.parametrize("fmt", ["npz", "lime"])
def test_cli_invert_doublet_end_to_end(tmp_path, gauge, fmt):
    """invert0-doublet.input as shipped but for L = T = 4 and
    SolverPrecision 1e-14, through the CLI on the CPU: both operators, one z2
    source column each (npz) or the 12 point-source columns of DBTMWILSON
    (lime, one file per flavour)."""
    from tmlqcd_tpu_torch.cli import invert as cli

    with open(os.path.join(SAMPLES, "invert0-doublet.input")) as f:
        text = f.read()
    text = re.sub(r"(?m)^L = 8$", "L = 4", text)
    text = re.sub(r"(?m)^T = 16$", "T = 4", text)
    text = text.replace("SolverPrecision = 1e-18", "SolverPrecision = 1e-14")
    if fmt == "lime":
        text = text[:text.index("BeginOperator DBCLOVER")]
    inp = tmp_path / "doublet.input"
    inp.write_text(text)
    conf = checkpoint.save_checkpoint(str(tmp_path / "confs"), gauge[1], 3, 1, LAT)
    out = tmp_path / "out"
    extra = ["--source", "z2"] if fmt == "npz" else []
    assert cli.main(["-f", str(inp), "-c", conf, "--format", fmt, "--cpu", "-o", str(out),
                     *extra]) == 0
    if fmt == "npz":
        for iop, op in enumerate(("DBTMWILSON", "DBCLOVER")):
            with np.load(out / f"propagator.{iop:02d}.000003.npz") as f:
                x = torch.as_tensor(f["propagator_doublet"])
                assert float(f["csw"]) == CSW[op] and abs(float(f["mubar"]) - ND["mubar"]) < 1e-12
            assert tuple(x.shape) == (1, 2, 4, 3) + LAT.site_shape
            tp = nd.NDParams(c_sw=CSW[op], **ND)
            mx = _m_nd_full(gauge[1], x[0], tp, LAT)
            # M x reproduces the z2 source: unit modulus on timeslice 0 of the
            # upper flavour, nothing elsewhere
            assert float((mx[0, :, :, 0].abs() - 1.0).abs().max()) < 1e-4
            assert float(mx[0, :, :, 1:].abs().max()) < 1e-4 and float(mx[1].abs().max()) < 1e-4
    else:
        cols = [read_propagator(str(out / f"propagator.00.fl{f}.000003.lime"), LAT)[0]
                for f in range(2)]
        assert len(cols[0]) == len(cols[1]) == 12
        tp = nd.NDParams(**ND)
        for i in (0, 7):
            x = torch.stack([torch.as_tensor(cols[f][i]).to(torch.complex64) for f in range(2)])
            b = torch.zeros_like(x)
            b[0, i // 3, i % 3, 0, 0, 0] = 1.0
            assert float(torch.linalg.vector_norm(_m_nd_full(gauge[1], x, tp, LAT) - b)) < 1e-5
