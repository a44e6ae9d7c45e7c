"""Typed run configuration and its lowering to an executable HMCConfig.

Port of `tmlqcd_tpu/config.py`.  The dataclasses carry the reference's full
input schema, so every tmLQCD input the reference accepts parses here too.
`build_hmc` lowers every monomial the reference lowers — GAUGE, SFGAUGE
(with the Schrödinger functional's momenta mask on `HMCConfig`), DET,
DETRATIO, CLOVERDET, CLOVERDETRATIO and CLOVERTRLOG, the rational monomials
(NDRAT, NDCLOVERRAT, RAT, CLOVERRAT and their *COR corrections) and the
polynomial NDPOLY — on one device, with every measurement (ONLINE,
PIONNORM, GRADIENTFLOW, POLYAKOV, ORIENTEDPLAQUETTES, FIELDSTRENGTH,
SFCOUPLING), the force monitor, ReversibilityCheck and native or ILDG
checkpoints, and the (t, y) domain decomposition of NrTProcs x NrYProcs (a
slab mesh on one device, which `cli.hmc` builds with
`parallel.mesh_from_procs` and `build_hmc` carries by `HMCConfig.mesh` into
every solving monomial; NDPOLY and SFGAUGE take none).  A mesh over the
ranks of a process group (`cli.hmc --distributed`, one process per slab)
lowers the action onto the rank's slab (`mesh.local(lat)`); there the
monomials and measurements not yet ported to slabs raise
`NotImplementedError` before the run starts (ROADMAP queue 1: NDPOLY, the
Schrödinger functional, every measurement).  Several devices in one process
raise `NotImplementedError` where the mesh is built; NrXProcs / NrZProcs > 1
and a lattice that does not split into even slabs raise the reference's
`ValueError`.  `check_invert_ported` does the
same for the inverter's operators (TMWILSON, WILSON, CLOVER, DBTMWILSON,
DBCLOVER and OVERLAP; stout and source smearing are carried), rejects a
solver name the inverter does not know, and raises for any Nr*Procs > 1:
the reference's `cli/invert.py` builds no mesh.  Nothing is skipped
silently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tmlqcd_tpu_torch.hmc import (
    CloverDetMonomial,
    CloverDetRatioMonomial,
    CloverTrlogMonomial,
    DetMonomial,
    DetRatioMonomial,
    GaugeMonomial,
    HMCConfig,
    IntegratorConfig,
    Level,
    NDPolyMonomial,
    NDRatCorMonomial,
    NDRatMonomial,
    RatCorMonomial,
    RatMonomial,
    SFGaugeMonomial,
)
from tmlqcd_tpu_torch.inverter import check_solver
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas.runner import PORTED as PORTED_MEASUREMENTS
from tmlqcd_tpu_torch.ops.ndoublet import NDParams
from tmlqcd_tpu_torch.ops.sf import sf_momenta_mask
from tmlqcd_tpu_torch.ops.wilson import DiracParams

__all__ = [
    "MonomialSpec",
    "IntegratorSpec",
    "MeasurementSpec",
    "OperatorSpec",
    "RunConfig",
    "build_monomial",
    "build_hmc",
    "check_ported",
    "check_invert_ported",
    "check_distributed_ported",
]

PORTED_OPERATORS = ("TMWILSON", "WILSON", "CLOVER", "DBTMWILSON", "DBCLOVER", "OVERLAP")
GAUGE_ACTIONS = {"wilson": 0.0, "tlsym": -1.0 / 12.0, "iwasaki": -0.331, "dbw2": -1.4088}


@dataclasses.dataclass(frozen=True)
class MonomialSpec:
    """One BeginMonomial block."""

    type: str
    timescale: int = 0
    kappa: float = 0.0
    two_kappa_mu: float = 0.0
    two_kappa_mu2: float = 0.0
    csw: float = 0.0
    two_kappa_mubar: float = 0.0
    two_kappa_epsbar: float = 0.0
    rat_order: int = 12
    stilde_min: float = 1e-4
    stilde_max: float = 4.0
    acceptance_precision: float = 1e-18  # |r|^2 tolerances (reference naming)
    force_precision: float = 1e-16
    max_solver_iterations: int = 5000
    solver: str = "auto"
    csg_history: int = 3
    theta: tuple = (1.0, 0.0, 0.0, 0.0)
    eta: float = 0.0
    nu: float = 0.0
    ct: float = 1.0
    name: str = ""


@dataclasses.dataclass(frozen=True)
class IntegratorSpec:
    """Global integrator keys: tau, per-timescale steps and types."""

    tau: float = 1.0
    steps: tuple[int, ...] = (10,)
    types: tuple[str, ...] = ()
    lambda_2mn: Optional[float] = None

    def levels(self) -> tuple[Level, ...]:
        types = self.types or tuple("2MN" for _ in self.steps)
        name = {"LEAPFROG": "leapfrog", "2MN": "2mn", "2MNPOSITION": "2mnposition"}
        return tuple(Level(name.get(t.upper(), "2mn"), n) for t, n in zip(types, self.steps))


@dataclasses.dataclass(frozen=True)
class MeasurementSpec:
    """One BeginMeasurement block."""

    type: str
    frequency: int = 1
    kappa: float = 0.0
    two_kappa_mu: float = 0.0
    flow_eps: float = 0.02
    flow_steps: int = 50
    direction: int = 0
    max_solver_iterations: int = 5000
    precision: float = 1e-18
    eta: float = 0.0
    nu: float = 0.0
    ct: float = 1.0


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """One BeginOperator block (for the inverter)."""

    type: str
    kappa: float = 0.0
    two_kappa_mu: float = 0.0
    csw: float = 0.0
    two_kappa_mubar: float = 0.0
    two_kappa_epsbar: float = 0.0
    solver: str = "cg"
    precision: float = 1e-18
    max_solver_iterations: int = 5000
    theta: tuple = (1.0, 0.0, 0.0, 0.0)
    propagator_precision: int = 64
    overlap_m: float = 0.0
    overlap_s: float = 0.0
    sign_degree: int = 128
    sign_n_ev: int = 8


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Global run configuration (the global Key = value section)."""

    t: int = 4
    lx: int = 4
    ly: int = 4
    lz: int = 4
    seed: int = 42
    measurements: int = 10  # number of trajectories (reference key name)
    nsave: int = 10
    start_condition: str = "hot"  # hot | cold | continue
    beta: float = 5.7
    gauge_action: str = "wilson"
    integrator: IntegratorSpec = IntegratorSpec()
    monomials: tuple[MonomialSpec, ...] = ()
    operators: tuple[OperatorSpec, ...] = ()
    meas: tuple[MeasurementSpec, ...] = ()
    reversibility_check: bool = False
    reversibility_interval: int = 100
    debug_level: int = 1
    output_dir: str = "."
    checkpoint_format: str = "native"  # native | ildg
    initial_store_counter: object = "readin"
    source_type: str = "point"
    source_timeslice: int = 0
    use_source_smearing: bool = False
    jacobi_kappa: float = 0.21
    jacobi_iterations: int = 5
    ape_alpha: float = 0.5
    ape_iterations: int = 4
    use_stout_smearing: bool = False
    stout_rho: float = 0.1
    stout_iterations: int = 1
    gauge_config_input: str = ""
    gauge_write_precision: int = 64
    nr_procs: tuple = (0, 0, 0, 0)

    @property
    def lat(self) -> Lattice:
        return Lattice((self.t, self.lx, self.ly, self.lz))


def _mu(two_kappa_mu: float, kappa: float) -> float:
    return two_kappa_mu / (2.0 * kappa) if kappa else 0.0


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported to tmlqcd_tpu_torch")


def build_monomial(spec: MonomialSpec, lat: Lattice, beta: float, c1: float, mesh=None):
    """Lower one MonomialSpec to a monomial object (GAUGE, SFGAUGE, DET,
    DETRATIO, CLOVERDET, CLOVERDETRATIO, CLOVERTRLOG, the rational NDRAT,
    NDCLOVERRAT, RAT, CLOVERRAT with their *COR corrections, and the
    polynomial NDPOLY); `mesh` goes to every monomial that solves but
    NDPOLY, which runs on the whole lattice."""
    ty = spec.type.upper()
    common = dict(
        timescale=spec.timescale,
        acc_tol=float(spec.acceptance_precision) ** 0.5,  # the input stores |r|^2
        force_tol=float(spec.force_precision) ** 0.5,
        maxiter=spec.max_solver_iterations,
        mesh=mesh,
    )
    # solver routing and the chrono history belong to the CG-solving det
    # family (the multishift solves of the rational monomials start from zero)
    det_common = dict(common, solver=spec.solver, chrono_n=spec.csg_history)

    def params(two_kappa_mu, c_sw=0.0):
        return DiracParams(kappa=spec.kappa, mu=_mu(two_kappa_mu, spec.kappa), c_sw=c_sw,
                           theta=tuple(spec.theta))

    def nd_params():
        return NDParams(kappa=spec.kappa, mubar=_mu(spec.two_kappa_mubar, spec.kappa),
                        epsbar=_mu(spec.two_kappa_epsbar, spec.kappa), c_sw=spec.csw,
                        theta=tuple(spec.theta))

    if ty == "GAUGE":
        return GaugeMonomial(lat=lat, beta=beta, c1=c1, timescale=spec.timescale)
    if ty == "SFGAUGE":
        return SFGaugeMonomial(lat=lat, beta=beta, eta=spec.eta, nu=spec.nu, ct=spec.ct,
                               timescale=spec.timescale, name=spec.name or "sfgauge")
    if ty == "DET":
        return DetMonomial(lat=lat, params=params(spec.two_kappa_mu),
                           name=spec.name or "det", **det_common)
    if ty == "DETRATIO":
        return DetRatioMonomial(lat=lat, params1=params(spec.two_kappa_mu),
                                params2=params(spec.two_kappa_mu2),
                                name=spec.name or "detratio", **det_common)
    if ty == "CLOVERDET":
        return CloverDetMonomial(lat=lat, params=params(spec.two_kappa_mu, spec.csw),
                                 name=spec.name or "cloverdet", **det_common)
    if ty == "CLOVERDETRATIO":
        return CloverDetRatioMonomial(lat=lat, params1=params(spec.two_kappa_mu, spec.csw),
                                      params2=params(spec.two_kappa_mu2, spec.csw),
                                      name=spec.name or "cloverdetratio", **det_common)
    if ty == "CLOVERTRLOG":
        # no boundary phases: the clover term does not see them
        return CloverTrlogMonomial(
            lat=lat, params=DiracParams(kappa=spec.kappa, mu=_mu(spec.two_kappa_mu, spec.kappa),
                                        c_sw=spec.csw),
            timescale=spec.timescale, name=spec.name or "clovertrlog")
    if ty == "NDPOLY":
        return NDPolyMonomial(lat=lat, params=nd_params(), degree=max(spec.rat_order, 32),
                              s_min=spec.stilde_min, s_max=spec.stilde_max,
                              timescale=spec.timescale,
                              heatbath_tol=float(spec.acceptance_precision) ** 0.5,
                              maxiter=spec.max_solver_iterations, name=spec.name or "ndpoly")
    rational = dict(order=spec.rat_order, s_min=spec.stilde_min, s_max=spec.stilde_max,
                    name=spec.name or ty.lower(), **common)
    if ty in ("NDRAT", "NDCLOVERRAT", "NDRATCOR", "NDCLOVERRATCOR"):
        cls = NDRatCorMonomial if ty.endswith("COR") else NDRatMonomial
        return cls(lat=lat, params=nd_params(), **rational)
    if ty in ("RAT", "CLOVERRAT", "RATCOR", "CLOVERRATCOR"):
        cls = RatCorMonomial if ty.endswith("COR") else RatMonomial
        return cls(lat=lat, params=params(0.0, spec.csw), **rational)
    raise ValueError(f"unknown monomial type {spec.type!r}")


def _check_one_device(cfg: RunConfig) -> None:
    """The inverter's check: the reference's cli/invert.py builds no mesh."""
    names = ("NrTProcs", "NrXProcs", "NrYProcs", "NrZProcs")
    for name, n in zip(names, cfg.nr_procs):
        if n > 1:
            raise _not_ported(f"domain decomposition in the inverter ({name} = {n})")


def check_ported(cfg: RunConfig) -> None:
    """Raise for a measurement type, checkpoint format or gauge action
    that neither package knows (ValueError), before the run starts."""
    for m in cfg.meas:
        if m.type.upper() not in PORTED_MEASUREMENTS:
            raise ValueError(f"unknown measurement type {m.type!r}")
    if cfg.checkpoint_format not in ("native", "ildg"):
        raise ValueError(f"unknown checkpoint format {cfg.checkpoint_format!r}")
    if cfg.gauge_action.lower() not in GAUGE_ACTIONS:
        raise ValueError(f"unknown gauge action {cfg.gauge_action!r}")


def check_invert_ported(cfg: RunConfig) -> None:
    """Raise for domain decomposition in the inverter (NotImplementedError:
    the reference's inverter builds no mesh), and for an operator type other
    than TMWILSON / WILSON / CLOVER / DBTMWILSON / DBCLOVER / OVERLAP or a
    solver name outside `inverter.SOLVERS` (ValueError).  OVERLAP takes any
    solver name: `sumr` and `cgne` run as named, anything else runs `sumr`,
    as in the reference."""
    _check_one_device(cfg)
    for op in cfg.operators:
        if op.type.upper() not in PORTED_OPERATORS:
            raise ValueError(f"unknown operator type {op.type!r}")
        if op.type.upper() != "OVERLAP":
            check_solver(op.solver)


# on the ranks of a distributed mesh: the monomial types and the
# measurements not yet ported to slabs (ROADMAP queue 1)
_NOT_ON_RANKS = ("NDPOLY", "SFGAUGE")


def check_distributed_ported(cfg: RunConfig) -> None:
    """Raise NotImplementedError for what a distributed run (one process per
    slab) does not run yet: NDPOLY, the Schrödinger functional and every
    measurement."""
    for s in cfg.monomials:
        if s.type.upper() in _NOT_ON_RANKS:
            raise NotImplementedError(f"monomial {s.type} on a distributed mesh is not yet ported "
                                      "to tmlqcd_tpu_torch (ROADMAP queue 1)")
    for m in cfg.meas:
        raise NotImplementedError(f"measurement {m.type} on a distributed mesh is not yet "
                                  "ported to tmlqcd_tpu_torch (ROADMAP queue 1)")


def build_hmc(cfg: RunConfig, mesh=None) -> HMCConfig:
    """RunConfig -> executable HMCConfig (raises for what neither package
    knows).
    `mesh` (a `parallel.Mesh`, or None for none) is carried to every solving
    monomial; `cli.hmc` builds it from NrTProcs x NrYProcs.  On a
    distributed mesh the action is built on the rank's slab (`lat` of the
    result: `mesh.local(cfg.lat)`)."""
    check_ported(cfg)
    lat = cfg.lat
    if mesh is not None and mesh.distributed:
        check_distributed_ported(cfg)
        lat = mesh.local(lat)
    c1 = GAUGE_ACTIONS[cfg.gauge_action.lower()]
    specs = cfg.monomials or (MonomialSpec(type="GAUGE"),)
    monomials = tuple(build_monomial(s, lat, cfg.beta, c1, mesh) for s in specs)
    integ = IntegratorConfig(tau=cfg.integrator.tau, levels=cfg.integrator.levels())
    for m in monomials:
        if m.timescale >= len(integ.levels):
            raise ValueError(f"monomial {m.name} timescale {m.timescale} >= "
                             f"{len(integ.levels)} levels")
    mask = None
    if any(s.type.upper() == "SFGAUGE" for s in specs):
        # the Dirichlet-frozen spatial links at t = 0 carry no momentum
        mask = sf_momenta_mask(lat)
    return HMCConfig(lat=lat, monomials=monomials, integrator=integ, mesh=mesh,
                     momenta_mask=mask)
