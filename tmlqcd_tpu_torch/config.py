"""Typed run configuration and its lowering to an executable HMCConfig.

Port of `tmlqcd_tpu/config.py`.  The dataclasses carry the reference's full
input schema, so every tmLQCD input the reference accepts parses here too.
`build_hmc` lowers the ported subset — the GAUGE, DET and DETRATIO
monomials on one device — and raises `NotImplementedError`, naming the
feature, for everything else: other monomial types, measurement blocks,
NrTProcs/NrXProcs/NrYProcs/NrZProcs > 1, ReversibilityCheck, the
DebugLevel >= 2 force monitor and ILDG checkpoints.  Nothing is skipped
silently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tmlqcd_tpu_torch.hmc import (
    DetMonomial,
    DetRatioMonomial,
    GaugeMonomial,
    HMCConfig,
    IntegratorConfig,
    Level,
)
from tmlqcd_tpu_torch.lattice import Lattice
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
]

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


def build_monomial(spec: MonomialSpec, lat: Lattice, beta: float, c1: float):
    """Lower one MonomialSpec to a monomial object (GAUGE, DET, DETRATIO)."""
    ty = spec.type.upper()
    det_common = dict(
        timescale=spec.timescale,
        acc_tol=float(spec.acceptance_precision) ** 0.5,  # the input stores |r|^2
        force_tol=float(spec.force_precision) ** 0.5,
        maxiter=spec.max_solver_iterations,
        solver=spec.solver,
        chrono_n=spec.csg_history,
    )

    def params(two_kappa_mu):
        return DiracParams(kappa=spec.kappa, mu=_mu(two_kappa_mu, spec.kappa),
                           theta=tuple(spec.theta))

    if ty == "GAUGE":
        return GaugeMonomial(lat=lat, beta=beta, c1=c1, timescale=spec.timescale)
    if ty == "DET":
        return DetMonomial(lat=lat, params=params(spec.two_kappa_mu),
                           name=spec.name or "det", **det_common)
    if ty == "DETRATIO":
        return DetRatioMonomial(lat=lat, params1=params(spec.two_kappa_mu),
                                params2=params(spec.two_kappa_mu2),
                                name=spec.name or "detratio", **det_common)
    raise _not_ported(f"monomial type {spec.type!r}")


def check_ported(cfg: RunConfig) -> None:
    """Raise for every run feature this slice of the port does not carry."""
    if cfg.meas:
        raise _not_ported("measurement block(s) " + ", ".join(m.type for m in cfg.meas))
    names = ("NrTProcs", "NrXProcs", "NrYProcs", "NrZProcs")
    for name, n in zip(names, cfg.nr_procs):
        if n > 1:
            raise _not_ported(f"domain decomposition ({name} = {n})")
    if cfg.reversibility_check:
        raise _not_ported("ReversibilityCheck")
    if cfg.debug_level >= 2:
        raise _not_ported("the DebugLevel >= 2 force monitor")
    if cfg.checkpoint_format != "native":
        raise _not_ported(f"checkpoint format {cfg.checkpoint_format!r}")
    if cfg.gauge_action.lower() not in GAUGE_ACTIONS:
        raise ValueError(f"unknown gauge action {cfg.gauge_action!r}")


def build_hmc(cfg: RunConfig) -> HMCConfig:
    """RunConfig -> executable HMCConfig (raises for what is not ported)."""
    check_ported(cfg)
    lat = cfg.lat
    c1 = GAUGE_ACTIONS[cfg.gauge_action.lower()]
    specs = cfg.monomials or (MonomialSpec(type="GAUGE"),)
    monomials = tuple(build_monomial(s, lat, cfg.beta, c1) for s in specs)
    integ = IntegratorConfig(tau=cfg.integrator.tau, levels=cfg.integrator.levels())
    for m in monomials:
        if m.timescale >= len(integ.levels):
            raise ValueError(f"monomial {m.name} timescale {m.timescale} >= "
                             f"{len(integ.levels)} levels")
    return HMCConfig(lat=lat, monomials=monomials, integrator=integ)
