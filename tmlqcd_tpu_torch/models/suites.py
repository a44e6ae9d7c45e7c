"""Standard action suites (port of `tmlqcd_tpu/models/suites.py`: the
BASELINE configs 1-3), and the production-shaped action of the reference's
multi-device proof (`dryrun_multichip`'s phase 2)."""

from __future__ import annotations

from tmlqcd_tpu_torch.hmc import (
    CloverDetRatioMonomial,
    DetMonomial,
    DetRatioMonomial,
    GaugeMonomial,
    HMCConfig,
    IntegratorConfig,
    Level,
    NDRatMonomial,
)
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops.ndoublet import NDParams
from tmlqcd_tpu_torch.ops.wilson import DiracParams

__all__ = ["pure_gauge", "nf2_wilson", "nf2_twisted_mass_hasenbusch", "dryrun_action"]


def pure_gauge(lat: Lattice, beta: float, c1: float = 0.0, tau: float = 1.0,
               steps: int = 12) -> HMCConfig:
    """Config 1: pure SU(3) plaquette(-rectangle) HMC."""
    return HMCConfig(
        lat=lat,
        monomials=(GaugeMonomial(lat=lat, beta=beta, c1=c1, timescale=0),),
        integrator=IntegratorConfig(tau=tau, levels=(Level("2mn", steps),)),
    )


def nf2_wilson(lat: Lattice, beta: float, kappa: float, tau: float = 1.0, gauge_steps: int = 3,
               fermion_steps: int = 8, acc_tol: float = 1e-9, force_tol: float = 1e-8,
               maxiter: int = 2000) -> HMCConfig:
    """Config 2: two degenerate Wilson flavours (mu = 0), the even/odd
    preconditioned pseudofermion on the coarse timescale, the gauge on the
    fine one (BeginMonomial DET + GAUGE)."""
    return HMCConfig(
        lat=lat,
        monomials=(
            GaugeMonomial(lat=lat, beta=beta, timescale=0),
            DetMonomial(lat=lat, params=DiracParams(kappa=kappa, mu=0.0), timescale=1,
                        acc_tol=acc_tol, force_tol=force_tol, maxiter=maxiter),
        ),
        integrator=IntegratorConfig(
            tau=tau, levels=(Level("2mn", gauge_steps), Level("2mn", fermion_steps))),
    )

def nf2_twisted_mass_hasenbusch(
    lat: Lattice,
    beta: float,
    kappa: float,
    mu: float,
    mu_hasenbusch: float,
    c1: float = 0.0,
    tau: float = 1.0,
    steps: tuple[int, int, int] = (2, 2, 6),
    acc_tol: float = 1e-9,
    force_tol: float = 1e-8,
    maxiter: int = 2000,
) -> HMCConfig:
    """Config 3: Nf=2 twisted mass with one Hasenbusch splitting on three
    timescales — gauge (finest), det(mu2), det(mu)/det(mu2) (coarsest)."""
    light = DiracParams(kappa=kappa, mu=mu)
    heavy = DiracParams(kappa=kappa, mu=mu_hasenbusch)
    return HMCConfig(
        lat=lat,
        monomials=(
            GaugeMonomial(lat=lat, beta=beta, c1=c1, timescale=0),
            DetMonomial(lat=lat, params=heavy, timescale=1, acc_tol=acc_tol,
                        force_tol=force_tol, maxiter=maxiter, name="det_heavy"),
            DetRatioMonomial(lat=lat, params1=light, params2=heavy, timescale=2,
                             acc_tol=acc_tol, force_tol=force_tol, maxiter=maxiter),
        ),
        integrator=IntegratorConfig(
            tau=tau, levels=tuple(Level("2mn", s) for s in steps)),
    )


def dryrun_action(lat: Lattice, mesh=None) -> HMCConfig:
    """The action of phase 2 of the reference's `dryrun_multichip`
    (`__graft_entry__.py:165-194`): GAUGE (beta 5.5) on the fine timescale,
    CLOVERDETRATIO (kappa 0.138, c_sw 1.2, mu 0.05 over 0.25, chrono 2) and
    NDRAT (kappa 0.11, mubar 0.15, epsbar 0.09, order 3 on [1e-3, 4]) on the
    coarse one, 2MN (1, 1) over tau 0.4, every solve to 1e-5 in at most 80
    iterations.  With a distributed `mesh` the action is built on the rank's
    slab (`mesh.local(lat)`); with a one-process mesh the solves run on the
    slab kernels."""
    if mesh is not None and mesh.distributed:
        lat = mesh.local(lat)
    kappa, csw = 0.138, 1.2
    solve = dict(acc_tol=1e-5, force_tol=1e-5, maxiter=80, mesh=mesh)
    return HMCConfig(
        lat=lat,
        monomials=(
            GaugeMonomial(lat=lat, beta=5.5, timescale=0),
            CloverDetRatioMonomial(lat=lat, params1=DiracParams(kappa=kappa, mu=0.05, c_sw=csw),
                                   params2=DiracParams(kappa=kappa, mu=0.25, c_sw=csw),
                                   timescale=1, chrono_n=2, **solve),
            NDRatMonomial(lat=lat, params=NDParams(kappa=0.11, mubar=0.15, epsbar=0.09), order=3,
                          s_min=1e-3, s_max=4.0, timescale=1, **solve),
        ),
        integrator=IntegratorConfig(tau=0.4, levels=(Level("2mn", 1), Level("2mn", 1))),
        mesh=mesh,
    )
