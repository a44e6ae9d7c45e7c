"""Standard action suites (port of `tmlqcd_tpu/models/suites.py`: configs 1
and 3; config 2, nf2_wilson, follows with the next slice)."""

from __future__ import annotations

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

__all__ = ["pure_gauge", "nf2_twisted_mass_hasenbusch"]


def pure_gauge(lat: Lattice, beta: float, c1: float = 0.0, tau: float = 1.0,
               steps: int = 12) -> HMCConfig:
    """Config 1: pure SU(3) plaquette(-rectangle) HMC."""
    return HMCConfig(
        lat=lat,
        monomials=(GaugeMonomial(lat=lat, beta=beta, c1=c1, timescale=0),),
        integrator=IntegratorConfig(tau=tau, levels=(Level("2mn", steps),)),
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
