"""PHMC: the polynomial pseudofermion monomial of the non-degenerate
doublet (NDPOLY).

Port of `tmlqcd_tpu/hmc/poly_monomials.py` (reference:
monomial/ndpoly_monomial.c, chebyshev_polynomial_nd.c, phmc.c).  With P the
Chebyshev approximation of x^{-1/4} on [s_min, s_max],

    S = |P(Q_nd^2) phi|^2,

so the sampled weight is det(P^2)^{-1} ~ det(Q_nd^2)^{1/2}; the polynomial's
error is corrected by reweighting (`hmc.reweight`).

  * heatbath: phi = P^{-1} eta by CG on the hermitian positive P^2, so
    S_0 = |eta|^2 up to the CG tolerance.
  * acceptance: one polynomial application.
  * force: autograd through the Clenshaw recursion at stopped psi = P phi:
    dS = 2 Re<psi, dP phi>; no inversion in the MD force.

Routing: pseudofermions are split f32 doublets [2, 2, 4, 3, T, X, M].  In
the heatbath and the action every Q_nd^2 is one K1-SD launch
(`q_nd_sq_fast`, `q_nd_sq_clover_fast`; their plain versions on the CPU).
The force's Clenshaw runs `q_nd_diff` twice per Q_nd^2 (K1 forward, K2 and
the adjoint K1 backward, through `HoppingDiff`), or `q_nd_clover_diff` with
clover, where the reference takes jnp autodiff of its complex operator.
The monomial takes no mesh: the whole lattice runs on the one card even when
`cli.hmc` builds a slab mesh for the other monomials (the reference falls
back to its jnp operator under a mesh).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.hmc.rational_monomials import _NDOps
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers.cg import cg
from tmlqcd_tpu_torch.solvers.chebyshev import chebyshev_apply, chebyshev_coeffs, chebyshev_eval

__all__ = ["NDPolyMonomial"]


@dataclasses.dataclass(frozen=True)
class NDPolyMonomial:
    """Nf=1+1 polynomial monomial (BeginMonomial NDPOLY with 2Kappamubar /
    2Kappaepsbar, the degree, StildeMin / StildeMax); `params.c_sw != 0`
    selects the clover doublet."""

    lat: Lattice
    params: nd.NDParams
    degree: int = 128  # ~3e-7 max relative error on [1e-2, 4]
    s_min: float = 1e-2
    s_max: float = 4.0
    timescale: int = 1
    heatbath_tol: float = 1e-10
    maxiter: int = 1000
    name: str = "ndpoly"

    @functools.cached_property
    def coeffs(self) -> np.ndarray:
        return chebyshev_coeffs(lambda x: x**-0.25, self.degree, self.s_min, self.s_max)

    @property
    def max_rel_err(self) -> float:
        """max |P(x) x^{1/4} - 1| on [s_min, s_max] (4001 geometric points)."""
        xs = np.geomspace(self.s_min, self.s_max, 4001)
        approx = chebyshev_eval(self.coeffs, xs, self.s_min, self.s_max)
        return float(np.max(np.abs(approx * xs**0.25 - 1.0)))

    def _eta_shape(self) -> tuple:
        return (2, 4, 3) + self.lat.eo_site_shape

    def _ops(self, u: torch.Tensor, grad: bool) -> _NDOps:
        return _NDOps(u, self.params, self.lat, grad)

    def _poly_on(self, q2, chi2: torch.Tensor) -> torch.Tensor:
        return chebyshev_apply(q2, self.coeffs, chi2, self.s_min, self.s_max)

    def q2_operator(self, u: torch.Tensor):
        """(Q_nd^2 on split doublets, complex field shape) at U: the operator
        whose spectrum [s_min, s_max] must bracket."""
        return self._ops(u, False).a, self._eta_shape()

    def heatbath_info(self, u, key, eta=None):
        """(phi2, S_0, CG iterations of the P^2 solve)."""
        if eta is None:
            eta = rng.normal_spinor(key, self._eta_shape(), u.device, lat=self.lat)
        eta2 = wf.to_split(eta)
        q2 = self._ops(u, False).a
        res = cg(lambda x2: self._poly_on(q2, self._poly_on(q2, x2)), self._poly_on(q2, eta2),
                 tol=self.heatbath_tol, maxiter=self.maxiter)
        return res.x, wf.dot_re_f64_split(eta2, eta2), res.iterations

    def heatbath(self, u, key, eta=None):
        return self.heatbath_info(u, key, eta)[:2]

    def action_info(self, u, phi2, hist=None):
        psi2 = self._poly_on(self._ops(u, False).a, phi2)
        return wf.dot_re_f64_split(psi2, psi2), 0

    def action(self, u, phi2):
        return self.action_info(u, phi2)[0]

    def force(self, u, phi2):
        ops = self._ops(u, True)
        with torch.no_grad():
            psi2 = self._poly_on(ops.a, phi2)
        with torch.enable_grad():
            # d|P phi|^2 = 2 Re<psi, dP phi> at stopped psi, phi
            p_phi = self._poly_on(lambda c2: ops.q_diff(ops.q_diff(c2)), phi2)
            s = 2.0 * wf.dot_re_f64_split(psi2, p_phi)
        return ops.force(s)
