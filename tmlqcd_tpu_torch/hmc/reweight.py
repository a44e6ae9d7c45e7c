"""Stochastic reweighting factors.

Port of `tmlqcd_tpu/hmc/reweight.py` (reference: reweighting_factor.c,
reweighting_factor_nd.c): stochastic estimates of determinant ratios, used
to shift the twisted mass after the fact and to correct the PHMC
polynomial's error.  For complex gaussian eta (density ~ exp(-eta^+ eta))
and a hermitian positive M,

    det(M)^{-1} = E[exp(eta^+ (1 - M) eta)].

`stochastic_logdet_samples` returns the exponents s_i = eta_i^+ (1 - M) eta_i;
callers combine them as mean(exp(s)) and should look at their spread (the
estimator degrades for large |log det|, as the reference's does).  The
operators act on split f32 fields; on a CUDA gauge `mu_shift_reweighting`
applies Qhat_pm as one K1-S launch, in the solve too.  Given the `lat` of
the field the noise is drawn by timeslice, so it does not depend on the
decomposition; on one rank's slab of a distributed run the operators are
the slab's and every sum is a sum over the ranks (`dot_re_f64_split`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers.cg import cg

__all__ = ["stochastic_logdet_samples", "mu_shift_reweighting"]


def stochastic_logdet_samples(apply_m: Callable, shape: tuple, key: rng.Key,
                              n_samples: int = 12, device="cpu",
                              etas: Sequence | None = None, lat: Lattice | None = None
                              ) -> torch.Tensor:
    """[n] f64 samples s_i with det(M)^{-1} = E[exp(s_i)].  `apply_m` acts on
    split fields; eta_i (complex, `shape`) is drawn from `key.fold(i)` (by
    timeslice of `lat` where given), or taken from `etas` (then n =
    len(etas))."""
    if etas is None:
        etas = [rng.normal_spinor(key.fold(i), shape, device, lat=lat) for i in range(n_samples)]
    out = []
    for eta in etas:
        eta2 = wf.to_split(eta)
        out.append(wf.dot_re_f64_split(eta2, eta2) - wf.dot_re_f64_split(eta2, apply_m(eta2)))
    return torch.stack(out)


def mu_shift_reweighting(u: torch.Tensor, params_old, params_new, lat: Lattice, key: rng.Key,
                         n_samples: int = 12, tol: float = 1e-10, maxiter: int = 5000,
                         etas: Sequence | None = None) -> torch.Tensor:
    """Samples for w = det(Qhat_pm(new)) / det(Qhat_pm(old)), the two-flavour
    twisted-mass shift reweighting: M = Qhat_pm(old)^{-1} Qhat_pm(new), one
    CG solve per sample.  `etas` injects the noise vectors."""
    with torch.no_grad():
        # one gauge copy per parameter set: each carries its own boundary phases
        fg_old = wf.make_fast_gauge(u, params_old, lat)
        fg_new = wf.make_fast_gauge(u, params_new, lat)
        q_old = wf.q_hat_pm_operator(fg_old, params_old, lat)

        def apply_m(eta2):
            return cg(q_old, wf.q_hat_pm_fast(fg_new, eta2, params_new, lat), tol=tol,
                      maxiter=maxiter).x

        return stochastic_logdet_samples(apply_m, (4, 3) + lat.eo_site_shape, key, n_samples,
                                         u.device, etas, lat)
