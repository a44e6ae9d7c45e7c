"""Plain PyTorch reference of one HMC trajectory of a GAUGE + DET + DETRATIO
action (tmLQCD's Nf=2 twisted-mass Hasenbusch setup), on the draws the
benchmark handed the program.

Conventions (tmLQCD's): momenta P traceless anti-hermitian with kinetic
energy K = sum |P_ij|^2; drift U <- exp(eps P) U, reunitarised; for an action S with
dS = Re sum G dU the force is F = TA(U G^T) and the kick P <- P + eps F / 2,
which conserves H = K + S.  The nested 2MN (Omelyan) integrator: on each
timescale with n steps of eps, kicks of lambda eps, (1 - 2 lambda) eps and
2 lambda eps around half-step drifts, each drift of an outer timescale being
a whole integration of the next inner one; kicks of one monomial with no
drift between them are summed into one force evaluation.

Pseudofermions on the odd sites (`ops.Schur`): DET phi = Qhat_-(mu_H) eta,
S = phi^+ (Qhat_- Qhat_+)^{-1} phi; DETRATIO phi = Qhat_+(mu_H)^{-1}
Qhat_-(mu_L) eta, S = psi^+ (Qhat_- Qhat_+)(mu_L)^{-1} psi with psi =
Qhat_+(mu_H) phi; both start at |eta|^2.  Forces are autograd of the action
at stopped solves.  Imports nothing of the program.

`rnd` rounds every stored field (links, momenta, pseudofermions, solver
vectors): the identity for the reference, bfloat16 storage for its control.
"""

from __future__ import annotations

import torch

from . import ops

LAMBDA_2MN = 0.1931833275037836
GAUGE_C1 = {"wilson": 0.0, "tlsym": -1.0 / 12.0, "iwasaki": -0.331, "dbw2": -1.4088}


def identity(v):
    return v


def bf16(v: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 storage and back (complex: each part)."""
    if v.is_complex():
        return torch.complex(v.real.to(torch.bfloat16).float(), v.imag.to(torch.bfloat16).float())
    return v.to(torch.bfloat16).float()


def ta(m: torch.Tensor) -> torch.Tensor:
    a = 0.5 * (m - ops.adj(m))
    tr = (a[0, 0] + a[1, 1] + a[2, 2]) / 3.0
    eye = torch.eye(3, dtype=m.dtype, device=m.device).reshape((3, 3) + (1,) * (m.ndim - 2))
    return a - tr * eye


def _force(u: torch.Tensor, action) -> torch.Tensor:
    """F = TA(U G^T) with dS = Re sum G dU; torch's gradient of a real loss
    with respect to a complex tensor is conj(G)."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(action(uu), uu)
    return ta(ops.mul(u, torch.conj(g).transpose(0, 1)))


def kinetic(p: torch.Tensor) -> torch.Tensor:
    return (p.real.double() ** 2 + p.imag.double() ** 2).sum()


def unpack_odd(eta: torch.Tensor, dims) -> torch.Tensor:
    """An odd-site field stored packed, [4, 3, T, X, Y * Z/2] with the odd
    site (t, x, y, z) at position y * Z/2 + z // 2, onto the full lattice
    (zero on the even sites)."""
    t, x, y, z = dims
    e = eta.reshape(eta.shape[:-3] + (t, x, y, z // 2)).repeat_interleave(2, dim=-1)
    return e * ops.odd_mask(dims, eta.device)


class Gauge:
    def __init__(self, spec, beta, c1, rnd):
        self.timescale, self.beta, self.c1 = spec["timescale"], beta, c1

    def heatbath(self, u, eta):
        return self.action(u)

    def action(self, u):
        return ops.gauge_action(u, self.beta, self.c1)

    def force(self, u):
        return _force(u, lambda uu: ops.gauge_action(uu, self.beta, self.c1))


class _Fermion:
    def __init__(self, spec, beta, c1, rnd):
        self.timescale, self.rnd = spec["timescale"], rnd
        self.kappa = spec["kappa"]
        self.acc_tol = spec["AcceptancePrecision"] ** 0.5
        self.force_tol = spec["ForcePrecision"] ** 0.5
        self.maxiter = spec["MaxSolverIterations"]
        self.theta = tuple(spec.get("theta", (1.0, 0.0, 0.0, 0.0)))
        self.phi = None

    def _schur(self, u):
        return ops.Schur(u, self.kappa, 0.0, self.theta)

    def _solve(self, sch, b, mutld, tol):
        return ops.cg(lambda v: sch.q_pm(v, mutld), b, tol, self.maxiter, self.rnd)[0]


class Det(_Fermion):
    """S = phi^+ Qhat_pm(mu)^{-1} phi."""

    def __init__(self, spec, beta, c1, rnd):
        super().__init__(spec, beta, c1, rnd)
        self.mu = spec["2KappaMu"]

    def heatbath(self, u, eta):
        self.phi = self.rnd(self._schur(u).q_hat(eta, -1.0, self.mu))
        return ops.dot_re(eta, eta)

    def action(self, u):
        sch = self._schur(u)
        return ops.dot_re(self.phi, self._solve(sch, self.phi, self.mu, self.acc_tol))

    def force(self, u):
        sch = self._schur(u)
        x = self._solve(sch, self.phi, self.mu, self.force_tol)
        y = sch.q_hat(x, +1.0, self.mu)
        return _force(u, lambda uu: -2.0 * ops.dot_re(y, sch.q_hat(x, +1.0, self.mu, uu)))


class DetRatio(_Fermion):
    """S = psi^+ Qhat_pm(mu)^{-1} psi, psi = Qhat_+(mu2) phi."""

    def __init__(self, spec, beta, c1, rnd):
        super().__init__(spec, beta, c1, rnd)
        self.mu, self.mu2 = spec["2KappaMu"], spec["2KappaMu2"]

    def heatbath(self, u, eta):
        sch = self._schur(u)
        b = sch.q_hat(sch.q_hat(eta, -1.0, self.mu), -1.0, self.mu2)
        self.phi = self.rnd(self._solve(sch, self.rnd(b), self.mu2, self.acc_tol))
        return ops.dot_re(eta, eta)

    def action(self, u):
        sch = self._schur(u)
        psi = self.rnd(sch.q_hat(self.phi, +1.0, self.mu2))
        return ops.dot_re(psi, self._solve(sch, psi, self.mu, self.acc_tol))

    def force(self, u):
        sch = self._schur(u)
        psi = self.rnd(sch.q_hat(self.phi, +1.0, self.mu2))
        x = self._solve(sch, psi, self.mu, self.force_tol)
        y = sch.q_hat(x, +1.0, self.mu)

        def surrogate(uu):
            return (2.0 * ops.dot_re(x, sch.q_hat(self.phi, +1.0, self.mu2, uu))
                    - 2.0 * ops.dot_re(y, sch.q_hat(x, +1.0, self.mu, uu)))

        return _force(u, surrogate)


MONOMIALS = {"GAUGE": Gauge, "DET": Det, "DETRATIO": DetRatio}


def schedule(levels, tau):
    """The nested 2MN events: ('kick', level, eps) and ('drift', eps)."""
    events = []

    def run(lvl, t):
        n = levels[lvl]
        eps = t / n
        kicks = [LAMBDA_2MN * eps]
        for _ in range(n - 1):
            kicks += [(1.0 - 2.0 * LAMBDA_2MN) * eps, 2.0 * LAMBDA_2MN * eps]
        kicks += [(1.0 - 2.0 * LAMBDA_2MN) * eps, LAMBDA_2MN * eps]
        for i, c in enumerate(kicks):
            events.append(("kick", lvl, c))
            if i < len(kicks) - 1:
                if lvl == 0:
                    events.append(("drift", 0.5 * eps))
                else:
                    run(lvl - 1, 0.5 * eps)

    run(len(levels) - 1, tau)
    return events


def reunitarize(m: torch.Tensor) -> torch.Tensor:
    """Back onto SU(3), as tmLQCD restores the links after every update:
    Gram-Schmidt on the first two rows, the third their conjugate cross
    product."""
    r0 = m[0] / torch.linalg.vector_norm(m[0], dim=0, keepdim=True)
    r1 = m[1] - (torch.conj(r0) * m[1]).sum(0, keepdim=True) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=0, keepdim=True)
    r2 = torch.stack([r0[(j + 1) % 3] * r1[(j + 2) % 3] - r0[(j + 2) % 3] * r1[(j + 1) % 3]
                      for j in range(3)])
    return torch.stack([r0, r1, torch.conj(r2)])


def expm(a: torch.Tensor, order: int = 12, squarings: int = 6) -> torch.Tensor:
    """exp of 3x3 matrices [3, 3, ...]: Taylor series of a / 2^squarings
    (Horner), squared back."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device).reshape((3, 3) + (1,) * (a.ndim - 2))
    b = a / 2.0 ** squarings
    acc = eye + b / order
    for k in range(order - 1, 0, -1):
        acc = eye + ops.mul(b, acc) / k
    for _ in range(squarings):
        acc = ops.mul(acc, acc)
    return acc


def drift(u: torch.Tensor, p: torch.Tensor, eps: float) -> torch.Tensor:
    """U <- exp(eps P) U, reunitarised."""
    return reunitarize(ops.mul(expm(eps * p), u))


def trajectory(hcfg: dict, u: torch.Tensor, momenta: torch.Tensor, etas: list,
               rnd=identity) -> dict:
    """One molecular-dynamics trajectory and its Hamiltonians.

    hcfg: the configuration file's "hmc" object; u [3, 3, 4, T, X, Y, Z];
    momenta of u's shape; etas one packed odd-site field per monomial (None
    for the gauge).  Returns h_old, h_new, dh and the evolved links."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if hcfg["integrator"]["scheme"].upper() != "2MN":
        raise ValueError(f"the reference integrates 2MN only, not {hcfg['integrator']['scheme']}")
    dims = tuple(u.shape[-4:])
    c1 = GAUGE_C1[hcfg["gauge_action"].lower()]
    mons = [MONOMIALS[s["type"].upper()](s, hcfg["beta"], c1, rnd) for s in hcfg["monomials"]]
    u, p = rnd(u), rnd(momenta)
    k_old = kinetic(p)
    h_old = k_old
    for m, eta in zip(mons, etas):
        h_old = h_old + m.heatbath(u, None if eta is None else rnd(unpack_odd(eta, dims)))

    pending = [0.0] * len(mons)

    def flush(p):
        f = None
        for i, m in enumerate(mons):
            if pending[i] != 0.0:
                fi = pending[i] * m.force(u)
                f = fi if f is None else f + fi
                pending[i] = 0.0
        return p if f is None else rnd(p + 0.5 * f)

    for ev in schedule(hcfg["integrator"]["steps"], hcfg["tau"]):
        if ev[0] == "kick":
            for i, m in enumerate(mons):
                if m.timescale == ev[1]:
                    pending[i] += ev[2]
        else:
            p = flush(p)
            u = rnd(drift(u, p, ev[1]))
    p = flush(p)
    k_new = kinetic(p)
    h_new = k_new
    for m in mons:
        h_new = h_new + m.action(u)
    return {"h_old": float(h_old), "h_new": float(h_new), "dh": float(h_new - h_old),
            "moved": abs(float(k_new - k_old)), "u": u}
