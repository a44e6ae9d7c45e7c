"""Schrödinger functional (SF): the Wilson gauge action with Dirichlet
boundaries in time, and the SF running-coupling observable.

Port of `tmlqcd_tpu/ops/sf.py` (reference: sf_gauge_monomial.c,
sf_calc_action.c, sf_observables.c; Lüscher, Narayanan, Weisz, Wolff, Nucl.
Phys. B384 (1992) 168, and the SU(3) boundary fields of Lüscher, Sommer,
Weisz, Wolff, Nucl. Phys. B413 (1994) 481, with Sint and Sommer's nu).

Time extent T = lat.dims[0], spatial extent L = lat.dims[1] = LY = LZ:

- the spatial links at x0 = 0 are frozen to the abelian boundary field
  W_k = exp(i phi / L) (diagonal) and the x0 = T plane holds
  W'_k = exp(i phi' / L).  The stored gauge keeps its periodic shape
  [3,3,4,T,X,Y*Z]; its spatial entries at t = 0 are never read (W replaces
  them in the action, so their gradient is exactly zero) and the x0 = T
  plane is rebuilt from eta at every call;
- dynamical: every temporal link U_0(x0), x0 = 0..T-1, and the spatial
  links U_k(x0), x0 = 1..T-1;
- S = beta sum_p w(p) (1 - Re tr P / 3) with no wrap in time: temporal
  plaquettes in the x0 = 0 and x0 = T-1 slabs carry c_t, spatial plaquettes
  in the boundary planes x0 in {0, T} carry 1/2.  Traces are summed in f64.

The MD force is the autograd gradient of this action, as for the periodic
gauge action; only the momenta are masked (`sf_momenta_mask`, see
`HMCConfig.momenta_mask`) so that the drift leaves the frozen links alone.
dS/deta is one `torch.autograd.grad` with respect to a 0-dim f64 eta, and
the coupling follows from <dS/deta> = k / gbar^2.  Plain torch: the
reference runs no Pallas kernel here either.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.lattice import Lattice, shift_full

__all__ = [
    "sf_phases",
    "sf_boundary_links",
    "sf_classical_background",
    "sf_momenta_mask",
    "sf_gauge_action",
    "sf_dS_deta",
    "sf_coupling_normalization",
    "sf_observables",
]


def _as_eta(eta, device=None) -> torch.Tensor:
    if isinstance(eta, torch.Tensor):
        return eta.to(torch.float64)
    return torch.tensor(float(eta), dtype=torch.float64, device=device)


def sf_phases(eta, nu=0.0):
    """SU(3) SF boundary angles (phi, phi') as length-3 f64 tensors
    (traceless), LSWW point A with the Sint-Sommer nu:
        phi  = (eta - pi/3,  eta (nu - 1/2),  -eta (nu + 1/2) + pi/3)
        phi' = (-eta - pi,   eta (nu + 1/2) + pi/3,  -eta (nu - 1/2) + 2 pi/3)"""
    eta = _as_eta(eta)
    pi = np.pi
    phi = torch.stack([eta - pi / 3.0, eta * (nu - 0.5), -eta * (nu + 0.5) + pi / 3.0])
    phi_p = torch.stack([-eta - pi, eta * (nu + 0.5) + pi / 3.0,
                         -eta * (nu - 0.5) + 2.0 * pi / 3.0])
    return phi, phi_p


def _diag_u(angles: torch.Tensor, dtype) -> torch.Tensor:
    """exp(i diag(angles)) as a [3,3] SU(3) matrix."""
    return torch.diag(torch.polar(torch.ones_like(angles), angles)).to(dtype)


def sf_boundary_links(lat: Lattice, eta, nu=0.0, dtype=torch.complex64, device=None):
    """(W, W'): the frozen spatial boundary links at x0 = 0 and x0 = T as
    [3,3] diagonal SU(3) matrices, the same for all three directions."""
    el = float(lat.dims[1])
    phi, phi_p = sf_phases(_as_eta(eta, device), nu)
    return _diag_u(phi / el, dtype), _diag_u(phi_p / el, dtype)


def sf_classical_background(lat: Lattice, eta=0.0, nu=0.0, dtype=torch.complex64,
                            device="cpu") -> torch.Tensor:
    """The induced abelian background (the classical minimum): V_0 = 1,
    V_k(x0) = exp(i [(T - x0) phi + x0 phi'] / (L T)), as a periodic-layout
    gauge [3,3,4,T,X,Y*Z] whose t = 0 spatial entries hold W."""
    t_ext, el = lat.dims[0], float(lat.dims[1])
    phi, phi_p = sf_phases(_as_eta(eta, device), nu)
    x0 = torch.arange(t_ext, dtype=torch.float64, device=phi.device)[:, None]  # [T, 1]
    ang = ((t_ext - x0) * phi[None, :] + x0 * phi_p[None, :]) / (el * t_ext)  # [T, 3]
    diag = torch.polar(torch.ones_like(ang), ang).to(dtype)  # [T, 3]
    vk = torch.einsum("tc,cd->cdt", diag, torch.eye(3, dtype=dtype, device=diag.device))
    u = torch.zeros((3, 3, 4) + lat.site_shape, dtype=dtype, device=diag.device)
    eye = torch.eye(3, dtype=dtype, device=diag.device)[:, :, None, None, None]
    u[:, :, 0] = eye.expand((3, 3) + lat.site_shape)
    for k in (1, 2, 3):
        u[:, :, k] = vk[:, :, :, None, None].expand((3, 3) + lat.site_shape)
    return u


def sf_momenta_mask(lat: Lattice, device="cpu") -> torch.Tensor:
    """[4,T,X,Y*Z] f32 mask: 0 on the frozen dofs (spatial links at t = 0),
    1 elsewhere.  Multiplied into the momenta after the heatbath, so the
    frozen links carry no kinetic term and never drift."""
    m = torch.ones((4,) + lat.site_shape, dtype=torch.float32, device=device)
    m[1:4, 0] = 0.0
    return m


def _spatial_plaq_sum(uk_ext: torch.Tensor, k: int, l: int, lat: Lattice) -> torch.Tensor:
    """sum_x Re tr P_kl(x) per spatial plane of the extended spatial links
    uk_ext [3,3,3,T+1,X,Mf]: a [T+1] f64 result."""
    v = su3.mul(uk_ext[:, :, k - 1], shift_full(uk_ext[:, :, l - 1], k, +1, lat))
    w = su3.mul(uk_ext[:, :, l - 1], shift_full(uk_ext[:, :, k - 1], l, +1, lat))
    tr = su3.re_trace(su3.mul(v, su3.adj(w)))  # [T+1, X, Mf]
    return torch.sum(tr.double(), dim=(1, 2))


def _sf_action_impl(u: torch.Tensor, beta: float, lat: Lattice, eta: torch.Tensor, nu: float,
                    ct: float) -> torch.Tensor:
    t_ext = lat.dims[0]
    w, wp = sf_boundary_links(lat, eta, nu, u.dtype)
    vs = lat.dims[1] * lat.mf  # spatial volume X*Y*Z

    # extended spatial links over x0 = 0..T: frozen W | dynamical | frozen W'
    bshape = (3, 3, 3, 1) + lat.site_shape[1:]
    w_b = w[:, :, None, None, None, None].expand(bshape)
    wp_b = wp[:, :, None, None, None, None].expand(bshape)
    uk_ext = torch.cat([w_b, u[:, :, 1:4, 1:], wp_b], dim=3)  # [3,3,3,T+1,X,Mf]
    u0 = u[:, :, 0]  # [3,3,T,X,Mf]

    # temporal plaquettes P_0k(x0), x0 = 0..T-1 (no time wrap):
    #   P = U_0(x) U_k(x+0) [U_k(x) U_0(x+k)]^+
    wt = torch.as_tensor(np.concatenate([[ct], np.ones(max(t_ext - 2, 0)), [ct]])[:t_ext],
                         dtype=torch.float64, device=u.device)
    s_t = torch.zeros((), dtype=torch.float64, device=u.device)
    for k in (1, 2, 3):
        a = su3.mul(u0, uk_ext[:, :, k - 1, 1:])
        b = su3.mul(uk_ext[:, :, k - 1, :t_ext], shift_full(u0, k, +1, lat))
        per_slab = torch.sum(su3.re_trace(su3.mul(a, su3.adj(b))).double(), dim=(1, 2))  # [T]
        s_t = s_t + torch.sum(wt * (vs - per_slab / 3.0))

    # spatial plaquettes, x0 = 0..T: boundary planes weight 1/2
    ws = torch.as_tensor(np.concatenate([[0.5], np.ones(t_ext - 1), [0.5]]),
                         dtype=torch.float64, device=u.device)
    s_s = torch.zeros((), dtype=torch.float64, device=u.device)
    for k, l in ((1, 2), (1, 3), (2, 3)):
        s_s = s_s + torch.sum(ws * (vs - _spatial_plaq_sum(uk_ext, k, l, lat) / 3.0))
    return beta * (s_t + s_s)


def sf_gauge_action(u: torch.Tensor, beta: float, lat: Lattice, eta=0.0, nu=0.0,
                    ct=1.0) -> torch.Tensor:
    """S_SF[U; eta, nu] (f64).  Its autograd gradient with respect to u is
    the MD force's raw gradient, zero on the frozen dofs by construction."""
    return _sf_action_impl(u, beta, lat, _as_eta(eta, u.device), nu, ct)


def sf_dS_deta(u: torch.Tensor, beta: float, lat: Lattice, eta=0.0, nu=0.0,
               ct=1.0) -> torch.Tensor:
    """dS_SF/deta at fixed U, the SF coupling observable: one autograd pass
    through the boundary links with respect to a 0-dim f64 eta."""
    with torch.enable_grad():
        e = _as_eta(eta, u.device).detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_sf_action_impl(u.detach(), beta, lat, e, nu, ct), e)
    return g


def sf_coupling_normalization(lat: Lattice, ct: float = 1.0) -> float:
    """k in gbar^2 = k / <dS/deta>, fixed by the classical limit
    gbar^2 -> g0^2 = 6/beta (closed form of the abelian classical solution,
    constant temporal-plaquette angles theta_j = (phi'_j - phi_j)/(L T)):

        k = 12 L^2 [sin(2 gamma) + sin(gamma)] (T - 2 + 2 c_t)/T,
        gamma = pi/(3 L T)."""
    t_ext, el = lat.dims[0], lat.dims[1]
    vs = lat.dims[1] * lat.mf
    theta = np.array([-2.0, 1.0, 1.0]) * np.pi / (3.0 * el * t_ext)
    dtheta = np.array([-2.0, 1.0, 1.0]) / (el * t_ext)
    wsum = t_ext - 2 + 2 * ct
    return float(6.0 * vs * wsum * np.sum(np.sin(theta) * dtheta))


def sf_observables(u: torch.Tensor, beta: float, lat: Lattice, eta=0.0, nu=0.0,
                   ct=1.0) -> dict:
    """dict(action, dS_deta, k): the per-configuration SF observables; the
    ensemble estimator of the running coupling is gbar^2 = k / <dS_deta>."""
    return {"action": sf_gauge_action(u, beta, lat, eta, nu, ct),
            "dS_deta": sf_dS_deta(u, beta, lat, eta, nu, ct),
            "k": sf_coupling_normalization(lat, ct)}
