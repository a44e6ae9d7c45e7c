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

On one rank's slab of a distributed run (`lat` carries the mesh) x0 is
global (`lat.offset`): only the rank holding x0 = 0 freezes its first
timeslice to W, only the rank holding x0 = T-1 closes its last one with W'
(in place of the links the t shift brought round from x0 = 0), the weights
read the global x0, and each rank's share of S goes through
`comm.global_sum`, whose backward leaves each rank its own gradient.
dS/deta is the sum over the ranks of each share's derivative.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.comm import global_sum
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


def _x0(lat: Lattice, device) -> torch.Tensor:
    """[T_loc, 1] f64: the global x0 of each of the slab's timeslices."""
    t_off = lat.offset[0]
    return torch.arange(t_off, t_off + lat.dims[0], dtype=torch.float64, device=device)[:, None]


def sf_classical_background(lat: Lattice, eta=0.0, nu=0.0, dtype=torch.complex64,
                            device="cpu") -> torch.Tensor:
    """The induced abelian background (the classical minimum): V_0 = 1,
    V_k(x0) = exp(i [(T - x0) phi + x0 phi'] / (L T)), as a periodic-layout
    gauge [3,3,4,T,X,Y*Z] whose t = 0 spatial entries hold W (the slab's
    timeslices on a rank)."""
    t_ext, el = lat.global_dims[0], float(lat.dims[1])
    phi, phi_p = sf_phases(_as_eta(eta, device), nu)
    x0 = _x0(lat, phi.device)  # [T_loc, 1]
    ang = ((t_ext - x0) * phi[None, :] + x0 * phi_p[None, :]) / (el * t_ext)  # [T_loc, 3]
    diag = torch.polar(torch.ones_like(ang), ang).to(dtype)  # [T_loc, 3]
    vk = torch.einsum("tc,cd->cdt", diag, torch.eye(3, dtype=dtype, device=diag.device))
    u = torch.zeros((3, 3, 4) + lat.site_shape, dtype=dtype, device=diag.device)
    eye = torch.eye(3, dtype=dtype, device=diag.device)[:, :, None, None, None]
    u[:, :, 0] = eye.expand((3, 3) + lat.site_shape)
    for k in (1, 2, 3):
        u[:, :, k] = vk[:, :, :, None, None].expand((3, 3) + lat.site_shape)
    return u


def sf_momenta_mask(lat: Lattice, device="cpu") -> torch.Tensor:
    """[4,T,X,Y*Z] f32 mask: 0 on the frozen dofs (spatial links at t = 0),
    1 elsewhere (a slab's share on a rank: zeros only on the rank holding
    t = 0).  Multiplied into the momenta after the heatbath, so the frozen
    links carry no kinetic term and never drift."""
    m = torch.ones((4,) + lat.site_shape, dtype=torch.float32, device=device)
    if lat.offset[0] == 0:
        m[1:4, 0] = 0.0
    return m


def _spatial_plaq_sum(uk: torch.Tensor, k: int, l: int, lat: Lattice) -> torch.Tensor:
    """sum_x Re tr P_kl(x) per spatial plane of the spatial links
    uk [3,3,3,T,X,Mf]: a [T] f64 result."""
    v = su3.mul(uk[:, :, k - 1], shift_full(uk[:, :, l - 1], k, +1, lat))
    w = su3.mul(uk[:, :, l - 1], shift_full(uk[:, :, k - 1], l, +1, lat))
    tr = su3.re_trace(su3.mul(v, su3.adj(w)))  # [T, X, Mf]
    return torch.sum(tr.double(), dim=(1, 2))


_SPATIAL_PLANES = ((1, 2), (1, 3), (2, 3))


def _site_sum(m: torch.Tensor) -> torch.Tensor:
    """[3, 3, X, Mf] -> the [3, 3] complex128 sum over the sites."""
    return torch.sum(m.to(torch.complex128), dim=(2, 3))


def _constant_plane(w: torch.Tensor, vs: int) -> torch.Tensor:
    """sum over the planes kl and the vs sites of (1 - Re tr P_kl / 3) of a
    boundary plane whose spatial links are all `w`."""
    ww = su3.mul(w, w)
    return len(_SPATIAL_PLANES) * vs * (1.0 - su3.re_trace(su3.mul(ww, su3.adj(ww))) / 3.0)


def _sf_action_share(u: torch.Tensor, beta: float, lat: Lattice, eta: torch.Tensor, nu: float,
                     ct: float) -> torch.Tensor:
    """The slab's share of S_SF (all of it on a whole lattice).

    The boundary links enter as [3, 3] complex128 factors of the site sums
    of the boundary timeslices (tr(a (W c)^+) = tr((sum a c^+) W^+)), so
    dS/deta accumulates in f64 and no shift ever carries a boundary link:
    eta enters each rank's share locally."""
    t_loc, t_all, t_off = lat.dims[0], lat.global_dims[0], lat.offset[0]
    first, last = t_off == 0, t_off + t_loc == t_all  # holds x0 = 0, holds x0 = T-1
    w, wp = sf_boundary_links(lat, eta, nu, torch.complex128, u.device)
    vs = lat.dims[1] * lat.mf  # the slab's spatial sites per timeslice
    x0 = _x0(lat, u.device)[:, 0]
    inner = ((x0 > 0) & (x0 < t_all - 1)).double()  # timeslices with no boundary link

    # temporal plaquettes P_0k(x0), x0 = 0..T-1 (no time wrap), c_t at both ends:
    #   P = U_0(x) U_k(x+0) [U_k(x) U_0(x+k)]^+,
    # with U_k(x) = W at x0 = 0 and U_k(x+0) = W' at x0 = T-1
    uk = u[:, :, 1:4]
    uk_up = shift_full(uk, 0, +1, lat)
    u0 = u[:, :, 0]  # [3,3,T,X,Mf]
    s_t = torch.zeros((), dtype=torch.float64, device=u.device)
    for k in (1, 2, 3):
        c = shift_full(u0, k, +1, lat)
        a = su3.mul(u0, uk_up[:, :, k - 1])
        b = su3.mul(uk[:, :, k - 1], c)
        per_slab = torch.sum(su3.re_trace(su3.mul(a, su3.adj(b))).double(), dim=(1, 2))  # [T]
        s_t = s_t + torch.sum(inner * (vs - per_slab / 3.0))
        if first:
            m = _site_sum(su3.mul(a[:, :, 0], su3.adj(c[:, :, 0])))
            s_t = s_t + ct * (vs - su3.re_trace(su3.mul(m, su3.adj(w))) / 3.0)
        if last:
            m = _site_sum(su3.mul(su3.adj(b[:, :, -1]), u0[:, :, -1]))
            s_t = s_t + ct * (vs - su3.re_trace(su3.mul(wp, m)) / 3.0)

    # spatial plaquettes, x0 = 1..T-1 of the dynamical links, and the
    # boundary planes x0 = 0 (W) and x0 = T (W') at weight 1/2, every site
    # of such a plane the same
    s_s = torch.zeros((), dtype=torch.float64, device=u.device)
    for k, l in _SPATIAL_PLANES:
        s_s = s_s + torch.sum((x0 > 0).double() * (vs - _spatial_plaq_sum(uk, k, l, lat) / 3.0))
    if first:
        s_s = s_s + 0.5 * _constant_plane(w, vs)
    if last:
        s_s = s_s + 0.5 * _constant_plane(wp, vs)
    return beta * (s_t + s_s)


def sf_gauge_action(u: torch.Tensor, beta: float, lat: Lattice, eta=0.0, nu=0.0,
                    ct=1.0) -> torch.Tensor:
    """S_SF[U; eta, nu] (f64).  Its autograd gradient with respect to u is
    the MD force's raw gradient, zero on the frozen dofs by construction."""
    return global_sum(_sf_action_share(u, beta, lat, _as_eta(eta, u.device), nu, ct))


def sf_dS_deta(u: torch.Tensor, beta: float, lat: Lattice, eta=0.0, nu=0.0,
               ct=1.0) -> torch.Tensor:
    """dS_SF/deta at fixed U, the SF coupling observable: one autograd pass
    through the boundary links with respect to a 0-dim f64 eta (a rank's
    share that holds no boundary contributes zero)."""
    with torch.enable_grad():
        e = _as_eta(eta, u.device).detach().requires_grad_(True)
        share = _sf_action_share(u.detach(), beta, lat, e, nu, ct)
        g = torch.autograd.grad(share, e)[0] if share.requires_grad else torch.zeros_like(e)
    return global_sum(g.detach())


def sf_coupling_normalization(lat: Lattice, ct: float = 1.0) -> float:
    """k in gbar^2 = k / <dS/deta>, fixed by the classical limit
    gbar^2 -> g0^2 = 6/beta (closed form of the abelian classical solution,
    constant temporal-plaquette angles theta_j = (phi'_j - phi_j)/(L T)):

        k = 12 L^2 [sin(2 gamma) + sin(gamma)] (T - 2 + 2 c_t)/T,
        gamma = pi/(3 L T)."""
    t_ext, el = lat.global_dims[0], lat.dims[1]
    vs = lat.global_volume // t_ext
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
