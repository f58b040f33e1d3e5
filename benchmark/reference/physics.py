"""The plain reference of the explosive-source runs, in PyTorch.

Einsum operators of the velocity-stress DG scheme (central flux for the
staggered leapfrog LF4, the Godunov flux for RK4), the Ricker explosive
source projected from a mollified point, the Cerjan sponge and receiver
sampling: a frozen copy of the program's einsum oracle, worked out from
the reference's own mesh (``mesh.py``) and the run's inputs.  Nothing
here reads what the program derived.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mesh import BC_ABSORB, BC_FREE, Mesh

VOIGT = {2: np.array([[0, 2], [2, 1]]),
         3: np.array([[0, 5, 4], [5, 1, 3], [4, 3, 2]])}


def n_sig(dim: int) -> int:
    return 3 if dim == 2 else 6


@dataclass
class Params:
    dim: int
    Dr: torch.Tensor
    LIFT: torch.Tensor
    fnodes: torch.Tensor
    Ginv: torch.Tensor
    Fscale: torch.Tensor
    normals: torch.Tensor
    nbr: torch.Tensor
    inv_rho: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    beta_t: torch.Tensor  # own-trace coefficient of the traction jump
    delta_u: torch.Tensor  # own-trace coefficient of the velocity jump
    # Godunov data: impedances, neighbour impedances, boundary ghosts
    zp: torch.Tensor
    zs: torch.Tensor
    zp_n: torch.Tensor
    zs_n: torch.Tensor
    ghost_u: torch.Tensor
    ghost_t: torch.Tensor
    tf32: bool = False  # the control: products' operands rounded to TF32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10-bit mantissa (to nearest,
    ties to even), as the tensor cores read a TF32 product's operands."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


def _product(p, eq: str, a, b):
    """The scheme's matrix products; in TF32 for the control."""
    if p.tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.einsum(eq, a, b)


def params(m: Mesh, rho, vp, vs, dtype, device) -> Params:
    """Operator data from the mesh and the per-element material; the
    flux coefficients encode the boundaries (free: t+ = t-, absorbing: a
    half-vanishing ghost; Godunov: the ghost states)."""
    E, nf = m.E, m.tab.nf
    rho, vp, vs = (np.array(np.broadcast_to(np.asarray(x, np.float64),
                                            (E,))) for x in (rho, vp, vs))
    mu = rho * vs ** 2
    lam = rho * vp ** 2 - 2 * mu
    beta_t = np.full((E, nf), -0.5)
    beta_t[m.bc == BC_FREE] = -1.5
    beta_t[m.bc == BC_ABSORB] = -1.0
    delta_u = np.full((E, nf), -0.5)
    delta_u[m.bc == BC_ABSORB] = -1.0
    nbr_e = m.nbr[:, :, 0] // m.tab.n_p
    gu, gt = np.ones((E, nf)), np.ones((E, nf))
    gt[m.bc == BC_FREE] = -1.0
    gu[m.bc == BC_ABSORB] = 0.0
    gt[m.bc == BC_ABSORB] = 0.0
    zp, zs = rho * vp, rho * vs

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(
            dtype)

    return Params(
        dim=m.tab.dim, Dr=t(m.tab.Dr), LIFT=t(m.tab.LIFT),
        fnodes=torch.as_tensor(m.tab.fnodes, device=device),
        Ginv=t(m.Ginv), Fscale=t(m.Fscale), normals=t(m.normals),
        nbr=torch.as_tensor(m.nbr.astype(np.int64), device=device),
        inv_rho=t(1.0 / rho), lam=t(lam), mu=t(mu), beta_t=t(beta_t),
        delta_u=t(delta_u), zp=t(zp), zs=t(zs), zp_n=t(zp[nbr_e]),
        zs_n=t(zs[nbr_e]), ghost_u=t(gu), ghost_t=t(gt))


# --- operators ---------------------------------------------------------

def _grad(p: Params, f):
    """(E, dim, n_p, C): d f / d x_d at the nodes."""
    return _product(p, "erd,eric->edic", p.Ginv,
                    _product(p, "rij,ejc->eric", p.Dr, f))


def _faces(p: Params, f):
    """Own and neighbour face traces, each (E, nf, n_fp, C)."""
    own = f[:, p.fnodes]
    nbr = f.reshape(-1, f.shape[-1])[p.nbr]
    return own, nbr


def _lift(p: Params, flux):
    E = flux.shape[0]
    return _product(p, "im,emc->eic", p.LIFT,
                    flux.reshape(E, -1, flux.shape[-1]))


def _traction(p: Params, nrm, sig):
    V, dim = VOIGT[p.dim], p.dim
    return torch.stack([sum(nrm[..., d] * sig[..., V[c, d]]
                            for d in range(dim)) for c in range(dim)], -1)


def _hooke(dim, lam, mu, g):
    tr = sum(g(d, d) for d in range(dim))
    out = [lam * tr + 2 * mu * g(c, c) for c in range(dim)]
    for a, b in ([(0, 1)] if dim == 2 else [(1, 2), (0, 2), (0, 1)]):
        out.append(mu * (g(a, b) + g(b, a)))
    return torch.stack(out, -1)


def vel_op(p: Params, s):
    """(1/rho) div(sigma) with the central flux."""
    V, dim = VOIGT[p.dim], p.dim
    g = _grad(p, s)
    div = torch.stack([sum(g[:, d, :, V[c, d]] for d in range(dim))
                       for c in range(dim)], -1)
    own, nbr = _faces(p, s)
    nrm = p.normals[:, :, None, :]
    jump = 0.5 * _traction(p, nrm, nbr) + p.beta_t[:, :, None, None] * \
        _traction(p, nrm, own)
    surf = _lift(p, jump * p.Fscale[:, :, None, None])
    return p.inv_rho[:, None, None] * (div + surf)


def stress_op(p: Params, u):
    """Hooke's law on sym grad(u) with the central flux."""
    g = _grad(p, u)
    vol = _hooke(p.dim, p.lam[:, None], p.mu[:, None],
                 lambda c, d: g[:, d, :, c])
    own, nbr = _faces(p, u)
    du = 0.5 * nbr + p.delta_u[:, :, None, None] * own
    nrm = p.normals[:, :, None, :]
    face = _hooke(p.dim, p.lam[:, None, None], p.mu[:, None, None],
                  lambda c, d: nrm[..., d] * du[..., c])
    return vol + _lift(p, face * p.Fscale[:, :, None, None])


def upwind_rhs(p: Params, u, s):
    """(du, ds) with Godunov (exact Riemann) fluxes."""
    V, dim = VOIGT[p.dim], p.dim
    gs = _grad(p, s)
    div = torch.stack([sum(gs[:, d, :, V[c, d]] for d in range(dim))
                       for c in range(dim)], -1)
    gu = _grad(p, u)
    vol_s = _hooke(dim, p.lam[:, None], p.mu[:, None],
                   lambda c, d: gu[:, d, :, c])
    u_m, u_n = _faces(p, u)
    s_m, s_n = _faces(p, s)
    nrm = p.normals[:, :, None, :]
    t_m = _traction(p, nrm, s_m)
    u_p = p.ghost_u[:, :, None, None] * u_n
    t_p = p.ghost_t[:, :, None, None] * _traction(p, nrm, s_n)

    def split(v):
        vn = sum(nrm[..., d] * v[..., d] for d in range(dim))[..., None]
        return vn * nrm, v - vn * nrm

    uNm, uTm = split(u_m)
    uNp, uTp = split(u_p)
    tNm, tTm = split(t_m)
    tNp, tTp = split(t_p)
    zpm, zsm = p.zp[:, None, None, None], p.zs[:, None, None, None]
    zpp, zsp = p.zp_n[:, :, None, None], p.zs_n[:, :, None, None]
    t_star = ((zpp * tNm + zpm * tNp + zpm * zpp * (uNp - uNm))
              / (zpm + zpp)
              + (zsp * tTm + zsm * tTp + zsm * zsp * (uTp - uTm))
              / (zsm + zsp))
    u_star = ((zpm * uNm + zpp * uNp + (tNp - tNm)) / (zpm + zpp)
              + (zsm * uTm + zsp * uTp + (tTp - tTm)) / (zsm + zsp))
    fs = p.Fscale[:, :, None, None]
    du = p.inv_rho[:, None, None] * (div + _lift(p, (t_star - t_m) * fs))
    dflux = u_star - u_m
    face = _hooke(dim, p.lam[:, None, None], p.mu[:, None, None],
                  lambda c, d: nrm[..., d] * dflux[..., c])
    return du, vol_s + _lift(p, face * fs)


# --- source, sponge, receivers ----------------------------------------

def ricker(t, f0, t0):
    tau = (np.pi * f0 * (t - t0)) ** 2
    return (1.0 - 2.0 * tau) * np.exp(-tau)


@dataclass
class Source:
    elems: torch.Tensor  # (K,)
    vec_s: torch.Tensor  # (K, n_p, n_sig): stress-rate pattern
    f0: float
    t0: float


def explosive_source(m: Mesh, pos, f0, radius, dtype, device) -> Source:
    """An isotropic moment at ``pos``: a normalised Gaussian of standard
    deviation ``radius`` projected onto the DG space, Ricker delay
    1.2 / f0."""
    tab, pos = m.tab, np.asarray(pos, np.float64)
    cent = m.coords.mean(axis=1)
    near = np.flatnonzero(np.linalg.norm(cent - pos, axis=1)
                          < 5.0 * radius + m.h.max())
    xq = np.einsum("qi,eid->eqd", tab.Vq, m.coords[near])
    g = np.exp(-((xq - pos) ** 2).sum(-1) / (2.0 * radius * radius))
    g /= np.einsum("e,q,eq->", m.detJ[near], tab.qw, g)
    coef = np.einsum("q,qi,eq->ei", tab.qw, tab.Vq, g) @ tab.Minv.T
    vec = np.zeros((len(near), tab.n_p, n_sig(tab.dim)))
    vec[:, :, :tab.dim] = coef[:, :, None]
    return Source(elems=torch.as_tensor(near, device=device),
                  vec_s=torch.as_tensor(vec, device=device).to(dtype),
                  f0=float(f0), t0=1.2 / float(f0))


def inject(src: Source, ds, t):
    return ds.index_add(0, src.elems,
                        src.vec_s * float(ricker(t, src.f0, src.t0)))


def sponge(m: Mesh, sides, width, alpha=2.0) -> np.ndarray:
    """(E, n_p) Cerjan taper: exp(-(alpha (1 - d/W))^2) within W of each
    absorbing side (axis, "lo" | "hi")."""
    g = np.ones(m.coords.shape[:2])
    lo_hi = [(m.vertices[:, a].min(), m.vertices[:, a].max())
             for a in range(m.tab.dim)]
    for ax, side in sides:
        lo, hi = lo_hi[ax]
        d = m.coords[:, :, ax] - lo if side == "lo" else \
            hi - m.coords[:, :, ax]
        taper = np.exp(-(alpha * (1 - np.clip(d, 0, width) / width)) ** 2)
        g = np.where(d < width, g * taper, g)
    return g


@dataclass
class Receivers:
    """Every element that holds each receiver point (one unless the point
    lies on a face) and its basis weights there."""

    cand: list  # per receiver: (elems tensor, weights tensor (k, n_p))


def receivers(m: Mesh, pts, dtype, device) -> Receivers:
    out = []
    for elems, xi in m.locate(pts):
        out.append((torch.as_tensor(elems, device=device),
                    torch.as_tensor(m.tab.basis(xi), device=device).to(
                        dtype)))
    return Receivers(cand=out)


def sample(rcv: Receivers, u):
    """(R, k_max, dim) samples at every candidate element (padded with
    the first candidate's)."""
    k_max = max(len(e) for e, _ in rcv.cand)
    rows = []
    for e, w in rcv.cand:
        v = torch.einsum("ki,kic->kc", w, u[e])
        rows.append(torch.cat([v, v[:1].expand(k_max - len(e), -1)]))
    return torch.stack(rows)


# --- time stepping ------------------------------------------------------

def _npdt(x):
    """Step times are computed in the run's precision."""
    return np.float64 if x.dtype == torch.float64 else np.float32


def run_lf4(p: Params, src: Source, damp, rcv: Receivers, u, s, dt, k,
            step0):
    """k LF4 steps of the staggered leapfrog from step ``step0`` (u at
    t = step0 dt, sigma half a step later); returns (u, s, samples
    (k, R, k_max, dim))."""
    npdt = _npdt(u)
    dt = npdt(dt)
    c3 = dt ** 3 / 24.0
    dmp = damp[:, :, None]
    rec = []
    for n in range(step0, step0 + k):
        t = npdt(n) * dt
        uh1 = vel_op(p, s)
        u = u + dt * uh1 + c3 * vel_op(p, stress_op(p, uh1))
        sh1 = inject(src, stress_op(p, u), t + dt)
        s = s + dt * sh1 + c3 * stress_op(p, vel_op(p, sh1))
        u, s = u * dmp, s * dmp
        rec.append(sample(rcv, u))
    return u, s, torch.stack(rec)


def run_rk4(p: Params, src: Source, damp, rcv: Receivers, u, s, dt, k,
            step0):
    """k classic RK4 steps with Godunov fluxes (u and sigma co-located)."""
    npdt = _npdt(u)
    dt = npdt(dt)
    h2 = dt / 2

    def rhs(u_, s_, t):
        du, ds = upwind_rhs(p, u_, s_)
        return du, inject(src, ds, t)

    dmp = damp[:, :, None]
    rec = []
    for n in range(step0, step0 + k):
        t = npdt(n) * dt
        k1 = rhs(u, s, t)
        k2 = rhs(u + h2 * k1[0], s + h2 * k1[1], t + h2)
        k3 = rhs(u + h2 * k2[0], s + h2 * k2[1], t + h2)
        k4 = rhs(u + dt * k3[0], s + dt * k3[1], t + dt)
        u = u + (dt / 6) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        s = s + (dt / 6) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        u, s = u * dmp, s * dmp
        rec.append(sample(rcv, u))
    return u, s, torch.stack(rec)


SCHEMES = {"lf4": run_lf4, "rk4": run_rk4}
