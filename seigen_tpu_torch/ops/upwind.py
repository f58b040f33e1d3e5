"""Upwind (Godunov) flux coupled elastic operator + impedance data.

Port of ``seigen_tpu/ops/upwind.py``.  The central flux (ops/elastic.py) is
non-dissipative, as the staggered leapfrog scheme needs, but admits spurious
high-wavenumber modes.  The exact-Riemann (Godunov) interface flux for
isotropic elasticity upwinds along characteristics and damps them; it pairs
with RK4 (solver/rk4.py), since it couples u and sigma traces in both
equations.

Riemann states at a face with outward normal n, own/neighbour traces
(u-, t- = sigma- . n) / (u+, t+) and P/S impedances Zp = rho vp, Zs = rho vs:

  t*_N = [Zp+ t-_N + Zp- t+_N + Zp- Zp+ (u+_N - u-_N)] / (Zp- + Zp+)
  t*_T = [Zs+ t-_T + Zs- t+_T + Zs- Zs+ (u+_T - u-_T)] / (Zs- + Zs+)
  u*_N = [Zp- u-_N + Zp+ u+_N + (t+_N - t-_N)] / (Zp- + Zp+)
  u*_T = [Zs- u-_T + Zs+ u+_T + (t+_T - t-_T)] / (Zs- + Zs+)

(N/T = normal/tangential projections.)  Strong-form corrections are
LIFT(n.(t* - t-))/rho for the velocity equation and C:(sym(n x (u* - u-)))
for the stress equation.  Boundary ghosts: free surface (t+ = -t-, u+ = u-)
gives t* = 0; rigid (u+ = -u-, t+ = t-) gives u* = 0; absorbing uses the
zero exterior state.  Where Zs- + Zs+ = 0 (acoustic media) the tangential
states fall back to the average of the two sides.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..mesh.discrete import BC_ABSORB, BC_FREE, BC_RIGID, DiscreteMesh
from .elastic import ElasticParams, Material, _lift, _phys_grad, voigt_map


@dataclass(frozen=True)
class UpwindData:
    """Per-face impedances + boundary ghost coefficients."""

    zp_own: torch.Tensor  # (E, 1, 1) P impedance of the element
    zs_own: torch.Tensor  # (E, 1, 1)
    zp_nbr: torch.Tensor  # (E, nf, 1) neighbour P impedance at each face
    zs_nbr: torch.Tensor  # (E, nf, 1)
    # ghost state: u+ = gu * u_gathered, t+ = gt * t_gathered (interior: 1)
    ghost_u: torch.Tensor  # (E, nf, 1)
    ghost_t: torch.Tensor  # (E, nf, 1)


def upwind_data_from_numpy(arrays: dict, device, dtype) -> UpwindData:
    """UpwindData from host arrays keyed by field name, e.g. the fields of
    another package's UpwindData as numpy arrays."""
    return UpwindData(**{
        f.name: torch.as_tensor(np.array(arrays[f.name]), device=device).to(
            dtype) for f in fields(UpwindData)})


def build_upwind_data(dm: DiscreteMesh, mat: Material,
                      dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cuda") -> UpwindData:
    E = dm.num_elements
    nf = dm.re.n_faces
    rho = np.broadcast_to(np.asarray(mat.rho, np.float64), (E,))
    vp = np.broadcast_to(np.asarray(mat.vp, np.float64), (E,))
    vs = np.broadcast_to(np.asarray(mat.vs, np.float64), (E,))
    zp = rho * vp
    zs = rho * vs

    # boundary faces gather own traces, so their neighbour impedance is the
    # element's own (nbr_e == own element id there)
    nbr_e = dm.nbr[:, :, 0] // dm.re.n_p  # (E, nf) neighbour element ids
    gu = np.ones((E, nf))
    gt = np.ones((E, nf))
    gu[dm.bc == BC_RIGID] = -1.0
    gt[dm.bc == BC_FREE] = -1.0
    gu[dm.bc == BC_ABSORB] = 0.0
    gt[dm.bc == BC_ABSORB] = 0.0
    return upwind_data_from_numpy(dict(
        zp_own=zp.reshape(E, 1, 1), zs_own=zs.reshape(E, 1, 1),
        zp_nbr=zp[nbr_e].reshape(E, nf, 1), zs_nbr=zs[nbr_e].reshape(E, nf, 1),
        ghost_u=gu.reshape(E, nf, 1), ghost_t=gt.reshape(E, nf, 1)),
        device, dtype)


def _face_values(p: ElasticParams, field, traces):
    """(own, nbr) face traces (E, nf, nfp, C) from field + gathered traces."""
    fn = torch.as_tensor(np.array(p.fnodes), device=field.device)
    own = field[:, fn]
    nbr = traces.reshape(own.shape[0], p.n_faces, p.n_fp, -1)
    return own, nbr


def _traction(p, nrm, sig_face):
    """(E, nf, nfp, dim) traction n . sigma from Voigt face traces."""
    V = voigt_map(p.dim)
    return torch.stack(
        [sum(nrm[..., d] * sig_face[..., V[c, d]] for d in range(p.dim))
         for c in range(p.dim)], dim=-1)


def apply_coupled_upwind(p: ElasticParams, w: UpwindData, u, s, u_traces,
                         s_traces):
    """(du, ds) with Godunov fluxes; traces pre-gathered (E, nf*nfp, C)."""
    V = voigt_map(p.dim)
    dim = p.dim

    # --- volume terms (same strong form as the central path) ---
    grad_s = _phys_grad(p, s)
    div = torch.stack(
        [sum(grad_s[:, d, :, V[c, d]] for d in range(dim))
         for c in range(dim)], dim=-1)
    grad_u = _phys_grad(p, u)
    lam = p.lam[:, None]
    mu = p.mu[:, None]
    divu = sum(grad_u[:, d, :, d] for d in range(dim))
    vol_s = [lam * divu + 2.0 * mu * grad_u[:, c, :, c] for c in range(dim)]
    if dim == 2:
        vol_s.append(mu * (grad_u[:, 1, :, 0] + grad_u[:, 0, :, 1]))
    else:
        vol_s.append(mu * (grad_u[:, 2, :, 1] + grad_u[:, 1, :, 2]))
        vol_s.append(mu * (grad_u[:, 2, :, 0] + grad_u[:, 0, :, 2]))
        vol_s.append(mu * (grad_u[:, 1, :, 0] + grad_u[:, 0, :, 1]))
    vol_s = torch.stack(vol_s, dim=-1)

    # --- Riemann fluxes at face nodes ---
    u_own, u_nbr = _face_values(p, u, u_traces)
    s_own, s_nbr = _face_values(p, s, s_traces)
    nrm = p.normals[:, :, None, :]  # (E, nf, 1, dim)
    t_own = _traction(p, nrm, s_own)
    t_nbr = _traction(p, nrm, s_nbr)

    # boundary ghosts (interior: coefficients are 1 -> plain neighbour)
    u_plus = w.ghost_u[:, :, :, None] * u_nbr
    t_plus = w.ghost_t[:, :, :, None] * t_nbr

    def split(vec):
        vn = sum(nrm[..., d] * vec[..., d] for d in range(dim))[..., None]
        return vn * nrm, vec - vn * nrm

    uN_m, uT_m = split(u_own)
    uN_p, uT_p = split(u_plus)
    tN_m, tT_m = split(t_own)
    tN_p, tT_p = split(t_plus)

    zp_m = w.zp_own[:, :, :, None]
    zs_m = w.zs_own[:, :, :, None]
    zp_p = w.zp_nbr[:, :, :, None]
    zs_p = w.zs_nbr[:, :, :, None]

    # acoustic media (vs = 0): no shear characteristics exist, the
    # tangential Riemann contribution degenerates; guard the 0/0
    zs_sum = zs_m + zs_p
    has_shear = zs_sum > 0
    zs_safe = torch.where(has_shear, zs_sum, torch.ones_like(zs_sum))

    t_star = (
        (zp_p * tN_m + zp_m * tN_p + zp_m * zp_p * (uN_p - uN_m))
        / (zp_m + zp_p)
        + torch.where(
            has_shear,
            (zs_p * tT_m + zs_m * tT_p + zs_m * zs_p * (uT_p - uT_m))
            / zs_safe,
            0.5 * (tT_m + tT_p)))
    u_star = (
        (zp_m * uN_m + zp_p * uN_p + (tN_p - tN_m)) / (zp_m + zp_p)
        + torch.where(
            has_shear,
            (zs_m * uT_m + zs_p * uT_p + (tT_p - tT_m)) / zs_safe,
            0.5 * (uT_m + uT_p)))

    fsc = p.Fscale[:, :, None, None]
    surf_u = _lift(p, (t_star - t_own) * fsc)
    du = p.inv_rho[:, None, None] * (div + surf_u)

    du_flux = u_star - u_own
    lamf = p.lam[:, None, None]
    muf = p.mu[:, None, None]
    ndu = sum(nrm[..., d] * du_flux[..., d] for d in range(dim))
    comps = [lamf * ndu + 2.0 * muf * nrm[..., c] * du_flux[..., c]
             for c in range(dim)]
    pairs = [(0, 1)] if dim == 2 else [(1, 2), (0, 2), (0, 1)]
    for a, b in pairs:
        comps.append(muf * (nrm[..., a] * du_flux[..., b]
                            + nrm[..., b] * du_flux[..., a]))
    face_s = torch.stack(comps, dim=-1) * fsc
    ds = vol_s + _lift(p, face_s)
    return du, ds
