"""Elastic velocity-stress DG operators — the plain torch einsum path.

Port of ``seigen_tpu/ops/elastic.py``.  Each operator application is a few
batched einsums over all elements:

  - volume term: reference-derivative matmuls contracted with per-element
    inverse-Jacobian factors (strong form, inverse mass folded into Dr and
    LIFT, so no separate mass solve),
  - face term: one gather of neighbour traces through the face-owner index
    array ``nbr``, the central numerical flux, and a LIFT matmul.

Boundary conditions enter as per-(element, face) linear coefficients on the
own/neighbour traces (free surface = mirrored traction, absorbing =
half-vanishing ghost), so there is no control flow on the device.

These functions are the port's in-package oracle for the lane-major kernels.

State layout: elements are the batch axis.
  u     : (E, n_p, dim)      velocity
  sigma : (E, n_p, n_sig)    stress in Voigt order
Voigt order: 2D [xx, yy, xy]; 3D [xx, yy, zz, yz, xz, xy].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.discrete import BC_ABSORB, BC_FREE, BC_RIGID, DiscreteMesh

# Voigt index of tensor entry (c, d)
VOIGT_2D = np.array([[0, 2], [2, 1]])
VOIGT_3D = np.array([[0, 5, 4], [5, 1, 3], [4, 3, 2]])

# tensor fields of ElasticParams, in declaration order
PARAM_TENSORS = ("Dr", "LIFT", "Ginv", "Fscale", "normals", "nbr", "inv_rho",
                 "lam", "mu", "beta_t", "delta_u")


def voigt_map(dim: int) -> np.ndarray:
    return VOIGT_2D if dim == 2 else VOIGT_3D


def n_sig_for(dim: int) -> int:
    return 3 if dim == 2 else 6


@dataclass(frozen=True)
class ElasticParams:
    """Device-resident operator data; the int/tuple fields are static."""

    # reference tables
    Dr: torch.Tensor  # (dim, n_p, n_p)
    LIFT: torch.Tensor  # (n_p, n_faces * n_fp)
    # geometry
    Ginv: torch.Tensor  # (E, dim, dim)
    Fscale: torch.Tensor  # (E, n_faces)
    normals: torch.Tensor  # (E, n_faces, dim)
    nbr: torch.Tensor  # (E, n_faces, n_fp) int64 into flat (E*n_p)
    # material (per element)
    inv_rho: torch.Tensor  # (E,)
    lam: torch.Tensor  # (E,)
    mu: torch.Tensor  # (E,)
    # flux coefficients (encode BCs; see build_params)
    beta_t: torch.Tensor  # (E, n_faces) own-trace coeff in traction jump
    delta_u: torch.Tensor  # (E, n_faces) own-trace coeff in velocity jump
    # static metadata
    dim: int
    degree: int
    n_p: int
    n_faces: int
    n_fp: int
    n_sig: int
    fnodes: tuple  # ((...face0 node ids...), ...)

    @property
    def device(self) -> torch.device:
        return self.Ginv.device

    @property
    def dtype(self) -> torch.dtype:
        return self.Ginv.dtype


@dataclass(frozen=True)
class Material:
    """Per-element material; scalars broadcast. vp/vs/rho convention."""

    rho: np.ndarray | float
    vp: np.ndarray | float
    vs: np.ndarray | float

    @property
    def mu(self):
        return np.asarray(self.rho) * np.asarray(self.vs) ** 2

    @property
    def lam(self):
        return (
            np.asarray(self.rho) * np.asarray(self.vp) ** 2 - 2.0 * self.mu
        )

    @staticmethod
    def from_lame(rho, lam, mu) -> "Material":
        rho, lam, mu = map(np.asarray, (rho, lam, mu))
        return Material(
            rho=rho,
            vp=np.sqrt((lam + 2 * mu) / rho),
            vs=np.sqrt(mu / rho),
        )


def params_from_numpy(arrays: dict, device, dtype) -> ElasticParams:
    """ElasticParams from host arrays keyed by field name.

    ``arrays`` holds every tensor field (``PARAM_TENSORS``) plus ``fnodes``
    and ``degree``: e.g. ``{f.name: np.asarray(getattr(p, f.name))}`` over
    the fields of another package's ElasticParams, so both packages run on
    the same parameters.  The remaining sizes follow from the shapes.
    """
    missing = [k for k in PARAM_TENSORS + ("fnodes", "degree")
               if k not in arrays]
    if missing:
        raise KeyError(f"params_from_numpy: missing fields {missing}")
    t = {k: torch.as_tensor(np.array(arrays[k]), device=device)
         for k in PARAM_TENSORS}
    t = {k: (v.to(torch.int64) if k == "nbr" else v.to(dtype))
         for k, v in t.items()}
    dim, n_p = t["Dr"].shape[0], t["Dr"].shape[1]
    fnodes = np.asarray(arrays["fnodes"], dtype=np.int64)
    return ElasticParams(
        **t,
        dim=int(dim),
        degree=int(np.asarray(arrays["degree"])),
        n_p=int(n_p),
        n_faces=int(fnodes.shape[0]),
        n_fp=int(fnodes.shape[1]),
        n_sig=n_sig_for(int(dim)),
        fnodes=tuple(tuple(row) for row in fnodes.tolist()),
    )


def build_params(
    dm: DiscreteMesh,
    mat: Material,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    flux: str = "central",
) -> ElasticParams:
    """Assemble device operator data from the discrete mesh + material.

    flux: "central" only (reference parity).  A dissipative upwind flux
    would couple u and sigma traces in both equations, which is
    incompatible with the staggered leapfrog scheme.
    """
    if flux != "central":
        raise ValueError(f"unknown flux {flux!r}")
    re = dm.re
    E = dm.num_elements

    rho = np.broadcast_to(np.asarray(mat.rho, dtype=np.float64), (E,))
    lam = np.broadcast_to(np.asarray(mat.lam, dtype=np.float64), (E,))
    mu = np.broadcast_to(np.asarray(mat.mu, dtype=np.float64), (E,))

    # Flux jump coefficients: jump = 0.5 * gathered_plus + beta * own.
    #   interior: 0.5 (s+ - s-)        -> beta_t = -0.5
    #   free:     -(n . s-)  (t+ := t-) -> beta_t = -1.5
    #   absorb:   -0.5 (n . s-)         -> beta_t = -1.0
    #   rigid:    t unconstrained (t_hat = t-) -> jump 0 -> beta_t = -0.5
    beta_t = np.full((E, re.n_faces), -0.5)
    beta_t[dm.bc == BC_FREE] = -1.5
    beta_t[dm.bc == BC_ABSORB] = -1.0
    #   interior: 0.5 (u+ - u-)         -> delta_u = -0.5
    #   free:     0            (u+ = u-) -> delta_u = -0.5
    #   absorb:   -0.5 u-                -> delta_u = -1.0
    #   rigid:    u_hat = 0 -> jump = -u-   -> delta_u = -1.5
    delta_u = np.full((E, re.n_faces), -0.5)
    delta_u[dm.bc == BC_ABSORB] = -1.0
    delta_u[dm.bc == BC_RIGID] = -1.5

    return params_from_numpy(
        dict(Dr=re.Dr, LIFT=re.LIFT, Ginv=dm.Ginv, Fscale=dm.Fscale,
             normals=dm.normals, nbr=dm.nbr, inv_rho=1.0 / rho, lam=lam,
             mu=mu, beta_t=beta_t, delta_u=delta_u, fnodes=re.fnodes,
             degree=re.degree),
        device, dtype)


def _phys_grad(p: ElasticParams, field: torch.Tensor) -> torch.Tensor:
    """(E, dim, n_p, C): physical derivatives d field / d x_d at the nodes."""
    der = torch.einsum("rij,ejc->eric", p.Dr, field)
    return torch.einsum("erd,eric->edic", p.Ginv, der)


def _traces(p: ElasticParams, field: torch.Tensor):
    """Own and neighbour face traces: each (E, n_faces, n_fp, C)."""
    fn = torch.as_tensor(np.array(p.fnodes), device=field.device)
    own = field[:, fn]  # (E, n_faces, n_fp, C)
    flat = field.reshape((-1,) + field.shape[2:])
    nbr = flat[p.nbr]  # (E, n_faces, n_fp, C)
    return own, nbr


def _lift(p: ElasticParams, face_flux: torch.Tensor) -> torch.Tensor:
    """(E, n_faces, n_fp, C) scaled face flux -> (E, n_p, C) via LIFT."""
    E = face_flux.shape[0]
    flat = face_flux.reshape(E, p.n_faces * p.n_fp, -1)
    return torch.einsum("im,emc->eic", p.LIFT, flat)


def apply_vel_op(p: ElasticParams, sigma: torch.Tensor) -> torch.Tensor:
    """A_u(sigma) = Minv * Lu(sigma): discrete (1/rho) div(sigma)."""
    V = voigt_map(p.dim)
    grad = _phys_grad(p, sigma)  # (E, dim, n_p, n_sig)
    # div(sigma)_c = d_d sigma_{cd}
    div = torch.stack(
        [
            sum(grad[:, d, :, V[c, d]] for d in range(p.dim))
            for c in range(p.dim)
        ],
        dim=-1,
    )  # (E, n_p, dim)

    own, nbr = _traces(p, sigma)
    nrm = p.normals[:, :, None, :]  # (E, n_faces, 1, dim)
    # tractions t_c = n_d sigma_{cd}
    t_own = torch.stack(
        [
            sum(nrm[..., d] * own[..., V[c, d]] for d in range(p.dim))
            for c in range(p.dim)
        ],
        dim=-1,
    )
    t_nbr = torch.stack(
        [
            sum(nrm[..., d] * nbr[..., V[c, d]] for d in range(p.dim))
            for c in range(p.dim)
        ],
        dim=-1,
    )
    jump_t = 0.5 * t_nbr + p.beta_t[:, :, None, None] * t_own
    flux = jump_t * p.Fscale[:, :, None, None]
    surf = _lift(p, flux)
    return p.inv_rho[:, None, None] * (div + surf)


def _hooke(dim, lam, mu, gd):
    """gd(c, d) -> Voigt components of lam tr(e) I + 2 mu sym(e), a list."""
    tr = sum(gd(d, d) for d in range(dim))
    comps = [lam * tr + 2.0 * mu * gd(c, c) for c in range(dim)]
    if dim == 2:
        comps.append(mu * (gd(0, 1) + gd(1, 0)))  # xy
    else:
        comps.append(mu * (gd(1, 2) + gd(2, 1)))  # yz
        comps.append(mu * (gd(0, 2) + gd(2, 0)))  # xz
        comps.append(mu * (gd(0, 1) + gd(1, 0)))  # xy
    return comps


def apply_stress_op(p: ElasticParams, u: torch.Tensor) -> torch.Tensor:
    """A_s(u) = Minv * Ls(u): discrete Hooke's law applied to sym grad(u)."""
    grad = _phys_grad(p, u)  # (E, dim, n_p, dim): grad[:, d, :, c] = du_c/dx_d
    vol = torch.stack(
        _hooke(p.dim, p.lam[:, None], p.mu[:, None],
               lambda c, d: grad[:, d, :, c]), dim=-1)

    own, nbr = _traces(p, u)
    du = 0.5 * nbr + p.delta_u[:, :, None, None] * own  # (E, nf, nfp, dim)
    nrm = p.normals[:, :, None, :]
    # face Hooke on the symmetrised (n (x) du)
    face = torch.stack(
        _hooke(p.dim, p.lam[:, None, None], p.mu[:, None, None],
               lambda c, d: nrm[..., d] * du[..., c]), dim=-1)
    surf = _lift(p, face * p.Fscale[:, :, None, None])
    return vol + surf
