"""Direction-split DG operators for convolutional PML (C-PML).

Port of ``seigen_tpu/ops/cpml.py``.  Unsplit C-PML (Komatitsch & Martin
2007 style, kappa=1) replaces each spatial derivative with a
memory-augmented one,

    d~/dx_d f  =  d/dx_d f + psi_d,
    d psi_d/dt = -(d_d + alpha_d) psi_d - d_d * (d/dx_d f),

so the wavefield decays inside graded-damping layers without the interface
reflection of a Cerjan sponge (solver/damping.py).

The DG twist: the discrete derivative is volume-matmul PLUS lifted face
flux, so the direction split must carry the face term's n_d weighting with
it.  Both are split here EXACTLY:

  - ``apply_vel_op_split``: direction-d contribution to div(sigma) with the
    traction-jump lift (n_d sigma_{cd} pieces), NOT multiplied by 1/rho;
    summing over d and scaling by inv_rho reproduces
    ops.elastic.apply_vel_op to roundoff.
  - ``apply_grad_op_split``: direction-d DG derivative of the velocity
    (volume + lifted n_d * velocity-jump); the stress operator is
    ``hooke_pointwise`` of the summed split (per-element (lam, mu) commute
    with LIFT).

Both inherit every BC kind (free/absorb/rigid) unchanged: the BC flux
coefficients (beta_t, delta_u) are per-(element, face) scalars that commute
with the per-direction n_d weighting.  These are the plain torch einsum
operators of the C-PML oracle (solver/pml.py); the lane runner
(solver/lane_cpml.py) gets the same split from the K1/K2 kernels.
"""

from __future__ import annotations

import torch

from .elastic import ElasticParams, _hooke, _lift, _phys_grad, _traces, \
    voigt_map


def apply_vel_op_split(p: ElasticParams, sigma: torch.Tensor) -> torch.Tensor:
    """(E, dim, n_p, dim): direction-d contribution to the velocity RHS.

    out[:, d, :, c] = d sigma_{cd} / dx_d + LIFT(Fscale * n_d * jump_{cd})
    with sum_d out[:, d] * inv_rho == apply_vel_op.
    """
    V = voigt_map(p.dim)
    grad = _phys_grad(p, sigma)  # (E, dim, n_p, n_sig)
    own, nbr = _traces(p, sigma)
    # componentwise jump with the BC coefficients (commutes with n_d)
    jmp = 0.5 * nbr + p.beta_t[:, :, None, None] * own  # (E, nf, nfp, n_sig)
    nrm = p.normals[:, :, None, :]
    fs = p.Fscale[:, :, None, None]
    out = []
    for d in range(p.dim):
        vol_d = torch.stack(
            [grad[:, d, :, V[c, d]] for c in range(p.dim)], dim=-1)
        face_d = torch.stack(
            [nrm[..., d] * jmp[..., V[c, d]] for c in range(p.dim)], dim=-1)
        out.append(vol_d + _lift(p, face_d * fs))
    return torch.stack(out, dim=1)


def apply_grad_op_split(p: ElasticParams, u: torch.Tensor) -> torch.Tensor:
    """(E, dim, n_p, dim): direction-d DG derivative of the velocity.

    out[:, d, :, c] = d u_c / dx_d + LIFT(Fscale * n_d * du_c) with
    hooke_pointwise(out) == apply_stress_op; the d axis is the gradient
    matrix's row index, consumed by Hooke, never summed alone.
    """
    grad = _phys_grad(p, u)  # (E, dim, n_p, dim)
    own, nbr = _traces(p, u)
    du = 0.5 * nbr + p.delta_u[:, :, None, None] * own  # (E, nf, nfp, dim)
    nrm = p.normals[:, :, None, :]
    fs = p.Fscale[:, :, None, None]
    out = [grad[:, d] + _lift(p, du * nrm[..., d : d + 1] * fs)
           for d in range(p.dim)]
    return torch.stack(out, dim=1)


def hooke_pointwise(p: ElasticParams, gmat: torch.Tensor) -> torch.Tensor:
    """Isotropic Hooke applied to a gradient-like array.

    gmat: (E, dim, n_p, dim) with gmat[:, d, :, c] = (d u_c / dx_d)-like;
    returns (E, n_p, n_sig) Voigt stress rates.  Per-element (lam, mu) make
    this commute with LIFT, which lets the C-PML stress update run Hooke
    once on the memory-augmented gradient matrix.
    """
    return torch.stack(
        _hooke(p.dim, p.lam[:, None], p.mu[:, None],
               lambda c, d: gmat[:, d, :, c]), dim=-1)
