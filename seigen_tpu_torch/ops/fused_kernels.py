"""Operator data for the trace-carrying lane-major operators.

Port of ``seigen_tpu/ops/fused_kernels.py:FusedOpData`` / ``build_fused_data``
(unpacked).  The tables keep the JAX package's row layout, so
``geo``, ``drr`` and ``lift`` compare row for row with the reference:

  geo row layout (8-aligned sections; offsets in ``off``):
    ginv  dim*dim rows (r*dim+d)
    nrm   dim sections of 8 rows each, rows f<nf hold normal component d
    scb   0.5 * Fscale            (rows f<nf)
    bfs   beta_t * Fscale
    dfs   delta_u * Fscale
    mat   row 0 = 1/rho, row 1 = lambda, row 2 = mu
    C     (only with ``stiffness``) n_sig sections of 8 rows each, row
          c*8 + k = Voigt C[c, k], rows n_sig..7 of a section zero

  drr   (dim*npp + ftpp, npp): [Dr stack; own-face restriction R]
  lift  (npp, ftpp)

Flux/BC semantics are those of ops/elastic.py (jump = 0.5*nbr +
beta/delta*own with Fscale folded: scb = 0.5*Fscale, bfs = beta_t*Fscale,
dfs = delta_u*Fscale).

Not ported yet: the P1 two-elements-per-lane layout
(``build_packed_fused_data``).
The CUDA kernels compute in plain FP32 FFMA, so the JAX package's bf16
three-pass in-kernel matmul scheme has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .elastic import ElasticParams


def _rup(x, m=8):
    return ((x + m - 1) // m) * m


def stiffness_array(stiffness, E: int, n_sig: int) -> np.ndarray:
    """(E, n_sig, n_sig) float64 host view of a Voigt stiffness given as
    one matrix or one per element (numpy or tensor)."""
    if isinstance(stiffness, torch.Tensor):
        stiffness = stiffness.detach().cpu().numpy()
    return np.broadcast_to(np.asarray(stiffness, dtype=np.float64),
                           (E, n_sig, n_sig))


@dataclass(frozen=True)
class FusedOpData:
    """Operator data for the lane-major operators (see module docstring)."""

    drr: torch.Tensor  # (dim*npp + ftpp, npp): [Dr stack; own-face restriction]
    lift: torch.Tensor  # (npp, ftpp)
    geo: torch.Tensor  # (G_ROWS, E)
    damp: torch.Tensor | None  # (npp, E) or None
    dim: int
    n_p: int
    npp: int
    ftp: int
    ftpp: int
    n_sig: int
    E: int
    nf: int
    n_fp: int
    off: tuple  # (ginv, nrm, scb, bfs, dfs, mat, C or -1, total)
    fnodes: tuple  # ((...face0 node ids...), ...)


def build_fused_data(p: ElasticParams, damp=None, stiffness=None,
                     packed: bool = False) -> FusedOpData:
    """Fused operator data on p's device and dtype, columns in p's element
    order.  ``damp``: optional (E, n_p) sponge factors (numpy or tensor).
    ``stiffness``: optional (E, n_sig, n_sig) (or broadcastable) per-element
    Voigt stiffness (engineering strains, ops/anisotropic.py conventions)
    in the SAME element order as p — adds the ``C`` section, which switches
    the stress operators to the general Hooke law."""
    if packed:
        raise NotImplementedError("the packed P1 layout is not ported yet")
    dim, n_p = p.dim, p.n_p
    npp = _rup(n_p)
    nf, n_fp = p.n_faces, p.n_fp
    ftp = nf * n_fp
    ftpp = _rup(ftp)
    E = p.Ginv.shape[0]

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    Dr = np.zeros((dim * npp, npp), dtype=np.float64)
    for r in range(dim):
        Dr[r * npp : r * npp + n_p, :n_p] = host(p.Dr[r])
    LIFT = np.zeros((npp, ftpp), dtype=np.float64)
    LIFT[:n_p, :ftp] = host(p.LIFT)
    fn = np.array(p.fnodes).reshape(-1)
    R = np.zeros((ftpp, npp), dtype=np.float64)
    R[np.arange(ftp), fn] = 1.0

    # geo sections
    o_ginv = 0
    o_nrm = o_ginv + _rup(dim * dim)
    o_scb = o_nrm + 8 * dim
    o_bfs = o_scb + 8
    o_dfs = o_bfs + 8
    o_mat = o_dfs + 8
    n_sig = p.n_sig
    o_C = o_mat + 8 if stiffness is not None else -1
    total = o_mat + 8 + (n_sig * 8 if stiffness is not None else 0)
    geo = np.zeros((total, E), dtype=np.float64)
    geo[: dim * dim] = host(p.Ginv).transpose(1, 2, 0).reshape(dim * dim, E)
    fsc = host(p.Fscale)  # (E, nf)
    nrm = host(p.normals)
    for d in range(dim):
        geo[o_nrm + 8 * d : o_nrm + 8 * d + nf] = nrm[:, :, d].T
    geo[o_scb : o_scb + nf] = (0.5 * fsc).T
    geo[o_bfs : o_bfs + nf] = (host(p.beta_t) * fsc).T
    geo[o_dfs : o_dfs + nf] = (host(p.delta_u) * fsc).T
    geo[o_mat + 0] = host(p.inv_rho)
    geo[o_mat + 1] = host(p.lam)
    geo[o_mat + 2] = host(p.mu)
    if stiffness is not None:
        C = stiffness_array(stiffness, E, n_sig)
        for c in range(n_sig):
            geo[o_C + c * 8 : o_C + c * 8 + n_sig] = C[:, c, :].T

    def dev(a):
        return torch.as_tensor(a, device=p.device).to(p.dtype)

    dmp = None
    if damp is not None:
        dn = np.zeros((npp, E), dtype=np.float64)
        dn[:n_p] = np.asarray(
            damp.detach().cpu() if isinstance(damp, torch.Tensor) else damp,
            dtype=np.float64).T
        dmp = dev(dn)

    return FusedOpData(
        drr=dev(np.concatenate([Dr, R], axis=0)),
        lift=dev(LIFT),
        geo=dev(geo),
        damp=dmp,
        dim=dim,
        n_p=n_p,
        npp=npp,
        ftp=ftp,
        ftpp=ftpp,
        n_sig=p.n_sig,
        E=E,
        nf=nf,
        n_fp=n_fp,
        off=(o_ginv, o_nrm, o_scb, o_bfs, o_dfs, o_mat, o_C, total),
        fnodes=p.fnodes,
    )
