"""Curvilinear (isoparametric) elements: non-affine meshes.

Port of ``seigen_tpu/ops/curvilinear.py``.  Curved geometry is what
topography, boreholes and interior interfaces need; this module supplies it
as per-element OPERATOR MATRICES, so every application is a batched
(n_p, n_p) product over the element axis (torch ``einsum``), with E-many
small matrices instead of the shared tables of the affine paths.  The JAX
package computes these products outside any Pallas kernel, so they have no
kernel here either.

Formulation (isoparametric nodal DG, geometry degree = solution degree:
the geometry nodes ARE the solution nodes ``dm.coords``, curved by a
smooth map):

  x(xi) = sum_a X_a l_a(xi)          J(xi) = dx/dxi  (varies per point)

  M_e     = Vq^T diag(w detJ(xi_q)) Vq                (true cubature)
  D_e^(d) = M_e^-1 Vq^T diag(w detJ) [sum_r Jinv_rd(xi_q) dVq_r]
  L_e^(f) = M_e^-1 Vfq_f^T diag(w_f sJ(s_q))          (curved-face lift)

with per-face-quadrature-point outward normals n(s_q) and surface
Jacobians sJ from the physical face tangents (orientation fixed by the
Nanson direction detJ J^-T n_ref).  Neighbour traces reuse the node-level
gather (``ElasticParams.nbr``: matching is topological, so curved
conforming faces pair exactly like affine ones); the degree-q face trace is
interpolated node->face-quadrature exactly by the face Lagrange basis.  BC
flux coefficients (beta_t/delta_u) apply unchanged.

Affine limit: all quadratures are exact for straight elements, so the
curvilinear operators reproduce the affine einsum operators to roundoff
(tests/test_torch_curvilinear.py); the affine path stays the production
one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.discrete import DiscreteMesh
from ..refelem.tables import _eval_monomials, monomial_exponents
from .elastic import ElasticParams, _hooke, _traces, n_sig_for, voigt_map


@dataclass(frozen=True)
class CurviParams:
    """Per-element curvilinear operator data (device tensors)."""

    De: torch.Tensor  # (E, dim, n_p, n_p) strong physical derivative, Minv in
    Lf: torch.Tensor  # (E, n_faces, n_p, nfq) curved-face lift, Minv + sJ in
    Ff: torch.Tensor  # (n_faces, nfq, n_fp) face node -> face quad interp
    nrm_q: torch.Tensor  # (E, n_faces, nfq, dim) outward normals per point
    X: torch.Tensor  # (E, n_p, dim) physical (curved) node coordinates
    dim: int
    n_p: int
    n_faces: int
    nfq: int
    n_sig: int


def _ref_face_maps(re):
    """Per-face (V0, T) param->ref affine maps and outward ref normals."""
    verts = re.vertices  # (dim+1, dim)
    dim = re.dim
    out = []
    for f in range(re.n_faces):
        fv = verts[re.face_vertices[f]]  # (dim, dim)
        V0 = fv[0]
        T = (fv[1:] - V0).T  # (dim, fdim)
        # outward reference normal: orthogonal to the face span, pointing
        # away from the opposite vertex
        if dim == 2:
            t = T[:, 0]
            n = np.array([t[1], -t[0]])
        else:
            n = np.cross(T[:, 0], T[:, 1])
        n = n / np.linalg.norm(n)
        opp = verts[f]  # face f is opposite vertex f
        if np.dot(n, opp - V0) > 0:
            n = -n
        out.append((V0, T, n))
    return out


def build_curvi(dm: DiscreteMesh, X: np.ndarray,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> CurviParams:
    """Per-element curvilinear operator data from curved node coords ``X``
    (E, n_p, dim), e.g. a smooth map applied to ``dm.coords``.

    Host-side NumPy/f64 (set-up time, like build_discrete); the tensors are
    cast to ``dtype`` on ``device`` at the end.
    """
    re = dm.re
    dim, n_p, nf = re.dim, re.n_p, re.n_faces
    E = dm.num_elements
    X = np.asarray(X, np.float64)
    if X.shape != (E, n_p, dim):
        raise ValueError(f"X must be (E, n_p, dim) = {(E, n_p, dim)}")

    # --- volume: J, detJ, Jinv at the volume cubature points ---
    # J[e, q, d, r] = d x_d / d xi_r
    Jq = np.einsum("rqa,ead->eqdr", re.Vq_grad, X)
    detJq = np.linalg.det(Jq)  # (E, nq)
    if detJq.min() <= 0:
        raise ValueError("curved mapping folds elements (detJ <= 0); "
                         "reduce the curvature amplitude")
    Jinvq = np.linalg.inv(Jq)  # (E, nq, r, d): d xi_r / d x_d
    wdet = re.qw[None, :] * detJq  # (E, nq)

    M = np.einsum("qi,eq,qj->eij", re.Vq, wdet, re.Vq)
    Minv = np.linalg.inv(M)

    # D_e^(d): strong physical derivative projected back to nodal coeffs
    # W[e, d, q, j] = d l_j / d x_d at xi_q
    W = np.einsum("eqrd,rqj->edqj", Jinvq, re.Vq_grad)
    P = np.einsum("qi,eq,edqj->edij", re.Vq, wdet, W)
    De = np.einsum("eik,edkj->edij", Minv, P)

    # --- faces: tangents, surface Jacobian, outward normals, lift ---
    fdim = max(dim - 1, 1)
    nfq = re.fq_x.shape[0]
    fexps = monomial_exponents(fdim, re.degree)
    Lf = np.zeros((E, nf, n_p, nfq))
    nrm_q = np.zeros((E, nf, nfq, dim))
    Ff = np.zeros((nf, nfq, re.n_fp))
    for f, (V0, T, nref) in enumerate(_ref_face_maps(re)):
        vol_pts = V0 + re.fq_x @ T.T  # (nfq, dim) ref coords of face quad
        Gf = re.eval_basis_grad(vol_pts)  # (dim, nfq, n_p)
        # physical tangents wrt the face PARAMETER coords:
        # tg[e, q, d, k] = sum_a X[e,a,d] sum_r Gf[r,q,a] T[r,k]
        GT = np.einsum("rqa,rk->qak", Gf, T)  # (nfq, n_p, fdim)
        tg = np.einsum("ead,qak->eqdk", X, GT)
        if dim == 2:
            t = tg[..., 0]  # (E, nfq, 2)
            nvec = np.stack([t[..., 1], -t[..., 0]], axis=-1)
        else:
            nvec = np.cross(tg[..., 0], tg[..., 1])
        sJ = np.linalg.norm(nvec, axis=-1)  # (E, nfq)
        # orientation: Nanson direction detJ J^-T n_ref is outward
        Jf = np.einsum("rqa,ead->eqdr", Gf, X)
        ndir = np.einsum("eq,eqrd,r->eqd", np.linalg.det(Jf),
                         np.linalg.inv(Jf), nref)
        sgn = np.sign(np.einsum("eqd,eqd->eq", nvec, ndir))
        if np.any(sgn == 0):
            raise ValueError("degenerate face normal on curved face")
        nvec = nvec * sgn[..., None]
        nrm_q[:, f] = nvec / sJ[..., None]
        # lift: Minv Vfq^T diag(w_f sJ)
        Lf[:, f] = np.einsum(
            "eik,qk,eq->eiq", Minv, re.Vfq[f],
            re.fq_w[None, :] * sJ)
        # face node -> face quadrature interpolation (exact for degree q)
        Af = _eval_monomials(fexps, re.face_param_nodes[f])
        Ff[f] = _eval_monomials(fexps, re.fq_x) @ np.linalg.inv(Af)

    def dev(a):
        return torch.as_tensor(a, device=device).to(dtype)

    return CurviParams(
        De=dev(De), Lf=dev(Lf), Ff=dev(Ff), nrm_q=dev(nrm_q), X=dev(X),
        dim=dim, n_p=n_p, n_faces=nf, nfq=nfq, n_sig=n_sig_for(dim))


def curved_coords(dm: DiscreteMesh, mapping) -> np.ndarray:
    """Apply a smooth coordinate map to the mesh's node coordinates.

    ``mapping``: (N, dim) -> (N, dim).  Applying the SAME map to every
    element's nodes keeps conforming faces conforming (shared physical
    points stay shared), so the topological neighbour gather is
    untouched."""
    E, n_p, dim = dm.coords.shape
    return np.asarray(mapping(dm.coords.reshape(-1, dim))).reshape(
        E, n_p, dim)


def _face_quad(cp: CurviParams, p: ElasticParams, field):
    """Own and neighbour traces of a nodal field at the face quadrature
    points: each (E, n_faces, nfq, C)."""
    own, nbr = _traces(p, field)  # (E, nf, nfp, C)
    return (torch.einsum("fqk,efkc->efqc", cp.Ff, own),
            torch.einsum("fqk,efkc->efqc", cp.Ff, nbr))


# --- operators (the (p, field) hooks of timestep.make_step / run) --------
def curvi_vel_op(cp: CurviParams, p: ElasticParams, sigma):
    """(1/rho) div(sigma) on curved elements: batched per-element
    derivative products + curved-face central flux."""
    V = voigt_map(p.dim)
    dim = p.dim
    g = torch.einsum("edij,ejs->edis", cp.De, sigma)  # (E, dim, n_p, n_sig)
    div = torch.stack(
        [sum(g[:, d, :, V[c, d]] for d in range(dim)) for c in range(dim)],
        dim=-1)  # (E, n_p, dim)

    own_q, nbr_q = _face_quad(cp, p, sigma)
    nrm = cp.nrm_q  # (E, nf, nfq, dim)
    t_own = torch.stack(
        [sum(nrm[..., d] * own_q[..., V[c, d]] for d in range(dim))
         for c in range(dim)], dim=-1)
    t_nbr = torch.stack(
        [sum(nrm[..., d] * nbr_q[..., V[c, d]] for d in range(dim))
         for c in range(dim)], dim=-1)
    jump = 0.5 * t_nbr + p.beta_t[:, :, None, None] * t_own
    surf = torch.einsum("efiq,efqc->eic", cp.Lf, jump)
    return p.inv_rho[:, None, None] * (div + surf)


def curvi_stress_op(cp: CurviParams, p: ElasticParams, u):
    """Hooke(sym grad u) on curved elements (isotropic lam/mu)."""
    g = torch.einsum("edij,ejc->edic", cp.De, u)  # g[e,d,:,c] = du_c/dx_d
    vol = torch.stack(_hooke(p.dim, p.lam[:, None], p.mu[:, None],
                             lambda c, d: g[:, d, :, c]), dim=-1)

    own_q, nbr_q = _face_quad(cp, p, u)
    du = 0.5 * nbr_q + p.delta_u[:, :, None, None] * own_q
    nrm = cp.nrm_q
    face = torch.stack(
        _hooke(p.dim, p.lam[:, None, None], p.mu[:, None, None],
               lambda c, d: nrm[..., d] * du[..., c]), dim=-1)
    surf = torch.einsum("efiq,efqs->eis", cp.Lf, face)
    return vol + surf


def make_curvi_ops(cp: CurviParams):
    """(vel_op, stress_op) closures (p, field) -> rate, the operator hooks
    of timestep.make_step/run."""
    return (lambda p, s: curvi_vel_op(cp, p, s),
            lambda p, u: curvi_stress_op(cp, p, u))
