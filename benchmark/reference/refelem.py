"""Reference-element tables of nodal DG on simplices, P1-P4, in NumPy.

A frozen copy of the tables the program derives (equispaced nodes, a
monomial Vandermonde, collapsed Gauss-Jacobi quadrature): the strong
derivative matrices ``Dr``, ``LIFT = Minv E``, the face-node ids
``fnodes`` and their parameter coordinates, and the volume quadrature.
The benchmark's reference works them out again from nothing but the
dimension and the degree.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
from scipy.special import roots_jacobi


def _gauss_legendre01(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _gauss_jacobi01(n, alpha):
    x, w = roots_jacobi(n, alpha, 0.0)
    return 0.5 * (x + 1.0), w * (0.5 ** (1 + alpha))


def simplex_quadrature(dim: int, degree: int):
    """(points, weights) on the unit simplex of ``dim`` (1-3), exact to
    total degree ``degree`` (collapsed tensor rules)."""
    n = degree // 2 + 1
    a, wa = _gauss_legendre01(n)
    if dim == 1:
        return a.reshape(-1, 1), wa
    b, wb = _gauss_jacobi01(n, 1)
    if dim == 2:
        A, B = np.meshgrid(a, b, indexing="ij")
        WA, WB = np.meshgrid(wa, wb, indexing="ij")
        return (np.stack([(A * (1 - B)).ravel(), B.ravel()], axis=1),
                (WA * WB).ravel())
    c, wc = _gauss_jacobi01(n, 2)
    A, B, C = np.meshgrid(a, b, c, indexing="ij")
    WA, WB, WC = np.meshgrid(wa, wb, wc, indexing="ij")
    pts = np.stack([(A * (1 - B) * (1 - C)).ravel(), (B * (1 - C)).ravel(),
                    C.ravel()], axis=1)
    return pts, (WA * WB * WC).ravel()


def _exponents(dim, degree):
    e = [t for t in itertools.product(range(degree + 1), repeat=dim)
         if sum(t) <= degree]
    e.sort()
    return np.array(e, dtype=np.int64)


def _mono(exps, pts):
    out = np.ones((pts.shape[0], exps.shape[0]))
    for d in range(pts.shape[1]):
        out *= pts[:, d:d + 1] ** exps[None, :, d]
    return out


def _mono_grad(exps, pts):
    dim = pts.shape[1]
    out = np.zeros((dim, pts.shape[0], exps.shape[0]))
    for r in range(dim):
        v = np.ones((pts.shape[0], exps.shape[0]))
        for d in range(dim):
            if d == r:
                em1 = np.maximum(exps[:, d] - 1, 0)
                v *= exps[None, :, d] * pts[:, d:d + 1] ** em1[None, :]
            else:
                v *= pts[:, d:d + 1] ** exps[None, :, d]
        out[r] = v
    return out


@dataclass(frozen=True)
class Tables:
    dim: int
    degree: int
    n_p: int
    nf: int
    n_fp: int
    nodes: np.ndarray  # (n_p, dim)
    face_vertices: np.ndarray  # (nf, dim): face f is opposite vertex f
    Dr: np.ndarray  # (dim, n_p, n_p)
    LIFT: np.ndarray  # (n_p, nf * n_fp)
    Minv: np.ndarray  # (n_p, n_p)
    fnodes: np.ndarray  # (nf, n_fp)
    face_param: np.ndarray  # (nf, n_fp, dim - 1)
    qx: np.ndarray  # (nq, dim)
    qw: np.ndarray  # (nq,)
    Vq: np.ndarray  # (nq, n_p)
    Ainv: np.ndarray  # monomials -> nodal basis
    exps: np.ndarray

    def basis(self, xi: np.ndarray) -> np.ndarray:
        """(npts, n_p) nodal basis values at reference points."""
        return _mono(self.exps, np.atleast_2d(xi)) @ self.Ainv


def tables(dim: int, degree: int) -> Tables:
    if dim not in (2, 3) or not 1 <= degree <= 4:
        raise ValueError("the reference covers 2D/3D simplices, P1-P4")
    exps = _exponents(dim, degree)
    nodes = np.array(sorted(
        [e / degree for e in t] for t in itertools.product(
            range(degree + 1), repeat=dim) if sum(t) <= degree),
        dtype=np.float64)
    Ainv = np.linalg.inv(_mono(exps, nodes))
    qx, qw = simplex_quadrature(dim, 2 * degree + 2)
    Vq = _mono(exps, qx) @ Ainv
    M = Vq.T @ (qw[:, None] * Vq)
    Minv = np.linalg.inv(M)
    Dr = np.einsum("rpm,mn->rpn", _mono_grad(exps, nodes), Ainv)

    verts = np.zeros((dim + 1, dim))
    verts[1:] = np.eye(dim)
    fverts = np.array([[j for j in range(dim + 1) if j != i]
                       for i in range(dim + 1)], dtype=np.int64)
    fdim = dim - 1
    fq_x, fq_w = simplex_quadrature(fdim, 2 * degree + 2)
    fn, fp = [], []
    for f in range(dim + 1):
        V = verts[fverts[f]]
        T = (V[1:] - V[0]).T
        c = np.linalg.lstsq(T, (nodes - V[0]).T, rcond=None)[0].T
        on = (np.linalg.norm(V[0] + c @ T.T - nodes, axis=1) < 1e-12) & (
            c.min(axis=1) > -1e-12) & (c.sum(axis=1) < 1 + 1e-12)
        ids = np.where(on)[0]
        order = np.lexsort(c[ids].T[::-1])
        fn.append(ids[order])
        fp.append(c[ids][order])
    fnodes = np.array(fn, dtype=np.int64)
    face_param = np.array(fp)
    n_fp = fnodes.shape[1]
    fexps = _exponents(fdim, degree)
    E = np.zeros((nodes.shape[0], (dim + 1) * n_fp))
    for f in range(dim + 1):
        Vf = _mono(fexps, fq_x) @ np.linalg.inv(_mono(fexps, face_param[f]))
        Mf = Vf.T @ (fq_w[:, None] * Vf)
        for k in range(n_fp):
            E[fnodes[f, k], f * n_fp:(f + 1) * n_fp] = Mf[k]
    return Tables(dim=dim, degree=degree, n_p=nodes.shape[0], nf=dim + 1,
                  n_fp=n_fp, nodes=nodes, face_vertices=fverts, Dr=Dr,
                  LIFT=Minv @ E, Minv=Minv, fnodes=fnodes,
                  face_param=face_param, qx=qx, qw=qw, Vq=Vq, Ainv=Ainv,
                  exps=exps)
