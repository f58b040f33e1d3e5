"""The discrete mesh of the reference, worked out again from the topology.

Node coordinates, affine geometry (LAPACK inverse and determinant), outward
normals, surface scales, face pairing and the node permutation across a
face, and the boundary codes of the explosive-source runs (a free top,
absorbing elsewhere).  A frozen, simplified copy of the program's NumPy
path: no periodic axes, no named boundary groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import permutations
from math import factorial

import numpy as np

from .refelem import Tables, tables

BC_INTERIOR, BC_FREE, BC_ABSORB = 0, 1, 2


@dataclass(frozen=True)
class Mesh:
    tab: Tables
    vertices: np.ndarray  # (Nv, dim)
    cells: np.ndarray  # (E, dim + 1)
    coords: np.ndarray  # (E, n_p, dim)
    Ginv: np.ndarray  # (E, dim, dim): d xi_r / d x_d
    detJ: np.ndarray  # (E,)
    normals: np.ndarray  # (E, nf, dim)
    Fscale: np.ndarray  # (E, nf)
    h: np.ndarray  # (E,) least altitude
    nbr: np.ndarray  # (E, nf, n_fp) flat neighbour node ids (own on bnd)
    bc: np.ndarray  # (E, nf)

    @property
    def E(self) -> int:
        return self.cells.shape[0]

    def locate(self, pts: np.ndarray, tol: float = 1e-9):
        """For each point, every element that holds it (a point on a face
        lies in several): a list of (elems, reference coords) pairs."""
        v0 = self.vertices[self.cells[:, 0]]
        out = []
        for p in np.atleast_2d(pts):
            xi = np.einsum("erd,ed->er", self.Ginv, p[None] - v0)
            viol = np.maximum(np.max(-xi, axis=1), xi.sum(axis=1) - 1.0)
            hit = np.flatnonzero(viol < tol)
            if not len(hit):
                raise ValueError(f"point outside the mesh: {p}")
            out.append((hit, xi[hit]))
        return out


def geometry(verts, cells, face_vertices):
    """(Ginv, detJ, normals, Fscale, h) of affine simplices."""
    E, dim = cells.shape[0], verts.shape[1]
    J = np.transpose(verts[cells[:, 1:]] - verts[cells[:, :1]], (0, 2, 1))
    detJ = np.linalg.det(J)
    if not (detJ > 0).all():
        raise ValueError("cells must be positively oriented")
    Ginv = np.linalg.inv(J)
    normals = np.zeros((E, dim + 1, dim))
    sJ = np.zeros((E, dim + 1))
    for f in range(dim + 1):
        pv = verts[cells[:, face_vertices[f]]]
        opp = verts[cells[:, f]]
        if dim == 2:
            t = pv[:, 1] - pv[:, 0]
            n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        else:
            n = np.cross(pv[:, 1] - pv[:, 0], pv[:, 2] - pv[:, 0])
        sJ[:, f] = np.linalg.norm(n, axis=1)
        n = n / sJ[:, f:f + 1]
        n[np.einsum("ed,ed->e", n, pv[:, 0] - opp) < 0] *= -1.0
        normals[:, f] = n
    vol = detJ / factorial(dim)
    h = dim * vol / (sJ / factorial(dim - 1)).max(axis=1)
    return Ginv, detJ, normals, sJ / detJ[:, None], h


def build_mesh(vertices: np.ndarray, cells: np.ndarray, degree: int,
               top: float) -> Mesh:
    """The reference's discrete mesh; boundary faces whose centroid lies
    on the plane ``x_last = top`` are free, every other one absorbs."""
    dim = vertices.shape[1]
    tab = tables(dim, degree)
    E, nf, n_fp, n_p = cells.shape[0], tab.nf, tab.n_fp, tab.n_p
    bary = np.concatenate([1.0 - tab.nodes.sum(1, keepdims=True),
                           tab.nodes], axis=1)
    coords = np.einsum("pk,ekd->epd", bary, vertices[cells])
    Ginv, detJ, normals, Fscale, h = geometry(vertices, cells,
                                              tab.face_vertices)

    # faces pair by their sorted vertex ids
    fv = cells[:, tab.face_vertices]  # (E, nf, dim)
    order = np.argsort(fv, axis=2)
    keys = np.take_along_axis(fv, order, axis=2).reshape(E * nf, dim)
    srt = np.lexsort(keys.T[::-1])
    same = (keys[srt[1:]] == keys[srt[:-1]]).all(axis=1)
    partner = np.arange(E * nf)
    a, b = srt[:-1][same], srt[1:][same]
    partner[a], partner[b] = b, a

    # node k of face f, seen in the frame of the face's sorted vertices,
    # is the node of the partner face with the same barycentric row
    perms = list(permutations(range(dim)))
    radix = np.full(dim ** dim, -1, np.int64)
    for i, p in enumerate(perms):
        radix[sum(v * dim ** (dim - 1 - j) for j, v in enumerate(p))] = i
    ocode = radix[(order.reshape(-1, dim)
                   * dim ** np.arange(dim - 1, -1, -1)).sum(axis=1)]
    fb = np.concatenate([1.0 - tab.face_param.sum(2, keepdims=True),
                         tab.face_param], axis=2)
    qb = np.round(fb * degree).astype(np.int64)  # (nf, n_fp, dim)
    k2 = np.full((nf, len(perms), nf, len(perms), n_fp), -1, np.int64)
    for f2 in range(nf):
        for o2, p2 in enumerate(perms):
            look = {tuple(r): k for k, r in enumerate(qb[f2][:, list(p2)])}
            for f1 in range(nf):
                for o1, p1 in enumerate(perms):
                    row = [look.get(tuple(r), -1)
                           for r in qb[f1][:, list(p1)]]
                    k2[f1, o1, f2, o2] = row
    f1 = np.tile(np.arange(nf), E)
    pe, pf = partner // nf, partner % nf
    kk = k2[f1, ocode, pf, ocode[partner]]
    if (kk < 0).any():
        raise ValueError("paired faces with incompatible node layouts")
    nbr = (pe[:, None] * n_p + tab.fnodes[pf[:, None], kk]).reshape(
        E, nf, n_fp)
    own = np.arange(E)[:, None, None] * n_p + tab.fnodes[None]
    bnd = (partner == np.arange(E * nf)).reshape(E, nf)
    nbr = np.where(bnd[:, :, None], own, nbr)

    bc = np.zeros((E, nf), np.int8)
    be, bf = np.nonzero(bnd)
    cz = vertices[fv[be, bf]].mean(axis=1)[:, -1]
    span = vertices[:, -1].max() - vertices[:, -1].min()
    bc[be, bf] = np.where(np.abs(cz - top) < 1e-9 * max(span, 1.0),
                          BC_FREE, BC_ABSORB)
    return Mesh(tab=tab, vertices=vertices, cells=cells, coords=coords,
                Ginv=Ginv, detJ=detJ, normals=normals, Fscale=Fscale, h=h,
                nbr=nbr, bc=bc)
