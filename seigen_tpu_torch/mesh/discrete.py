"""Discrete mesh: DG connectivity + geometric factors (host-side, NumPy f64).

Rebuild equivalent of the reference's mesh layer (SURVEY.md §5.5): what PETSc
DMPlex + PyOP2 Sets/Maps/Halos provide there — global DG dof numbering, face
pairing, orientation permutations — is computed here once at setup into dense
index arrays, after which everything is device-resident.

The face-neighbour connectivity uses the "face-owner gather" formulation
(SURVEY.md §9.3): each element gathers its neighbours' face-node traces via a
precomputed flat index array ``nbr`` of shape (E, n_faces, n_fp) into the
flattened (E * n_p) node space — no scatter anywhere on the device hot path.
Node matching is geometric and orientation-agnostic: every face node is keyed
by (sorted canonical face-vertex ids, barycentric coordinates in that sorted
order), and identical keys are paired.  Periodic boundaries fall out of the
same mechanism via canonical vertex identification.

A C++ twin of the pairing and the geometric factors lives in
``mesh/native`` (the JAX package's source, built at first use) for
large-mesh setup speed; ``build_discrete`` takes it whenever
``native.available()``, as ``seigen_tpu/mesh/discrete.py`` does.  The NumPy
versions below (``pair_rows_numpy``, ``geometric_factors_numpy``) are its
oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..refelem import RefElem, ref_elem
from .structured import MeshTopology

# Boundary-condition codes carried per (element, face).
BC_INTERIOR = 0
BC_FREE = 1  # traction-free (free surface), imposed weakly via mirror flux
BC_ABSORB = 2  # characteristic absorbing face (pairs with sponge damping)
BC_RIGID = 3  # rigid wall: zero velocity, unconstrained traction


@dataclass(frozen=True)
class DiscreteMesh:
    """Everything the device operators need, as dense host arrays."""

    re: RefElem
    topology: MeshTopology
    num_elements: int
    coords: np.ndarray  # (E, n_p, dim) physical node coordinates
    Ginv: np.ndarray  # (E, dim, dim): d xi_r / d x_d
    detJ: np.ndarray  # (E,) |det J| > 0
    Fscale: np.ndarray  # (E, n_faces) = sJ / detJ
    normals: np.ndarray  # (E, n_faces, dim) outward unit normals
    nbr: np.ndarray  # (E, n_faces, n_fp) int32 flat neighbour node ids
    bc: np.ndarray  # (E, n_faces) int8 BC codes
    h: np.ndarray  # (E,) characteristic element size (min altitude)

    @property
    def dim(self) -> int:
        return self.re.dim

    def locate_points(self, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Find the element containing each point; return (elem_ids, ref_coords).

        Host-side setup utility (sources/receivers).  Brute-force over
        elements with a vectorized barycentric test; picks the element with
        the least constraint violation so points on element boundaries are
        assigned deterministically.
        """
        pts = np.atleast_2d(pts)
        v0 = self.topology.vertices[self.topology.cells[:, 0]]  # (E, dim)
        # xi = Jinv @ (p - v0); Ginv[e] rows are d xi_r / d x
        xi = np.einsum("erd,ped->per", self.Ginv, pts[:, None, :] - v0[None])
        # violation: how far outside the unit simplex
        viol = np.maximum(np.max(-xi, axis=2), np.sum(xi, axis=2) - 1.0)
        elem_ids = np.argmin(viol, axis=1)
        if np.any(viol[np.arange(len(pts)), elem_ids] > 1e-8):
            bad = pts[viol[np.arange(len(pts)), elem_ids] > 1e-8]
            raise ValueError(f"points outside mesh: {bad}")
        return elem_ids.astype(np.int64), xi[np.arange(len(pts)), elem_ids]


def _pair_rows(flat_keys: np.ndarray) -> np.ndarray:
    """partner[i] = j with identical key row (self if unmatched).

    Uses the native C++ sort-and-match when available (large meshes);
    ``pair_rows_numpy`` is the oracle.
    """
    from . import native

    if native.available():
        partner, mult = native.pair_face_nodes(flat_keys)
        if mult > 2:
            raise ValueError("non-manifold mesh: a face node matched >2 sides")
        return partner
    return pair_rows_numpy(flat_keys)


def pair_rows_numpy(flat_keys: np.ndarray) -> np.ndarray:
    """The NumPy pairing: np.unique over the key rows."""
    _, inv, counts = np.unique(
        flat_keys, axis=0, return_inverse=True, return_counts=True
    )
    if counts.max() > 2:
        raise ValueError("non-manifold mesh: a face node matched >2 sides")
    N = flat_keys.shape[0]
    partner = np.arange(N)
    order = np.argsort(inv, kind="stable")
    csort = counts[inv[order]]
    starts = np.flatnonzero(
        (csort == 2) & (np.r_[True, inv[order][1:] != inv[order][:-1]])
    )
    a, b = order[starts], order[starts + 1]
    partner[a], partner[b] = b, a
    return partner


def geometric_factors_numpy(verts: np.ndarray, cells: np.ndarray,
                            face_vertices: np.ndarray):
    """Affine-simplex geometry in NumPy (LAPACK det and inverse).

    Returns (Ginv (E, dim, dim), detJ (E,), normals (E, nf, dim),
    Fscale (E, nf), h (E,)), as ``native.geometric_factors`` does.
    """
    from math import factorial

    E, dim = cells.shape[0], verts.shape[1]
    n_faces = dim + 1
    J = np.transpose(verts[cells[:, 1:]] - verts[cells[:, :1]],
                     (0, 2, 1))
    detJ = np.linalg.det(J)
    assert np.all(detJ > 0), "cells must be positively oriented"
    Ginv = np.linalg.inv(J)  # (E, dim, dim): rows are d xi_r / d x

    # --- face normals, surface Jacobians ---
    normals = np.zeros((E, n_faces, dim))
    sJ = np.zeros((E, n_faces))
    for f in range(n_faces):
        pv = verts[cells[:, face_vertices[f]]]  # (E, dim, dim)
        opp = verts[cells[:, f]]  # opposite vertex
        if dim == 2:
            t = pv[:, 1] - pv[:, 0]
            sJ[:, f] = np.linalg.norm(t, axis=1)
            n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        else:
            c = np.cross(pv[:, 1] - pv[:, 0], pv[:, 2] - pv[:, 0])
            sJ[:, f] = np.linalg.norm(c, axis=1)
            n = c
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        flip = np.einsum("ed,ed->e", n, pv[:, 0] - opp) < 0
        n[flip] *= -1.0
        normals[:, f] = n
    Fscale = sJ / detJ[:, None]

    # characteristic size: min altitude = dim * vol / max face area
    vol = detJ / factorial(dim)
    farea = sJ / factorial(dim - 1)
    h = dim * vol / farea.max(axis=1)
    return Ginv, detJ, normals, Fscale, h


def _canonical_vertex_ids(topo: MeshTopology) -> np.ndarray:
    """Map vertex ids to canonical ids, identifying periodic boundary pairs."""
    coords = topo.vertices.copy()
    for ax in topo.periodic:
        lo, hi = topo.extents[ax]
        span = hi - lo
        tol = 1e-9 * max(span, 1.0)
        wrap = np.abs(coords[:, ax] - hi) < tol
        coords[wrap, ax] = lo
    # quantize and hash
    scale = np.array([max(abs(lo), abs(hi), 1.0) for lo, hi in topo.extents])
    q = np.round(coords / (1e-10 * scale)).astype(np.int64)
    _, canon = np.unique(q, axis=0, return_inverse=True)
    return canon


def build_discrete(
    topo: MeshTopology,
    degree: int,
    bc_fn=None,
    bc_groups: dict | None = None,
) -> DiscreteMesh:
    """Build the device-ready discrete mesh for DG degree `degree`.

    ``bc_fn(centroids (F, dim), normals (F, dim)) -> int array`` assigns BC
    codes to non-periodic boundary faces; default is all-free-surface
    (reference parity: Seigen's eigenmode/explosive tests use free surfaces,
    SURVEY.md §4.4).

    ``bc_groups`` maps named boundary facet groups (Gmsh physical groups,
    ``topo.facet_groups`` from ``read_msh``) to BC codes, e.g.
    ``{"surface": BC_FREE, "sides": BC_ABSORB}`` — the rebuild equivalent of
    the reference attaching DirichletBC/weak BCs to Gmsh physical surface
    ids (SURVEY.md §4.4).  Boundary faces in no listed group keep the
    ``bc_fn`` / free-surface default; listed groups take precedence.
    """
    dim = topo.dim
    re = ref_elem(dim, degree)
    cells = topo.cells
    verts = topo.vertices
    E = cells.shape[0]
    n_p, n_faces, n_fp = re.n_p, re.n_faces, re.n_fp

    # --- physical node coordinates via barycentric interpolation ---
    # ref node = bary @ ref_vertices with bary = [1 - sum(xi), xi...]
    bary_nodes = np.concatenate(
        [1.0 - re.nodes.sum(axis=1, keepdims=True), re.nodes], axis=1
    )  # (n_p, dim+1)
    coords = np.einsum("pk,ekd->epd", bary_nodes, verts[cells])

    # --- geometric factors (affine simplices) ---
    # native C++ single-pass twin when available (closed-form adjugate
    # inverse; it differs from LAPACK's only in rounding)
    from . import native

    if native.available():
        Ginv, detJ, normals, Fscale, h = native.geometric_factors(
            verts, cells, np.asarray(re.face_vertices))
        assert np.all(detJ > 0), "cells must be positively oriented"
    else:
        Ginv, detJ, normals, Fscale, h = geometric_factors_numpy(
            verts, cells, np.asarray(re.face_vertices))

    # --- face-node pairing via geometric keys ---
    canon = _canonical_vertex_ids(topo)
    fdim = dim - 1
    # barycentric coords of face nodes wrt the face's own vertex order
    fp_param = re.face_param_nodes  # (n_faces, n_fp, fdim)
    bary_face = np.concatenate(
        [1.0 - fp_param.sum(axis=2, keepdims=True), fp_param], axis=2
    )  # (n_faces, n_fp, dim)
    qbary = np.round(bary_face * degree).astype(np.int64)  # exact multiples

    # Canonicalized quantized face centroids disambiguate coarse periodic
    # meshes (2 cells/axis), where distinct faces can share a canonical
    # vertex-id set.  Centroids of faces lying exactly on a periodic max
    # plane wrap to the min plane, so wrapped partners still key together.
    scale = np.array([max(abs(lo), abs(hi), 1.0) for lo, hi in topo.extents])

    def _canon_quant(pts: np.ndarray) -> np.ndarray:
        p = pts.copy()
        for ax in topo.periodic:
            lo, hi = topo.extents[ax]
            tol = 1e-9 * max(hi - lo, 1.0)
            p[np.abs(p[:, ax] - hi) < tol, ax] = lo
        return np.round(p / (1e-10 * scale)).astype(np.int64)

    # Pairing runs at FACE granularity (E*nf keyed rows), with the node
    # permutation recovered from static tables — equivalent to keying
    # every face NODE by (sorted ids, centroid, bary-in-sorted-frame) as
    # the direct formulation does, but ~n_fp x cheaper at setup (the
    # per-node formulation materialized an (E, nf, nfp, 3 dim) int64 key
    # tensor and paired 3.3M rows at E=83k P3 — measured 8 s of the 11 s
    # host setup on this throttled vCPU).  Equivalence: two face nodes
    # pair iff their faces' (sorted canonical ids, centroid) agree AND
    # their barycentric coords agree in the sorted-vertex frame; the
    # latter depends only on (face id, argsort permutation) of each side,
    # so it is a lookup in a (nf, dim!, nf, dim!, n_fp) table.
    from itertools import permutations as _perms

    perms_list = list(_perms(range(dim)))
    nperm = len(perms_list)
    radix2code = np.full(dim**dim, -1, dtype=np.int64)
    for o, pm in enumerate(perms_list):
        c = 0
        for i in range(dim):
            c = c * dim + pm[i]
        radix2code[c] = o

    keys_f = np.empty((E, n_faces, 2 * dim), dtype=np.int64)
    ordcode = np.empty((E, n_faces), dtype=np.int64)
    for f in range(n_faces):
        fverts = cells[:, re.face_vertices[f]]
        cids = canon[fverts]  # (E, dim)
        order = np.argsort(cids, axis=1)
        keys_f[:, f, :dim] = np.take_along_axis(cids, order, axis=1)
        keys_f[:, f, dim:] = _canon_quant(verts[fverts].mean(axis=1))
        oc = np.zeros(E, dtype=np.int64)
        for i in range(dim):
            oc = oc * dim + order[:, i]
        ordcode[:, f] = radix2code[oc]
    assert (ordcode >= 0).all()

    partner_f = _pair_rows(keys_f.reshape(-1, 2 * dim))
    NF = E * n_faces
    pe2 = partner_f // n_faces
    pf2 = partner_f % n_faces

    # node permutation tables: bary rows in each sorted-vertex frame
    sb_tab = np.empty((n_faces, nperm, n_fp, dim), dtype=np.int64)
    for f in range(n_faces):
        for o, pm in enumerate(perms_list):
            sb_tab[f, o] = qbary[f][:, list(pm)]
    k2_tab = np.full((n_faces, nperm, n_faces, nperm, n_fp), -1,
                     dtype=np.int64)
    for f2 in range(n_faces):
        for o2 in range(nperm):
            lookup = {tuple(row): k2
                      for k2, row in enumerate(sb_tab[f2, o2])}
            for f1 in range(n_faces):
                for o1 in range(nperm):
                    row = [lookup.get(tuple(r), -1) for r in sb_tab[f1, o1]]
                    if all(r >= 0 for r in row):
                        k2_tab[f1, o1, f2, o2] = row

    f1_idx = np.tile(np.arange(n_faces), E)
    o1 = ordcode.reshape(-1)
    o2 = ordcode[pe2, pf2]
    k2 = k2_tab[f1_idx, o1, pf2, o2]  # (NF, n_fp)
    assert (k2 >= 0).all(), "paired faces with incompatible node layouts"
    nbr = (pe2[:, None] * n_p + re.fnodes[pf2[:, None], k2]).astype(np.int32)
    nbr = nbr.reshape(E, n_faces, n_fp)

    is_boundary = (partner_f == np.arange(NF)).reshape(E, n_faces)

    # boundary: gather own trace (ghost states handled by bc masks in ops)
    own = (
        np.arange(E)[:, None, None] * n_p + re.fnodes[None, :, :]
    ).astype(np.int32)
    nbr = np.where(is_boundary[:, :, None], own, nbr)

    # BC codes
    bc = np.zeros((E, n_faces), dtype=np.int8)
    if np.any(is_boundary):
        be, bf = np.nonzero(is_boundary)
        fv = np.asarray(re.face_vertices)  # (nf, dim)
        centroids = verts[cells[be[:, None], fv[bf]]].mean(axis=1)
        if bc_fn is None:
            codes = np.full(len(be), BC_FREE, dtype=np.int8)
        else:
            codes = np.asarray(
                bc_fn(centroids, normals[be, bf]), dtype=np.int8
            )
        if bc_groups:
            fg = topo.facet_groups or {}
            unknown = set(bc_groups) - set(fg)
            if unknown:
                raise ValueError(
                    f"bc_groups names not in mesh facet_groups: "
                    f"{sorted(unknown)} (available: {sorted(fg)})")
            facet_code: dict[tuple, int] = {}
            for name, code in bc_groups.items():
                for fac in fg[name]:
                    facet_code[tuple(sorted(canon[fac].tolist()))] = code
            for j, (e, f) in enumerate(zip(be, bf)):
                key = tuple(sorted(
                    canon[cells[e, re.face_vertices[f]]].tolist()))
                if key in facet_code:
                    codes[j] = facet_code[key]
        bc[be, bf] = codes

    # sanity: verify paired nodes coincide geometrically (periodic-shifted).
    # Sampled on large meshes — the full check is O(100 s) at E~100k from
    # giant fancy-index gathers, and the pairing logic is test-covered.
    flat_coords = coords.reshape(E * n_p, dim)
    own_flat = own.reshape(-1)
    nbr_flat = nbr.reshape(-1)
    if own_flat.size > 1_000_000:
        rng = np.random.default_rng(0)
        sel = rng.choice(own_flat.size, size=200_000, replace=False)
        own_flat = own_flat[sel]
        nbr_flat = nbr_flat[sel]
    own_pts = flat_coords[own_flat]
    nbr_pts = flat_coords[nbr_flat]
    diff = own_pts - nbr_pts
    for ax in range(dim):
        if ax in topo.periodic:
            lo, hi = topo.extents[ax]
            span = hi - lo
            diff[:, ax] = np.minimum(
                np.abs(diff[:, ax]), np.abs(np.abs(diff[:, ax]) - span)
            )
    max_mismatch = np.abs(diff).max() if diff.size else 0.0
    assert max_mismatch < 1e-8 * max(
        1.0, np.abs(verts).max()
    ), f"face-node pairing mismatch: {max_mismatch}"

    return DiscreteMesh(
        re=re,
        topology=topo,
        num_elements=E,
        coords=coords,
        Ginv=Ginv,
        detJ=detJ,
        Fscale=Fscale,
        normals=normals,
        nbr=nbr,
        bc=bc,
        h=h,
    )
