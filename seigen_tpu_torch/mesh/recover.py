"""Structure recovery: recognize structured meshes in disguise.

Port of ``seigen_tpu/mesh/recover.py`` (NumPy, copied).

Meshes produced by structured generators frequently reach the solver with
scrambled element order and no structure metadata — Gmsh transfinite grids,
partitioner-renumbered meshes, meshes round-tripped through files.  Without
this pass they would run on the (slower) unstructured path although they
are exactly the lattice meshes of ``mesh/structured.py``.  It re-derives
the (grid, m) lattice layout geometrically and reorders cells to the
canonical ``MeshTopology.structure`` contract (lex supercells, m simplices
per cell, class-consistent order) so ``detect_structured`` and the
structured lane runners engage.

Recovery is exact-or-nothing: every check (uniform vertex planes, integer
cell count, one cell per (supercell, class), identical per-class vertex
offsets) must pass, otherwise the ORIGINAL topology is returned unchanged
and the general unstructured path handles it.  Downstream
``detect_structured`` re-validates independently, so a false positive here
cannot corrupt results.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .structured import MeshTopology


def recover_structure(topo: MeshTopology, tol: float = 1e-8
                      ) -> MeshTopology:
    """Return a re-ordered topology with ``structure`` set, or ``topo``."""
    if topo.structure is not None or topo.periodic:
        return topo
    dim = topo.dim
    verts, cells = topo.vertices, topo.cells
    E = cells.shape[0]

    # 1. uniform vertex planes along every axis -> grid dims + spacing
    grid, lo, h = [], [], []
    for d in range(dim):
        span = topo.extents[d][1] - topo.extents[d][0]
        if span <= 0:
            return topo
        u = np.unique(verts[:, d])
        # cluster within tolerance
        planes = [u[0]]
        for x in u[1:]:
            if x - planes[-1] > tol * span:
                planes.append(x)
        planes = np.asarray(planes)
        if len(planes) < 2:
            return topo
        hd = np.diff(planes)
        if not np.allclose(hd, hd[0], rtol=1e-6, atol=tol * span):
            return topo
        grid.append(len(planes) - 1)
        lo.append(planes[0])
        h.append(float(hd.mean()))
    grid0 = tuple(grid)
    lo = np.asarray(lo)
    h0 = np.asarray(h)
    cent = verts[cells].mean(axis=1)

    # 2. classify at supercell scale 1, then 2 (patterns like the 2D
    # criss-cross mesh alternate per checkerboard and are only
    # translation-invariant over 2^dim blocks)
    for scale in (1, 2):
        if any(g % scale for g in grid0):
            continue
        grid = tuple(g // scale for g in grid0)
        NC = int(np.prod(grid))
        if E % NC:
            continue
        m = E // NC
        h = h0 * scale
        rel = (cent - lo) / h
        sup = np.clip(np.floor(rel).astype(np.int64), 0,
                      np.asarray(grid) - 1)
        off = rel - sup  # in (0, 1)^dim
        qoff = np.round(off * (4 * m * (dim + 1))).astype(np.int64)
        keys, t = np.unique(
            qoff.view([("", qoff.dtype)] * dim).reshape(-1),
            return_inverse=True)
        if len(keys) != m:
            continue

        supflat = sup[:, 0]
        for g, s in zip(grid[1:], sup[:, 1:].T):
            supflat = supflat * g + s
        new_id = supflat * m + t
        if len(np.unique(new_id)) != E:
            continue  # not one cell per (supercell, class)
        old_of_new = np.empty(E, dtype=np.int64)
        old_of_new[new_id] = np.arange(E)
        cells2 = cells[old_of_new]

        # 3. per-class translation invariance: all cells of a class have
        # identical vertex offsets from their supercell origin
        origin = (lo + sup[old_of_new] * h)[:, None, :]
        offs = verts[cells2] - origin
        t2 = t[old_of_new]
        ok = all(
            np.allclose(oc, oc[:1], rtol=0, atol=10 * tol * h.max())
            for c in range(m)
            for oc in [offs[t2 == c]]
        )
        if not ok:
            continue
        return dataclasses.replace(topo, cells=cells2,
                                   structure=(grid, m))
    return topo
