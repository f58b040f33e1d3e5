"""Structured-mesh exchange plan: translation-invariant face adjacency.

Port of the host-side planning half of ``seigen_tpu/ops/structured_exchange.py``
(NumPy, copied).  For structured box/rect meshes mesh adjacency is
translation-invariant: for each (element-class, face) the neighbour is a
fixed class in the cell shifted by one along one axis, with a fixed node
permutation.  The lane-major operators (ops/merged_kernels.py) read the
neighbour trace at a fixed flat lane shift instead of gathering through a
per-node index array; non-periodic boundary faces are masked to the
own-side trace (the ghost convention in the flux coefficients handles the
BC, ops/elastic.py).

``detect_structured`` verifies translation invariance exactly against the
general connectivity (dm.nbr), trying supercell coarsenings for meshes whose
pattern has period > 1 (the criss-cross rect mesh); it returns None for
genuinely unstructured meshes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.discrete import DiscreteMesh


@dataclass(frozen=True)
class StructuredExchange:
    """Host-side exchange plan: all-static class tables + boundary masks.

    Supercells of ``scale^dim`` base cells; a class is the static
    multi-index (sub..., t) within a supercell.
    """

    grid: tuple  # SUPERcell grid dims (G0, G1[, G2])
    base_grid: tuple  # original cell grid
    scale: int
    m0: int  # simplices per base cell
    m: int  # elements per supercell = m0 * scale^dim
    n_p: int
    n_faces: int
    n_fp: int
    nbr_class: np.ndarray  # (m, nf) neighbour element class t2
    shift: np.ndarray  # (m, nf, dim) in {-1, 0, 1}: cell shift per axis
    nodes: np.ndarray  # (m, nf, n_fp) neighbour local node ids
    own_nodes: np.ndarray  # (nf, n_fp) = fnodes
    self_mask: np.ndarray  # (m, nf, *grid) bool: face uses own trace


def detect_structured(dm: DiscreteMesh) -> StructuredExchange | None:
    topo = dm.topology
    if topo.structure is None:
        return None
    base_grid, base_m = topo.structure
    dim = dm.dim
    re = dm.re
    n_p, nf, nfp = re.n_p, re.n_faces, re.n_fp
    E = dm.num_elements

    nbr_e = dm.nbr // n_p  # (E, nf, nfp)
    nbr_i = dm.nbr % n_p

    own = (
        np.arange(E)[:, None, None] * n_p + re.fnodes[None, :, :]
    ).astype(dm.nbr.dtype)
    is_self = np.all(dm.nbr == own, axis=2)  # (E, nf)

    for scale in (1, 2, 4):
        if any(g % scale for g in base_grid):
            continue
        grid = tuple(g // scale for g in base_grid)
        m = base_m * scale**dim
        plan = _try_plan(dm, grid, scale, m, nbr_e, nbr_i, is_self)
        if plan is not None:
            return plan
    return None


def _try_plan(dm, grid, scale, m, nbr_e, nbr_i, is_self):
    re = dm.re
    dim = dm.dim
    n_p, nf, nfp = re.n_p, re.n_faces, re.n_fp
    E = dm.num_elements
    if E != int(np.prod(grid)) * m:
        return None
    base_grid, base_m = dm.topology.structure

    # element id -> (supercell multi-index, class): class is the static
    # multi-index (sub0, sub1[, sub2], t) flattened (the JAX package's
    # factored device reshape; the lane layout reuses it via
    # solver/lane_major.py:class_major_perm).
    def decode(e):
        t = e % base_m
        c = e // base_m
        cs = []
        for g in reversed(base_grid):
            cs.append(c % g)
            c = c // g
        cs = cs[::-1]
        sup_ = [ci // scale for ci in cs]
        sub_ = [ci % scale for ci in cs]
        k = np.zeros_like(t)
        for s in sub_:
            k = k * scale + s
        k = k * base_m + t
        return np.stack(sup_, axis=-1), k

    my_sup, my_cls = decode(np.arange(E))

    nbr_class = np.zeros((m, nf), dtype=np.int64)
    shift = np.zeros((m, nf, dim), dtype=np.int64)
    nodes = np.zeros((m, nf, nfp), dtype=np.int64)
    self_mask = np.zeros((m, nf) + grid, dtype=bool)

    for t in range(m):
        sel = my_cls == t  # (E,)
        e_ids = np.nonzero(sel)[0]
        sups = my_sup[sel]  # (n_cells, dim)
        for f in range(nf):
            selfs = is_self[e_ids, f]
            self_grid = np.zeros(grid, dtype=bool)
            self_grid[tuple(sups[selfs].T)] = True
            self_mask[t, f] = self_grid
            interior = ~selfs
            if not interior.any():
                # every face of this class is boundary (tiny meshes)
                nbr_class[t, f] = t
                nodes[t, f] = re.fnodes[f]
                continue
            ne = nbr_e[e_ids[interior], f]  # (k, nfp)
            ni = nbr_i[e_ids[interior], f]
            nsup, ncls = decode(ne[:, 0])
            # same class for all interior faces?
            if not (ncls == ncls[0]).all():
                return None
            # node ids constant?
            if not np.all(ni == ni[0:1], axis=0).all():
                return None
            # all nodes of the face from the same neighbour element?
            if not np.all(ne == ne[:, 0:1]):
                return None
            # per-axis shift, wrapped to {-1, 0, 1}
            d = nsup - sups[interior]
            for ax, g in enumerate(grid):
                d[:, ax] = ((d[:, ax] + g // 2 + g) % g) - g // 2
            if not (d == d[0:1]).all():
                return None
            if np.abs(d[0]).max() > 1:
                return None
            nbr_class[t, f] = ncls[0]
            shift[t, f] = d[0]
            nodes[t, f] = ni[0]

    return StructuredExchange(
        grid=tuple(int(g) for g in grid),
        base_grid=tuple(int(g) for g in base_grid),
        scale=int(scale),
        m0=int(base_m),
        m=m,
        n_p=n_p,
        n_faces=nf,
        n_fp=nfp,
        nbr_class=nbr_class,
        shift=shift,
        nodes=nodes,
        own_nodes=np.array(re.fnodes),
        self_mask=self_mask,
    )


def _class_index(ex: StructuredExchange, k: int):
    """class id -> (sub multi-index tuple, t)."""
    t = k % ex.m0
    k = k // ex.m0
    subs = []
    for _ in range(len(ex.grid)):
        subs.append(k % ex.scale)
        k = k // ex.scale
    return tuple(reversed(subs)), t
