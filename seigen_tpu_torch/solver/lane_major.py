"""Class-major lane order for the structured lane-major runners.

Port of ``seigen_tpu/solver/lane_major.py:class_major_perm`` (NumPy, copied).
The lane-major state is (C*npp, E): rows are (component, node), lanes are
elements in class-major order, so every element class is a contiguous lane
slice and a face's neighbour lies at a fixed lane shift within its
neighbour class (ops/merged_kernels.py).
"""

from __future__ import annotations

import numpy as np

from ..ops.structured_exchange import StructuredExchange


def class_major_perm(ex: StructuredExchange, E: int):
    """Element permutation to class-major lane order.

    Returns (old_of_new, new_of_old): new id = class * n_cells + supercell
    lex index — every class becomes a CONTIGUOUS lane slice.
    """
    base_grid = ex.base_grid
    scale, m0 = ex.scale, ex.m0
    idx = np.arange(E)
    t = idx % m0
    c = idx // m0
    cs = []
    for g in reversed(base_grid):
        cs.append(c % g)
        c = c // g
    cs = cs[::-1]
    sup = [ci // scale for ci in cs]
    sub = [ci % scale for ci in cs]
    k = np.zeros_like(t)
    for s in sub:
        k = k * scale + s
    cls = k * m0 + t
    supflat = sup[0]
    for g, ci in zip(ex.grid[1:], sup[1:]):
        supflat = supflat * g + ci
    NC = int(np.prod(ex.grid))
    new_of_old = cls * NC + supflat
    old_of_new = np.empty(E, dtype=np.int64)
    old_of_new[new_of_old] = np.arange(E)
    return old_of_new, new_of_old
