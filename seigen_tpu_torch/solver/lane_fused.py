"""Producer/consumer face pairing for the trace-carrying lane operators.

Port of ``seigen_tpu/solver/lane_fused.py:derive_pairing`` and
``_canonical_shift`` (NumPy, copied): every operator emits the face traces
of its output in its own face-node order, and a consumer face re-reads them
at (producer face f2, node permutation pi) from the neighbour class at a
fixed lane shift.
"""

from __future__ import annotations

import numpy as np

from ..ops.structured_exchange import StructuredExchange


def derive_pairing(ex: StructuredExchange):
    """Producer-side face index f2 and node permutation pi per (t, f).

    ex.nodes[t, f] holds the neighbour's local node ids in CONSUMER order;
    the producer emits its own-face traces in fnodes order, so the exchange
    re-reads rows (f2, pi).  f2 is the unique neighbour face whose node set
    matches; pi[j] locates nodes[t, f][j] within fnodes[f2].
    """
    nf, nfp = ex.n_faces, ex.n_fp
    fsets = [frozenset(ex.own_nodes[f].tolist()) for f in range(nf)]
    f2 = np.zeros((ex.m, nf), dtype=np.int64)
    pi = np.zeros((ex.m, nf, nfp), dtype=np.int64)
    for t in range(ex.m):
        for f in range(nf):
            s = frozenset(ex.nodes[t, f].tolist())
            matches = [g for g in range(nf) if fsets[g] == s]
            assert len(matches) == 1, (t, f, s)
            g = matches[0]
            f2[t, f] = g
            pos = {int(n): j for j, n in enumerate(ex.own_nodes[g])}
            for j in range(nfp):
                pi[t, f, j] = pos[int(ex.nodes[t, f, j])]
    return f2, pi


def _flat_strides(grid):
    strides = []
    s = 1
    for g in reversed(grid):
        strides.append(s)
        s *= g
    return tuple(reversed(strides))


def _canonical_shift(ex: StructuredExchange, t: int, f: int):
    """True (unwrapped) per-axis neighbour offset for face (t, f), or None.

    ``ex.shift`` is only defined MODULO the grid — -1 and +1 coincide on
    a period-2 axis.  The lane-major operators read the neighbour at a
    flat lane shift WITHOUT the per-axis mod, so they need the true
    offset: the one whose out-of-range consumer set exactly equals the
    boundary mask (self_mask).  Returns the offset tuple, or None when no
    unique candidate matches.
    """
    import itertools

    grid = ex.grid
    dim = len(grid)
    base = [int(ex.shift[t, f, a]) for a in range(dim)]
    mask = np.asarray(ex.self_mask[t, f]).reshape(grid)
    options = []
    for s, g in zip(base, grid):
        if s == 0:
            options.append([0])
        else:
            alt = s - g * (1 if s > 0 else -1)
            options.append(sorted({s, alt}, key=abs))
    idx = np.indices(grid)
    matches = []
    for choice in itertools.product(*options):
        out = np.zeros(grid, dtype=bool)
        for a in range(dim):
            c = idx[a] + choice[a]
            out |= (c < 0) | (c >= grid[a])
        if np.array_equal(out, mask):
            matches.append(choice)
    return matches[0] if len(matches) == 1 else None
