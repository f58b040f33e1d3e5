"""Sponge (Cerjan-style) absorbing layers — "masked damping kernels" per [D].

A multiplicative per-node taper g(x) in (0, 1], equal to 1 outside the sponge
band and decaying as exp(-(alpha * (1 - d/W))^2) within distance d < W of an
absorbing boundary plane.  Applied to both u and sigma once per timestep — one
fused elementwise multiply on device.  Pairs with BC_ABSORB characteristic
faces for the outer boundary itself.
"""

from __future__ import annotations

import numpy as np

from ..mesh.discrete import DiscreteMesh


def sponge_mask(
    dm: DiscreteMesh,
    absorbing_sides: list[tuple[int, str]],
    width: float,
    alpha: float = 2.0,
) -> np.ndarray:
    """(E, n_p) per-step damping factors.

    absorbing_sides: list of (axis, "lo"|"hi") naming domain sides that
    absorb; e.g. everything but the free-surface top.
    """
    coords = dm.coords  # (E, n_p, dim)
    g = np.ones(coords.shape[:2])
    for ax, side in absorbing_sides:
        lo, hi = dm.topology.extents[ax]
        if side == "lo":
            d = coords[:, :, ax] - lo
        elif side == "hi":
            d = hi - coords[:, :, ax]
        else:
            raise ValueError(side)
        inside = d < width
        taper = np.exp(-((alpha * (1.0 - np.clip(d, 0, width) / width)) ** 2))
        g = np.where(inside, g * taper, g)
    return g


def absorbing_bc_fn(extents, free_sides: list[tuple[int, str]]):
    """bc_fn for build_discrete: BC_FREE on free_sides, BC_ABSORB elsewhere."""
    from ..mesh.discrete import BC_ABSORB, BC_FREE

    def bc_fn(centroids, normals):
        codes = np.full(len(centroids), BC_ABSORB, dtype=np.int8)
        for ax, side in free_sides:
            lo, hi = extents[ax]
            tgt = lo if side == "lo" else hi
            span = max(hi - lo, 1.0)
            on = np.abs(centroids[:, ax] - tgt) < 1e-9 * span
            codes[on] = BC_FREE
        return codes

    return bc_fn
