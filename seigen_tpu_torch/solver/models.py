"""Material model builders: homogeneous, layered, salt-body.

Port of ``seigen_tpu/solver/models.py`` (numpy, by copy).  Per-element
material sampling at element centroids: three (E,) arrays feeding the
operator coefficients (ops/elastic.py:build_params).
Depth axis is the last coordinate (y in 2D, z in 3D), increasing upward.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.discrete import DiscreteMesh
from ..ops.elastic import Material


def element_centroids(dm: DiscreteMesh) -> np.ndarray:
    verts = dm.topology.vertices[dm.topology.cells]  # (E, dim+1, dim)
    return verts.mean(axis=1)


@dataclass(frozen=True)
class Layer:
    """A horizontal layer: occupies depth-axis values in [bottom, top)."""

    bottom: float
    top: float
    rho: float
    vp: float
    vs: float


def layered_model(dm: DiscreteMesh, layers: list[Layer]) -> Material:
    """Piecewise-constant layered material by element centroid depth."""
    c = element_centroids(dm)
    depth = c[:, -1]
    rho = np.zeros(dm.num_elements)
    vp = np.zeros(dm.num_elements)
    vs = np.zeros(dm.num_elements)
    assigned = np.zeros(dm.num_elements, dtype=bool)
    for layer in layers:
        sel = (depth >= layer.bottom) & (depth < layer.top) & ~assigned
        rho[sel], vp[sel], vs[sel] = layer.rho, layer.vp, layer.vs
        assigned |= sel
    if not assigned.all():
        raise ValueError(
            f"{(~assigned).sum()} elements not covered by any layer"
        )
    return Material(rho=rho, vp=vp, vs=vs)


def add_ellipsoid_body(
    dm: DiscreteMesh,
    mat: Material,
    center,
    radii,
    rho: float,
    vp: float,
    vs: float,
) -> Material:
    """Override material inside an axis-aligned ellipsoid (salt body)."""
    c = element_centroids(dm)
    center = np.asarray(center, dtype=np.float64)
    radii = np.asarray(radii, dtype=np.float64)
    inside = np.sum(((c - center) / radii) ** 2, axis=1) < 1.0
    E = dm.num_elements
    new_rho = np.where(inside, rho, np.broadcast_to(np.asarray(mat.rho), (E,)))
    new_vp = np.where(inside, vp, np.broadcast_to(np.asarray(mat.vp), (E,)))
    new_vs = np.where(inside, vs, np.broadcast_to(np.asarray(mat.vs), (E,)))
    return Material(rho=new_rho, vp=new_vp, vs=new_vs)
