"""Structured simplicial meshers (host-side NumPy).

Rebuild equivalent of the reference's Firedrake ``UnitSquareMesh`` /
``UnitCubeMesh`` / ``RectangleMesh`` constructors (SURVEY.md §3 "Mesh
handling", backed there by PETSc DMPlex).  Here a mesh is plain arrays:
vertices (Nv, dim) and cells (E, dim+1) with positively-oriented simplices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MeshTopology:
    """A simplicial mesh plus the metadata connectivity needs.

    ``structure``, when set by a structured mesher, is ((n0, n1[, n2]), m):
    cells laid out lexicographically on that grid with m simplices per cell,
    element id e = cell_flat * m + t.  It enables the roll-based structured
    trace exchange (ops/structured_exchange.py); None for general meshes.
    """

    vertices: np.ndarray  # (Nv, dim)
    cells: np.ndarray  # (E, dim+1) vertex ids, positive orientation
    extents: tuple  # ((x0, x1), (y0, y1)[, (z0, z1)]) bounding box
    periodic: tuple = ()  # axes with periodic identification, e.g. (0, 1)
    structure: tuple | None = None  # ((grid dims), simplices per cell)
    # named boundary facet groups (Gmsh physical groups): name -> (F, dim)
    # facet vertex-id array; consumed by build_discrete(bc_groups=...)
    facet_groups: dict | None = None

    @property
    def dim(self) -> int:
        return self.vertices.shape[1]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]


def _orient_positive(vertices: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Flip cells to positive signed volume (required by geometry factors)."""
    v = vertices[cells]  # (E, dim+1, dim)
    edges = v[:, 1:] - v[:, :1]  # (E, dim, dim)
    det = np.linalg.det(edges)
    flip = det < 0
    cells = cells.copy()
    cells[flip, -2], cells[flip, -1] = cells[flip, -1], cells[flip, -2].copy()
    return cells


def rect_mesh(
    nx: int,
    ny: int,
    x0: float = 0.0,
    y0: float = 0.0,
    lx: float = 1.0,
    ly: float = 1.0,
    periodic: tuple = (),
) -> MeshTopology:
    """nx*ny grid of quads, each split into 2 triangles (2*nx*ny cells).

    Diagonals alternate in a union-jack (criss-cross) pattern per quad parity
    to avoid mesh-induced anisotropy.
    """
    xs = x0 + lx * np.arange(nx + 1) / nx
    ys = y0 + ly * np.arange(ny + 1) / ny
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    cells = []
    for i in range(nx):
        for j in range(ny):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            if (i + j) % 2 == 0:
                cells.append([a, b, c])
                cells.append([a, c, d])
            else:
                cells.append([a, b, d])
                cells.append([b, c, d])
    cells = _orient_positive(vertices, np.array(cells, dtype=np.int64))
    return MeshTopology(
        vertices=vertices,
        cells=cells,
        extents=((x0, x0 + lx), (y0, y0 + ly)),
        periodic=tuple(periodic),
        structure=((nx, ny), 2),
    )


_KUHN_PERMS = [
    (0, 1, 2),
    (0, 2, 1),
    (1, 0, 2),
    (1, 2, 0),
    (2, 0, 1),
    (2, 1, 0),
]


def box_mesh(
    nx: int,
    ny: int,
    nz: int,
    x0: float = 0.0,
    y0: float = 0.0,
    z0: float = 0.0,
    lx: float = 1.0,
    ly: float = 1.0,
    lz: float = 1.0,
    periodic: tuple = (),
) -> MeshTopology:
    """nx*ny*nz grid of cubes, each Kuhn-split into 6 tets (6*nx*ny*nz cells)."""
    xs = x0 + lx * np.arange(nx + 1) / nx
    ys = y0 + ly * np.arange(ny + 1) / ny
    zs = z0 + lz * np.arange(nz + 1) / nz
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    cells = []
    unit = np.eye(3, dtype=np.int64)
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                base = np.array([i, j, k])
                for perm in _KUHN_PERMS:
                    # Path 0 -> e_p0 -> e_p0+e_p1 -> (1,1,1)
                    p0 = base + unit[perm[0]]
                    p1 = p0 + unit[perm[1]]
                    p2 = p1 + unit[perm[2]]
                    cells.append(
                        [
                            vid(*base),
                            vid(*p0),
                            vid(*p1),
                            vid(*p2),
                        ]
                    )
    cells = _orient_positive(vertices, np.array(cells, dtype=np.int64))
    return MeshTopology(
        vertices=vertices,
        cells=cells,
        extents=((x0, x0 + lx), (y0, y0 + ly), (z0, z0 + lz)),
        periodic=tuple(periodic),
        structure=((nx, ny, nz), 6),
    )
