"""The inputs of a run, made from the configuration and ``--seed``.

Both sides get the same inputs: the mesh topology (a Kuhn-split box, its
cells optionally put in a fixed random order with no structure), the
per-element material (layers and a salt ellipsoid by element centroid,
each element's rho, vp and vs scaled by a factor drawn from the seed),
the source position (drawn from the configuration's source box), the
receiver points, dt, the Ricker frequency and the source radius.  dt and
f0 follow from the mesh and the configuration's vp bound, never from the
draw; the source box is a point, since the source's position changed the
cost of a step.  So every seed costs the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .reference.mesh import geometry
from .reference.refelem import tables


@dataclass(frozen=True)
class Inputs:
    vertices: np.ndarray  # (Nv, dim)
    cells: np.ndarray  # (E, dim + 1)
    extents: tuple
    grid: tuple | None  # the box grid when the cells keep its order
    rho: np.ndarray  # (E,)
    vp: np.ndarray
    vs: np.ndarray
    source: tuple
    f0: float
    radius: float
    receivers: np.ndarray  # (R, dim)
    dt: float
    degree: int
    free_sides: tuple
    absorb_sides: tuple
    sponge_width: float

    @property
    def E(self) -> int:
        return self.cells.shape[0]


def box_topology(n, extent):
    """Vertices and cells of an n0 x n1 x n2 box of cubes, each split into
    six positively oriented tetrahedra along the paths 0 -> e_p0 -> e_p0 +
    e_p1 -> (1, 1, 1), cells in lexicographic cube order."""
    nx, ny, nz = n
    axes = [lo + (hi - lo) * np.arange(k + 1) / k
            for k, (lo, hi) in zip(n, extent)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    i, j, k = (a.ravel() for a in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    base = np.stack([i, j, k], axis=1)  # (C, 3)
    unit = np.eye(3, dtype=np.int64)
    perms = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
             (2, 1, 0)]

    def vid(c):
        return (c[..., 0] * (ny + 1) + c[..., 1]) * (nz + 1) + c[..., 2]

    tets = []
    for p in perms:
        p0 = base + unit[p[0]]
        p1 = p0 + unit[p[1]]
        p2 = p1 + unit[p[2]]
        tets.append(np.stack([vid(base), vid(p0), vid(p1), vid(p2)], 1))
    cells = np.stack(tets, axis=1).reshape(-1, 4)
    e = verts[cells[:, 1:]] - verts[cells[:, :1]]
    flip = np.linalg.det(e) < 0
    cells[flip, 2], cells[flip, 3] = cells[flip, 3], cells[flip, 2].copy()
    return verts, cells


def _rng(seed: int):
    return np.random.default_rng(int(seed) % 2 ** 64)


def make_inputs(cfg: dict, seed: int) -> Inputs:
    """The run's inputs from a configuration (``configs/<name>.json``)."""
    mesh = cfg["mesh"]
    extent = tuple(tuple(float(x) for x in e) for e in mesh["extent"])
    verts, cells = box_topology(tuple(mesh["n"]), extent)
    grid = tuple(mesh["n"])
    if mesh.get("scramble"):
        cells = cells[np.random.default_rng(0).permutation(len(cells))]
        grid = None
    E, dim = cells.shape[0], verts.shape[1]

    depth = verts[cells].mean(axis=1)[:, -1]
    top = extent[-1][1]
    rho, vp, vs = (np.zeros(E) for _ in range(3))
    done = np.zeros(E, bool)
    for lay in cfg["layers"]:  # [bottom, top) as fractions of the depth
        sel = (depth >= lay["bottom"] * top) & (depth < lay["top"] * top) \
            & ~done
        rho[sel], vp[sel], vs[sel] = lay["rho"], lay["vp"], lay["vs"]
        done |= sel
    if not done.all():
        raise ValueError("elements outside every layer")
    body = cfg.get("salt")
    if body:
        c = verts[cells].mean(axis=1)
        inside = (((c - body["center"]) / body["radii"]) ** 2).sum(1) < 1.0
        rho[inside], vp[inside], vs[inside] = (body["rho"], body["vp"],
                                               body["vs"])

    rng = _rng(seed)
    box = np.asarray(cfg["source_box"], np.float64)
    source = tuple(rng.uniform(box[:, 0], box[:, 1]))
    a = cfg["perturbation"]
    f_rho, f_vp, f_vs = rng.uniform(1.0 - a, 1.0 + a, size=(3, E))

    degree = int(cfg["degree"])
    h = float(geometry(verts, cells,
                       tables(dim, degree).face_vertices)[4].min())
    vp_bound = max([lay["vp"] for lay in cfg["layers"]]
                   + ([body["vp"]] if body else [])) * (1.0 + a)
    dt = cfg["cfl"] * h / (vp_bound * (2 * degree + 1))
    f0 = cfg["f0_factor"] * vp_bound / h / (degree + 1)
    r = cfg["receivers"]
    t = np.linspace(0.0, 1.0, r["n"])[:, None]
    pts = np.asarray(r["from"])[None] * (1 - t) + np.asarray(r["to"]) * t
    return Inputs(
        vertices=verts, cells=cells, extents=extent, grid=grid,
        rho=rho * f_rho, vp=vp * f_vp, vs=vs * f_vs, source=source, f0=f0,
        radius=cfg["source_radius_h"] * h, receivers=pts, dt=dt,
        degree=degree,
        free_sides=tuple((a_, s) for a_, s in cfg["free_sides"]),
        absorb_sides=tuple((a_, s) for a_, s in cfg["absorb_sides"]),
        sponge_width=float(cfg["sponge_width"]))
