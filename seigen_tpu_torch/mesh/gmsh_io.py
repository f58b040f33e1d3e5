"""Gmsh .msh import (ASCII v2.2 and v4.1) — no external dependencies.

Port of ``seigen_tpu/mesh/gmsh_io.py`` (NumPy, copied).

Reference parity: Seigen's production runs read Gmsh unstructured meshes via
Firedrake's Mesh() (SURVEY.md §3 "Mesh handling"), with boundary conditions
attached to Gmsh physical surface ids (SURVEY.md §4.4).  Structured meshers
cover the [D] configs, so this importer handles the common ASCII subsets:
the highest-dimensional simplices (triangles or tets) become cells, and
codimension-1 elements (lines under triangles, triangles under tets) tagged
with physical groups become named boundary facet groups
(``MeshTopology.facet_groups``), consumed by
``build_discrete(bc_groups={name: BC_code})``.
"""

from __future__ import annotations

import numpy as np

from .structured import MeshTopology, _orient_positive

# Gmsh element type ids
_LINE = 1
_TRI = 2
_TET = 4


def read_msh(path: str, periodic: tuple = ()) -> MeshTopology:
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0

    def section(name):
        nonlocal i
        while i < len(lines) and lines[i].strip() != f"${name}":
            i += 1
        if i == len(lines):
            return None
        i += 1
        start = i
        while lines[i].strip() != f"$End{name}":
            i += 1
        body = lines[start:i]
        i += 1
        return body

    fmt = section("MeshFormat")
    if fmt is None:
        raise ValueError("not a Gmsh file (no $MeshFormat)")
    version = float(fmt[0].split()[0])

    # physical names: (dim, tag) -> name
    i = 0
    phys_names: dict[tuple[int, int], str] = {}
    pn = section("PhysicalNames")
    if pn is not None:
        for ln in pn[1 : 1 + int(pn[0])]:
            parts = ln.split(None, 2)
            phys_names[(int(parts[0]), int(parts[1]))] = (
                parts[2].strip().strip('"'))

    # facets[(etype)] -> list of (phys_tag, vertex ids); cells -> list of ids
    cells = {_TRI: [], _TET: []}
    facets: list[tuple[int, int, list[int]]] = []  # (etype, phys, verts)

    if version < 4.0:
        i = 0
        nodes_body = section("Nodes")
        i = 0
        elems_body = section("Elements")
        n_nodes = int(nodes_body[0])
        coords = np.zeros((n_nodes, 3))
        idmap = {}
        for k, ln in enumerate(nodes_body[1 : 1 + n_nodes]):
            parts = ln.split()
            idmap[int(parts[0])] = k
            coords[k] = [float(x) for x in parts[1:4]]
        n_el = int(elems_body[0])
        for ln in elems_body[1 : 1 + n_el]:
            parts = [int(x) for x in ln.split()]
            etype = parts[1]
            ntags = parts[2]
            vs = [idmap[v] for v in parts[3 + ntags :]]
            if etype in cells:
                cells[etype].append(vs)
            elif etype in (_LINE, _TRI):
                phys = parts[3] if ntags >= 1 else 0
                facets.append((etype, phys, vs))
    else:
        # v4.1: $Entities maps (entity dim, tag) -> physical tags
        i = 0
        ent_phys: dict[tuple[int, int], int] = {}
        ent = section("Entities")
        if ent is not None:
            counts = [int(x) for x in ent[0].split()]
            row = 1
            for d, cnt in enumerate(counts):
                for _ in range(cnt):
                    parts = ent[row].split()
                    tag = int(parts[0])
                    # points: tag x y z numPhys ...; others: tag 6-bbox
                    # numPhys ...
                    np_off = 4 if d == 0 else 7
                    n_phys = int(parts[np_off])
                    if n_phys:
                        ent_phys[(d, tag)] = int(parts[np_off + 1])
                    row += 1
        i = 0
        nodes_body = section("Nodes")
        i = 0
        elems_body = section("Elements")
        hdr = nodes_body[0].split()
        n_blocks, n_nodes = int(hdr[0]), int(hdr[1])
        coords = np.zeros((n_nodes, 3))
        idmap = {}
        row = 1
        count = 0
        for _ in range(n_blocks):
            bh = nodes_body[row].split()
            nb = int(bh[3])
            row += 1
            tags = [int(nodes_body[row + j]) for j in range(nb)]
            row += nb
            for j in range(nb):
                parts = nodes_body[row + j].split()
                idmap[tags[j]] = count
                coords[count] = [float(x) for x in parts[:3]]
                count += 1
            row += nb
        hdr = elems_body[0].split()
        n_blocks = int(hdr[0])
        row = 1
        for _ in range(n_blocks):
            bh = elems_body[row].split()
            edim, etag, etype, nb = (int(bh[0]), int(bh[1]), int(bh[2]),
                                     int(bh[3]))
            row += 1
            phys = ent_phys.get((edim, etag), 0)
            for j in range(nb):
                parts = [int(x) for x in elems_body[row + j].split()]
                vs = [idmap[v] for v in parts[1:]]
                if etype in cells:
                    cells[etype].append(vs)
                elif etype in (_LINE, _TRI):
                    facets.append((etype, phys, vs))
            row += nb

    if cells[_TET]:
        cell_arr = np.array(cells[_TET], dtype=np.int64)
        dim = 3
        facet_type = _TRI
    elif cells[_TRI]:
        cell_arr = np.array(cells[_TRI], dtype=np.int64)
        dim = 2
        facet_type = _LINE
    else:
        raise ValueError("no triangles or tetrahedra found")

    verts = coords[:, :dim]
    # drop unused vertices (e.g. from lower-dim physical groups)
    used = np.unique(cell_arr)
    remap = -np.ones(len(verts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    verts = verts[used]
    cell_arr = remap[cell_arr]
    cell_arr = _orient_positive(verts, cell_arr)

    # codim-1 physical groups -> named facet groups (remapped vertex ids)
    groups: dict[str, list[list[int]]] = {}
    for etype, phys, vs in facets:
        if etype != facet_type or phys == 0:
            continue
        name = phys_names.get((dim - 1, phys), str(phys))
        rvs = [int(remap[v]) for v in vs]
        if any(r < 0 for r in rvs):
            continue  # facet on vertices not used by any cell
        groups.setdefault(name, []).append(rvs)
    facet_groups = (
        {k: np.asarray(v, dtype=np.int64) for k, v in groups.items()}
        or None
    )

    extents = tuple(
        (float(verts[:, d].min()), float(verts[:, d].max()))
        for d in range(dim)
    )
    return MeshTopology(
        vertices=verts, cells=cell_arr, extents=extents,
        periodic=tuple(periodic), facet_groups=facet_groups,
    )
