"""VTK output for ParaView.

Port of ``seigen_tpu/utils/io_vtk.py`` (NumPy, copied): VTU snapshots
(XML unstructured grid, ASCII) of nodal DG fields and a PVD collection
file indexing them by time.  DG fields are written with discontinuous
(per-element) points, which ParaView renders natively.  Fields come in as
NumPy arrays: the caller moves a tensor to the host once per write.
"""

from __future__ import annotations

import os

import numpy as np

from ..mesh.discrete import DiscreteMesh

_VTK_CELL_LINEAR = {2: 5, 3: 10}  # triangle / tetra


def write_vtu(
    path: str,
    dm: DiscreteMesh,
    fields: dict[str, np.ndarray],
    verts: np.ndarray | None = None,
) -> None:
    """Write nodal DG fields as a VTU file (linear sub-cells at the element
    vertices).

    fields: name -> (E, n_p, C) or (E, n_p) arrays.
    verts: optional (E, dim+1, dim) element-vertex coordinates —
    curvilinear meshes (ops/curvilinear.py) pass their mapped vertices so
    that the written geometry shows the curved domain.
    """
    E = dm.num_elements
    dim = dm.dim
    re = dm.re
    if verts is None:
        # vertices of each element from the topology (affine geometry)
        verts = dm.topology.vertices[dm.topology.cells]  # (E, dim+1, dim)
    npts = E * (dim + 1)
    pts3 = np.zeros((npts, 3))
    pts3[:, :dim] = verts.reshape(-1, dim)

    conn = np.arange(npts, dtype=np.int64).reshape(E, dim + 1)
    offsets = (np.arange(E) + 1) * (dim + 1)
    ctype = np.full(E, _VTK_CELL_LINEAR[dim], dtype=np.uint8)

    # each field at the element vertices (reference coords = simplex verts)
    Bv = re.eval_basis(re.vertices)  # (dim+1, n_p)

    def fmt(a):
        return " ".join(f"{x:.9g}" for x in np.asarray(a).ravel())

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1" '
        'byte_order="LittleEndian">',
        "  <UnstructuredGrid>",
        f'    <Piece NumberOfPoints="{npts}" NumberOfCells="{E}">',
        "      <Points>",
        '        <DataArray type="Float64" NumberOfComponents="3" '
        'format="ascii">',
        "          " + fmt(pts3),
        "        </DataArray>",
        "      </Points>",
        "      <PointData>",
    ]
    for name, arr in fields.items():
        arr = np.asarray(arr)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        C = arr.shape[2]
        vals = np.einsum("vi,eic->evc", Bv, arr)  # (E, dim+1, C)
        if C == dim:  # pad vectors to 3 components for ParaView
            pad = np.zeros((E, dim + 1, 3))
            pad[:, :, :dim] = vals
            vals, C = pad, 3
        lines += [
            f'        <DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{C}" format="ascii">',
            "          " + fmt(vals),
            "        </DataArray>",
        ]
    lines += [
        "      </PointData>",
        "      <Cells>",
        '        <DataArray type="Int64" Name="connectivity" '
        'format="ascii">',
        "          " + fmt(conn),
        "        </DataArray>",
        '        <DataArray type="Int64" Name="offsets" format="ascii">',
        "          " + fmt(offsets),
        "        </DataArray>",
        '        <DataArray type="UInt8" Name="types" format="ascii">',
        "          " + fmt(ctype),
        "        </DataArray>",
        "      </Cells>",
        "    </Piece>",
        "  </UnstructuredGrid>",
        "</VTKFile>",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))


class PVDWriter:
    """Time series: a PVD collection over one VTU file per write."""

    def __init__(self, path: str, dm: DiscreteMesh,
                 verts: np.ndarray | None = None):
        if not path.endswith(".pvd"):
            raise ValueError(f"a PVD collection path ends in .pvd: {path!r}")
        self.path = path
        self.dm = dm
        self.verts = verts
        self.base = path[:-4]
        self.entries: list[tuple[float, str]] = []
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, t: float, fields: dict[str, np.ndarray]) -> str:
        vtu = f"{self.base}_{len(self.entries):05d}.vtu"
        write_vtu(vtu, self.dm, fields, verts=self.verts)
        self.entries.append((t, os.path.basename(vtu)))
        self._flush()
        return vtu

    def _flush(self):
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="0.1">',
            "  <Collection>",
        ]
        for t, f in self.entries:
            lines.append(
                f'    <DataSet timestep="{t}" group="" part="0" file="{f}"/>'
            )
        lines += ["  </Collection>", "</VTKFile>"]
        with open(self.path, "w") as f:
            f.write("\n".join(lines))
