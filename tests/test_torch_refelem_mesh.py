"""Port host setup vs the JAX package: reference tables, meshes, lane plan.

The port carries the NumPy setup code over as copies, and builds the JAX
package's native C++ mesh library from a copy of its source with its
flags; these tests hold the copies to the reference arrays, exactly: the
tables, the integer maps and the mesh geometry (each package on its
default path, both native or both NumPy).  Both packages' mesh objects
are pure NumPy, so the tests need no device.
"""

import numpy as np
import pytest

import seigen_tpu.mesh as jmesh
import seigen_tpu.refelem as jref
import seigen_tpu_torch.mesh as tmesh
import seigen_tpu_torch.refelem as tref
from seigen_tpu.ops.structured_exchange import detect_structured as jdetect
from seigen_tpu.solver.damping import absorbing_bc_fn as jabc
from seigen_tpu.solver.lane_fused import _canonical_shift as jshift
from seigen_tpu.solver.lane_fused import derive_pairing as jpair
from seigen_tpu.solver.lane_major import class_major_perm as jperm
from seigen_tpu_torch.ops.structured_exchange import \
    detect_structured as tdetect
from seigen_tpu_torch.solver.damping import absorbing_bc_fn as tabc
from seigen_tpu_torch.solver.lane_fused import _canonical_shift as tshift
from seigen_tpu_torch.solver.lane_fused import derive_pairing as tpair
from seigen_tpu_torch.solver.lane_major import class_major_perm as tperm

TABLES = ("nodes", "face_vertices", "vertices", "M", "Minv", "Dr", "LIFT",
          "fnodes", "face_param_nodes", "qx", "qw", "Vq", "Vq_grad", "fq_x",
          "fq_w", "Vfq")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_ref_elem_tables_equal(dim, degree):
    a, b = jref.ref_elem(dim, degree), tref.ref_elem(dim, degree)
    assert (a.n_p, a.n_faces, a.n_fp) == (b.n_p, b.n_faces, b.n_fp)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    pts = np.random.default_rng(0).random((5, dim)) / dim
    np.testing.assert_array_equal(b.eval_basis(pts), a.eval_basis(pts))


def _meshes(which):
    ext3, ext2 = ((0.0, 1.0),) * 3, ((0.0, 1.0),) * 2
    if which == "box":
        return (
            jmesh.build_discrete(jmesh.box_mesh(3, 3, 3), 2,
                                 bc_fn=jabc(ext3, free_sides=[(2, "hi")])),
            tmesh.build_discrete(tmesh.box_mesh(3, 3, 3), 2,
                                 bc_fn=tabc(ext3, free_sides=[(2, "hi")])))
    return (
        jmesh.build_discrete(jmesh.rect_mesh(4, 4), 2,
                             bc_fn=jabc(ext2, free_sides=[(1, "hi")])),
        tmesh.build_discrete(tmesh.rect_mesh(4, 4), 2,
                             bc_fn=tabc(ext2, free_sides=[(1, "hi")])))


@pytest.mark.parametrize("which", ["box", "rect"])
def test_build_discrete_matches(which):
    a, b = _meshes(which)
    assert a.num_elements == b.num_elements
    for name in ("vertices", "cells"):
        np.testing.assert_array_equal(getattr(b.topology, name),
                                      getattr(a.topology, name))
    assert b.topology.structure == a.topology.structure
    for name in ("coords", "Ginv", "detJ", "Fscale", "normals", "h"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    np.testing.assert_array_equal(b.nbr, a.nbr)
    np.testing.assert_array_equal(b.bc, a.bc)


@pytest.mark.parametrize("which", ["box", "rect"])
def test_structured_plan_matches(which):
    a, b = _meshes(which)
    ea, eb = jdetect(a), tdetect(b)
    assert (eb.grid, eb.scale, eb.m) == (ea.grid, ea.scale, ea.m)
    for name in ("nbr_class", "shift", "nodes", "own_nodes", "self_mask"):
        np.testing.assert_array_equal(getattr(eb, name), getattr(ea, name))
    for x, y in zip(tperm(eb, b.num_elements), jperm(ea, a.num_elements)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tpair(eb), jpair(ea)):
        np.testing.assert_array_equal(x, y)
    for t in range(ea.m):
        for f in range(ea.n_faces):
            assert tshift(eb, t, f) == jshift(ea, t, f)
