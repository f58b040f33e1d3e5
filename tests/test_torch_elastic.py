"""Port operator data and einsum operators vs the JAX package (f64, CPU).

``params_from_numpy`` carries the JAX ``ElasticParams`` across; it must
equal the port's own ``build_params``, and the einsum operators
(``apply_vel_op``/``apply_stress_op``) must agree at rtol 1e-12 on the same
numpy-seeded fields.  The fused operator data (geo rows, Dr/LIFT/R tables,
damping rows) must equal the JAX ``build_fused_data`` row for row.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seigen_tpu.mesh as jmesh
import seigen_tpu.ops as jops
import seigen_tpu_torch.mesh as tmesh
import seigen_tpu_torch.ops as tops
from seigen_tpu.ops.fused_kernels import build_fused_data as jfused
from seigen_tpu.solver.damping import absorbing_bc_fn, sponge_mask
from seigen_tpu_torch.ops.fused_kernels import build_fused_data as tfused


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tiny CPU operators gain nothing from intra-op threads, and
    several pytest workers' thread pools fight over the cores (a 60-step
    einsum run: 0.15 s on one thread, 106 s with six processes on eight
    cores at the default)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAT = jops.Material(rho=1.0, vp=2.0, vs=1.0)
TMAT = tops.Material(rho=1.0, vp=2.0, vs=1.0)


def _case(dim):
    ext = ((0.0, 1.0),) * dim
    if dim == 3:
        topo_j, topo_t = jmesh.box_mesh(3, 3, 3), tmesh.box_mesh(3, 3, 3)
        free = [(2, "hi")]
    else:
        topo_j, topo_t = jmesh.rect_mesh(4, 4), tmesh.rect_mesh(4, 4)
        free = [(1, "hi")]
    bc = absorbing_bc_fn(ext, free_sides=free)
    dm_j = jmesh.build_discrete(topo_j, 2, bc_fn=bc)
    dm_t = tmesh.build_discrete(topo_t, 2, bc_fn=bc)
    p_j = jops.build_params(dm_j, MAT, dtype=jnp.float64)
    p_t = tops.build_params(dm_t, TMAT, dtype=torch.float64, device="cpu")
    return dm_j, p_j, p_t


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def case(request):
    return _case(request.param)


def _carried(p_j):
    arrays = {f.name: np.asarray(getattr(p_j, f.name))
              for f in dataclasses.fields(p_j)}
    return tops.params_from_numpy(arrays, "cpu", torch.float64)


def test_params_from_numpy_equals_build_params(case):
    _, p_j, p_t = case
    p_c = _carried(p_j)
    for f in dataclasses.fields(p_t):
        a, b = getattr(p_c, f.name), getattr(p_t, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            # exact: both packages take the same mesh geometry (native)
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f.name)
        else:
            assert a == b, f.name


def test_einsum_operators_match(case):
    _, p_j, p_t = case
    p_c = _carried(p_j)
    E, n_p, dim, n_sig = p_t.Ginv.shape[0], p_t.n_p, p_t.dim, p_t.n_sig
    rng = np.random.default_rng(3)
    u = rng.standard_normal((E, n_p, dim))
    s = rng.standard_normal((E, n_p, n_sig))
    for p in (p_c, p_t):
        np.testing.assert_allclose(
            tops.apply_vel_op(p, torch.as_tensor(s)).numpy(),
            np.asarray(jops.apply_vel_op(p_j, jnp.asarray(s))), rtol=1e-12,
            atol=1e-12)
        np.testing.assert_allclose(
            tops.apply_stress_op(p, torch.as_tensor(u)).numpy(),
            np.asarray(jops.apply_stress_op(p_j, jnp.asarray(u))),
            rtol=1e-12, atol=1e-12)


def test_fused_data_matches(case):
    dm_j, p_j, p_t = case
    dim = p_t.dim
    sides = [(0, "lo"), (0, "hi"), (1, "lo")] + (
        [(1, "hi"), (2, "lo")] if dim == 3 else [])
    damp = sponge_mask(dm_j, sides, width=0.3)
    a = jfused(p_j, damp=jnp.asarray(damp))
    b = tfused(p_t, damp=damp)
    for name in ("dim", "n_p", "npp", "ftp", "ftpp", "n_sig", "E", "nf",
                 "n_fp", "off"):
        assert getattr(b, name) == getattr(a, name), name
    for name in ("drr", "lift", "geo", "damp"):
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   np.asarray(getattr(a, name)), rtol=1e-13,
                                   atol=1e-15, err_msg=name)


def test_fused_data_refuses_unported_layouts(case):
    _, _, p_t = case
    # the packed layout is ported for P1 only (tests/test_torch_packed.py)
    with pytest.raises(ValueError, match="P1"):
        tfused(p_t, packed=True)
    # the stiffness section is ported: n_sig sections of 8 rows after mat
    d = tfused(p_t, stiffness=np.eye(p_t.n_sig))
    o_mat, o_C, total = d.off[5:8]
    assert o_C == o_mat + 8 and total == o_C + 8 * p_t.n_sig
    assert d.geo.shape[0] == total
    for c in range(p_t.n_sig):
        sec = d.geo[o_C + 8 * c : o_C + 8 * c + 8].numpy()
        want = np.zeros(8)
        want[c] = 1.0
        np.testing.assert_array_equal(sec, np.tile(want[:, None],
                                                   (1, sec.shape[1])))
