"""The port's curvilinear elements (ops/curvilinear.py) vs the JAX package,
at f64 on the CPU.

1. ``build_curvi`` on a curved rect_mesh(4, 3) P2 (free top) and a curved
   box_mesh(2, 2, 2) P2 equals JAX's table for table, and the curvilinear
   velocity/stress operators equal JAX's on numpy-seeded fields (rtol
   1e-10).
2. Affine limit: on the identity geometry the curvilinear operators
   reproduce the port's affine einsum operators (rtol 1e-10).
3. ``make_curvi_ops`` plugs into the port's ``timestep.run`` (the
   ``vel_op(p, s)`` hooks): 5 LF4 steps on the curved 2D mesh equal JAX's
   ``run`` with its curvilinear ops (rtol 1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seigen_tpu.mesh as jmesh
import seigen_tpu.ops as jops
import seigen_tpu.solver as jsol
import seigen_tpu_torch.mesh as tmesh
import seigen_tpu_torch.ops as tops
import seigen_tpu_torch.solver as tsol
from seigen_tpu.ops import curvilinear as jcurvi
from seigen_tpu_torch.ops import curvilinear as tcurvi
from seigen_tpu_torch.ops.elastic import apply_stress_op, apply_vel_op


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


MAT = (1.3, 2.0, 1.1)  # rho, vp, vs
TOL = dict(rtol=1e-10, atol=1e-11)


def _phi(a, dim):
    """Smooth diffeomorphism of the unit square/cube (small a keeps
    detJ > 0); the map of tests/test_curvilinear.py in 2D."""
    def f(x):
        out = x.copy()
        out[:, 0] = x[:, 0] + a * np.sin(np.pi * x[:, 0]) * np.sin(
            2 * np.pi * x[:, 1])
        out[:, 1] = x[:, 1] + a * np.sin(2 * np.pi * x[:, 0]) * np.sin(
            np.pi * x[:, 1])
        if dim == 3:
            out[:, 2] = x[:, 2] + a * np.sin(np.pi * x[:, 2]) * np.sin(
                np.pi * x[:, 0])
        return out
    return f


def _case(dim):
    """(JAX dm, port dm, JAX params, port params) of a P2 mesh with a free
    top, absorbing elsewhere."""
    out = []
    for mesh, sol in ((jmesh, jsol), (tmesh, tsol)):
        topo = mesh.rect_mesh(4, 3) if dim == 2 else mesh.box_mesh(2, 2, 2)
        out.append(mesh.build_discrete(topo, 2, bc_fn=sol.absorbing_bc_fn(
            ((0, 1),) * dim, free_sides=[(dim - 1, "hi")])))
    dm_j, dm_t = out
    return (dm_j, dm_t,
            jops.build_params(dm_j, jops.Material(*MAT), dtype=jnp.float64),
            tops.build_params(dm_t, tops.Material(*MAT), dtype=torch.float64,
                              device="cpu"))


def _fields(p, seed):
    rng = np.random.default_rng(seed)
    E = p.Ginv.shape[0]
    return (rng.standard_normal((E, p.n_p, p.n_sig)),
            rng.standard_normal((E, p.n_p, p.dim)))


@pytest.mark.parametrize("dim", [2, 3])
def test_curvi_matches_jax(dim):
    dm_j, dm_t, p_j, p_t = _case(dim)
    X = tcurvi.curved_coords(dm_t, _phi(0.03, dim))
    np.testing.assert_allclose(
        X, jcurvi.curved_coords(dm_j, _phi(0.03, dim)), rtol=1e-13,
        atol=1e-15)
    cp_t = tcurvi.build_curvi(dm_t, X, dtype=torch.float64, device="cpu")
    cp_j = jcurvi.build_curvi(dm_j, X, dtype=jnp.float64)
    for name in ("De", "Lf", "Ff", "nrm_q", "X", "dim", "n_p", "n_faces",
                 "nfq", "n_sig"):
        a, b = getattr(cp_t, name), getattr(cp_j, name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                       err_msg=name)
        else:
            assert a == b, name
    s, u = _fields(p_t, dim)
    vop_t, sop_t = tops.make_curvi_ops(cp_t)
    vop_j, sop_j = jcurvi.make_curvi_ops(cp_j)
    np.testing.assert_allclose(vop_t(p_t, torch.as_tensor(s)).numpy(),
                               np.asarray(vop_j(p_j, jnp.asarray(s))), **TOL)
    np.testing.assert_allclose(sop_t(p_t, torch.as_tensor(u)).numpy(),
                               np.asarray(sop_j(p_j, jnp.asarray(u))), **TOL)


@pytest.mark.parametrize("dim", [2, 3])
def test_affine_limit_reproduces_einsum_ops(dim):
    _, dm, _, p = _case(dim)
    cp = tops.build_curvi(dm, dm.coords, dtype=torch.float64, device="cpu")
    vop, sop = tops.make_curvi_ops(cp)
    s, u = (torch.as_tensor(x) for x in _fields(p, 10 + dim))
    np.testing.assert_allclose(vop(p, s).numpy(), apply_vel_op(p, s).numpy(),
                               **TOL)
    np.testing.assert_allclose(sop(p, u).numpy(),
                               apply_stress_op(p, u).numpy(), **TOL)


def test_curvi_ops_in_timestep_run():
    dm_j, dm_t, p_j, p_t = _case(2)
    X = tcurvi.curved_coords(dm_t, _phi(0.03, 2))
    cp_t = tops.build_curvi(dm_t, X, dtype=torch.float64, device="cpu")
    cp_j = jcurvi.build_curvi(dm_j, X, dtype=jnp.float64)
    x, y = X[..., 0], X[..., 1]
    bump = np.exp(-60.0 * ((x - 0.5) ** 2 + (y - 0.55) ** 2))
    u0 = np.stack([bump, 0 * bump], axis=-1)
    s0 = np.zeros(u0.shape[:2] + (3,))
    dt = tsol.cfl_dt(float(dm_t.h.min()), 2.0, 2, 0.3)
    vop_t, sop_t = tops.make_curvi_ops(cp_t)
    fin_t, _ = tsol.run(p_t, tsol.State(u=torch.as_tensor(u0),
                                        s=torch.as_tensor(s0)),
                        dt, 5, order=4, vel_op=vop_t, stress_op=sop_t)
    vop_j, sop_j = jcurvi.make_curvi_ops(cp_j)
    fin_j, _ = jsol.run(p_j, jsol.State(u=jnp.asarray(u0),
                                        s=jnp.asarray(s0)),
                        dt, 5, order=4, vel_op=vop_j, stress_op=sop_j)
    for a, b in ((fin_t.u, fin_j.u), (fin_t.s, fin_j.s)):
        b = np.asarray(b)
        assert np.abs(b).max() > 0 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                   atol=1e-11 * np.abs(b).max())
