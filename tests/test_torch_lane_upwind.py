"""The port's UpwindLaneRunner (CPU, plain operator version) end to end.

1. Against the JAX einsum RK4 oracle (``run_rk4``/``run_rk4_visco``) at f64,
   in the four cases of tests/test_upwind_lane.py: 3D ``box_mesh(3, 3, 3)``
   P2 with a blob source (kernel-fused dense injection), a sponge and 3
   receivers; viscoelastic (scatter-source path); viscoelastic and
   source-driven from a zero state; 2D ``rect_mesh(4, 4)`` P2.  States and
   seismograms agree at rtol 1e-10, atol 1e-12 * max|ref|.
2. The port's own einsum ``run_rk4`` agrees with the runner (> 2 wavelet
   groups: the scatter fallback), and ``run_xi`` chunks compose.
3. ``impl="kernel"`` refuses CPU tensors; the bench measures the runner.
"""

import functools

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
from seigen_tpu.ops.viscoelastic import build_visco as jvisco
from seigen_tpu.solver.rk4 import run_rk4 as jrun, run_rk4_visco as jrun_v
from seigen_tpu_torch.bench import throughput as tbench
from seigen_tpu_torch.ops.structured_exchange import \
    detect_structured as tdetect
from seigen_tpu_torch.ops.viscoelastic import build_visco as tvisco
from seigen_tpu_torch.solver.lane_upwind import UpwindLaneRunner


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


RTOL = 1e-10
MAT = (1.0, 2.0, 1.0)  # rho, vp, vs


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=1e-12 * np.abs(ref).max())


def _case(pkg_mesh, pkg_ops, pkg_sol, dim, dtype, **dev):
    """Mesh, params, impedances, blob source, sponge, receivers, dt of one
    package (the cases of tests/test_upwind_lane.py)."""
    ext = ((0.0, 1.0),) * dim
    if dim == 3:
        topo = pkg_mesh.box_mesh(3, 3, 3)
        pos, line = (0.5, 0.5, 0.7), ((0.2, 0.5, 0.9), (0.8, 0.5, 0.9))
    else:
        topo = pkg_mesh.rect_mesh(4, 4)
        pos, line = (0.5, 0.6), ((0.2, 0.9), (0.8, 0.9))
    dm = pkg_mesh.build_discrete(
        topo, 2, bc_fn=pkg_sol.absorbing_bc_fn(
            ext, free_sides=[(dim - 1, "hi")]))
    mat = pkg_ops.Material(*MAT)
    p = pkg_ops.build_params(dm, mat, dtype=dtype, **dev)
    w = pkg_ops.build_upwind_data(dm, mat, dtype=dtype, **dev)
    src = pkg_sol.build_sources(
        dm, [pkg_sol.PointSource(position=pos, f0=4.0,
                                 radius=0.25 if dim == 3 else 0.2)],
        dtype=dtype, **dev)
    rcv = pkg_sol.build_receivers(dm, pkg_sol.line(*line, 3), dtype=dtype,
                                  **dev)
    damp = pkg_sol.sponge_mask(dm, [(0, "lo"), (0, "hi")], width=0.3)
    dt = pkg_sol.cfl_dt(dm.h.min(), 2.0, 2, 0.25)
    return dm, p, w, src, rcv, damp, dt


@functools.cache
def _cases(dim):
    return (_case(jmesh, jops, jsol, dim, jnp.float64),
            _case(tmesh, tops, tsol, dim, torch.float64, device="cpu"))


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def cases(request):
    return _cases(request.param)


def _state(dm, dim, zero=False):
    n_sig = 3 if dim == 2 else 6
    E, n_p = dm.num_elements, dm.re.n_p
    rng = np.random.default_rng(3)
    u = rng.standard_normal((E, n_p, dim))
    s = rng.standard_normal((E, n_p, n_sig))
    return (0 * u, 0 * s) if zero else (u, s)


@pytest.mark.parametrize("dim,kind", [(2, "elastic"), (3, "elastic"),
                                      (3, "visco"), (3, "visco_zero")])
def test_runner_matches_jax_rk4(dim, kind):
    (dm_j, p_j, w_j, src_j, rcv_j, damp, dt), (
        dm_t, p_t, w_t, src_t, rcv_t, _, _) = _cases(dim)
    u, s = _state(dm_t, dim, zero=(kind == "visco_zero"))
    n = 12 if kind == "visco_zero" else 3
    # 2D: bare source (no sponge, no receivers), as in the JAX test
    dmp, rj, rt = (None, None, None) if dim == 2 else (damp, rcv_j, rcv_t)
    st_j = jsol.State(u=jnp.asarray(u), s=jnp.asarray(s))
    st_t = tsol.State(u=torch.as_tensor(u), s=torch.as_tensor(s))
    vj = vt = None
    if kind == "elastic":
        ref, seis_ref = jrun(p_j, w_j, st_j, dt, n, src=src_j,
                             damp=None if dmp is None else jnp.asarray(dmp),
                             receivers=rj)
    else:
        L, fmax = (2, 8.0) if kind == "visco" else (3, 10.0)
        vj = jvisco(p_j, 30.0, 20.0, 1.0, fmax, L=L)
        vt = tvisco(p_t, 30.0, 20.0, 1.0, fmax, L=L)
        ref, _, seis_ref = jrun_v(p_j, w_j, vj, st_j, dt, n, src=src_j,
                                  damp=jnp.asarray(dmp), receivers=rj)
    run = UpwindLaneRunner(p_t, tdetect(dm_t), w_t, dt, src=src_t,
                           damp=dmp, receivers=rt, visco=vt)
    assert run.impl == "reference"
    assert (run.src_dense is not None) == (kind == "elastic")
    out, seis = run.run(st_t, n)
    _close(out.u, ref.u)
    _close(out.s, ref.s)
    if rt is not None:
        _close(seis, seis_ref)


def test_runner_scatter_sources_and_xi_chunks(cases):
    """Three wavelet groups take the column-patch path: the runner against
    the port's own einsum stepper; then a visco run in chunks of 2 + 1
    steps through run_xi equals one run of 3 steps."""
    _, (dm, p, w, _, rcv, damp, dt) = cases
    dim = p.dim
    pos = [(0.5, 0.5, 0.7), (0.3, 0.6, 0.5), (0.6, 0.4, 0.3)]
    src = tsol.build_sources(
        dm, [tsol.PointSource(position=pos[g][:dim], f0=4.0 + g,
                              radius=0.25) for g in range(3)],
        dtype=torch.float64, device="cpu")
    u, s = _state(dm, dim)
    st = tsol.State(u=torch.as_tensor(u), s=torch.as_tensor(s))
    run = UpwindLaneRunner(p, tdetect(dm), w, dt, src=src, damp=damp,
                           receivers=rcv)
    assert run.src_dense is None and run.src_elems is not None
    out, seis = run.run(st, 3)
    ref, seis_ref = tsol.run_rk4(p, w, st, dt, 3, src=src,
                                 damp=torch.as_tensor(damp), receivers=rcv)
    _close(out.u, ref.u)
    _close(out.s, ref.s)
    _close(seis, seis_ref)

    v = tvisco(p, 30.0, 20.0, 1.0, 8.0, L=2)
    run = UpwindLaneRunner(p, tdetect(dm), w, dt, src=src, damp=damp,
                           visco=v)
    whole, xi_whole, _ = run.run_xi(st, None, 3)
    part, xi, _ = run.run_xi(st, None, 2)
    part, xi, _ = run.run_xi(part, xi, 1, step0=2)
    assert xi.shape == (dm.num_elements, p.n_p, p.n_sig, 2)
    _close(part.u, whole.u)
    _close(part.s, whole.s)
    _close(xi, xi_whole)


def test_kernel_impl_refuses_cpu(cases):
    _, (dm, p, w, _, _, _, dt) = cases
    with pytest.raises(ValueError, match="CUDA"):
        UpwindLaneRunner(p, tdetect(dm), w, dt, impl="kernel")


def test_bench_measures_upwind_lane_on_cpu():
    dm, p, src, damp, dt, st = tbench.setup_case(
        n=2, degree=2, dtype=torch.float64, device="cpu")
    res = tbench.measure(p, src, damp, dt, st, dm, n_steps=2,
                         impl="upwind_lane", kernel_impl="reference")
    assert res.n_dof == dm.num_elements * dm.re.n_p * 9
    assert np.isfinite(res.dof_updates_per_sec) and res.seconds > 0
    with pytest.raises(ValueError, match="impl"):
        tbench.measure(p, src, damp, dt, st, dm, impl="upwind_lane_x")
