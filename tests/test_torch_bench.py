"""The port's throughput bench on the CPU, and the port's import guard.

``setup_case`` must build the JAX bench's case (same mesh, parameters,
source, sponge, dt; with ``scramble=True`` the same cell permutation);
``measure`` runs end to end on the CPU through the plain operator versions,
for the lane runners at LF2 and LF4 and the v2 runner (LF4 only) too, and
with ``vti=True`` through the general Hooke law (the upwind impls refuse
it); ``main`` refuses to measure
without a CUDA device; the entry points default to the card; and importing
the port never imports JAX.
"""

import inspect
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seigen_tpu.bench import throughput as jbench
from seigen_tpu_torch.bench import throughput as tbench


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


REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cases():
    return (jbench.setup_case(n=2, degree=2, dtype=jnp.float64),
            tbench.setup_case(n=2, degree=2, dtype=torch.float64,
                              device="cpu"))


def test_setup_case_matches_jax(cases):
    (dm_j, p_j, src_j, damp_j, dt_j, st_j), (dm_t, p_t, src_t, damp_t,
                                            dt_t, st_t) = cases
    assert dt_t == pytest.approx(dt_j, rel=1e-15)
    assert dm_t.num_elements == dm_j.num_elements
    np.testing.assert_array_equal(dm_t.bc, dm_j.bc)
    for name in ("Ginv", "Fscale", "normals", "inv_rho", "lam", "mu",
                 "beta_t", "delta_u"):
        np.testing.assert_allclose(getattr(p_t, name).numpy(),
                                   np.asarray(getattr(p_j, name)),
                                   rtol=1e-13, atol=1e-15, err_msg=name)
    np.testing.assert_array_equal(src_t.elems.numpy(),
                                  np.asarray(src_j.elems))
    for name in ("vec_u", "vec_s", "f0", "t0", "amp"):
        np.testing.assert_allclose(getattr(src_t, name).numpy(),
                                   np.asarray(getattr(src_j, name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    np.testing.assert_allclose(damp_t.numpy(), np.asarray(damp_j),
                               rtol=1e-13)
    assert st_t.u.shape == st_j.u.shape and st_t.s.shape == st_j.s.shape


def test_measure_reference_on_cpu(cases):
    dm, p, src, damp, dt, st = cases[1]
    res = tbench.measure(p, src, damp, dt, st, dm, n_steps=2,
                         kernel_impl="reference")
    assert res.n_dof == dm.num_elements * dm.re.n_p * 9
    assert np.isfinite(res.dof_updates_per_sec)
    assert res.dof_updates_per_sec > 0 and res.seconds > 0


@pytest.mark.parametrize("impl,order", [("lane", 2), ("lane_u", 4)])
def test_measure_lane_runners_on_cpu(impl, order):
    dm, p, src, damp, dt, st = tbench.setup_case(
        n=2, degree=1, dtype=torch.float64, device="cpu",
        scramble=(impl == "lane_u"))
    runner = tbench.make_runner(impl, dm, p, src, damp, dt, "reference",
                                order=order)
    assert runner.order == order and runner.impl == "reference"
    res = tbench.measure(p, src, damp, dt, st, dm, n_steps=2, impl=impl,
                         kernel_impl="reference", order=order)
    assert res.n_dof == dm.num_elements * dm.re.n_p * 9
    assert np.isfinite(res.dof_updates_per_sec) and res.seconds > 0
    with pytest.raises(ValueError, match="LF4"):
        tbench.make_runner("merged", dm, p, src, damp, dt, "reference",
                           order=2)


def test_measure_fused_on_cpu():
    dm, p, src, damp, dt, st = tbench.setup_case(
        n=2, degree=1, dtype=torch.float64, device="cpu")
    runner = tbench.make_runner("fused", dm, p, src, damp, dt, "reference")
    assert runner.impl == "reference"
    res = tbench.measure(p, src, damp, dt, st, dm, n_steps=2, impl="fused",
                         kernel_impl="reference")
    assert res.n_dof == dm.num_elements * dm.re.n_p * 9
    assert np.isfinite(res.dof_updates_per_sec) and res.seconds > 0
    with pytest.raises(ValueError, match="LF4"):
        tbench.make_runner("fused", dm, p, src, damp, dt, "reference",
                           order=2)


@pytest.mark.parametrize("impl", ["merged", "lane", "lane_u", "fused"])
def test_vti_bench_runs_the_general_hooke_law(impl):
    """``vti=True`` hands the runner the JAX bench's VTI stiffness (same
    Thomsen parameters, one matrix per element) and changes the result."""
    from seigen_tpu.ops.anisotropic import vti_stiffness

    dm, p, src, damp, dt, st = tbench.setup_case(
        n=2, degree=1, dtype=torch.float64, device="cpu",
        scramble=(impl == "lane_u"))
    E = dm.num_elements
    C = tbench.bench_stiffness(impl, E)
    assert C.shape == (E, 6, 6)
    np.testing.assert_array_equal(
        C[E // 2], vti_stiffness(2.0, 1.0, 1.0, epsilon=0.15, delta=0.05,
                                 gamma=0.1))
    outs = []
    for vti in (False, True):
        runner = tbench.make_runner(impl, dm, p, src, damp, dt, "reference",
                                    vti=vti)
        has_c = (runner.d.off[6] >= 0 if impl in ("merged", "fused")
                 else runner.cmat is not None)
        assert has_c is vti
        outs.append(runner.run(st, 2)[0])
    assert torch.isfinite(outs[1].s).all()
    assert not torch.allclose(outs[0].s, outs[1].s)
    res = tbench.measure(p, src, damp, dt, st, dm, n_steps=2, impl=impl,
                         kernel_impl="reference", vti=True)
    assert np.isfinite(res.dof_updates_per_sec) and res.seconds > 0


@pytest.mark.parametrize("impl", ["upwind_lane", "upwind_lane_u"])
def test_vti_bench_refuses_the_upwind_impls(impl):
    """The Riemann solver is isotropy-specific: refuse rather than time
    isotropic physics under a row labelled vti."""
    dm, p, src, damp, dt, _ = tbench.setup_case(
        n=2, degree=1, dtype=torch.float64, device="cpu",
        scramble=(impl == "upwind_lane_u"))
    with pytest.raises(ValueError, match="vti"):
        tbench.make_runner(impl, dm, p, src, damp, dt, "reference", vti=True)


def test_scrambled_case_matches_jax():
    dm_j = jbench.setup_case(n=2, degree=1, dtype=jnp.float64,
                             scramble=True)[0]
    dm_t = tbench.setup_case(n=2, degree=1, dtype=torch.float64,
                             device="cpu", scramble=True)[0]
    assert dm_t.topology.structure is None
    np.testing.assert_array_equal(dm_t.topology.cells, dm_j.topology.cells)
    np.testing.assert_array_equal(dm_t.bc, dm_j.bc)


def test_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.main(n=2, degree=2, n_steps=1)


def test_profile_groups_kernels_and_needs_cuda(monkeypatch):
    from seigen_tpu_torch.bench import profile_step as ps

    names = {
        "void (anonymous namespace)::upwind_rhs_kernel<3, 20, 10>"
        "(UpwindArgs)": "upwind_rhs",
        "void (anonymous namespace)::merged_vel_kernel<3, 20, 10>"
        "(MergedArgs)": "merged_vel",
        "void (anonymous namespace)::lane_stress_kernel<3, 20, 10>"
        "(LaneArgs)": "lane_stress",
        "void (anonymous namespace)::merged_vel_kernel<3, 20, 10, true>"
        "(MergedArgs)": "fused_vel2",
        "void (anonymous namespace)::merged_stress_kernel<3, 20, 10, true, "
        "false>(MergedArgs)": "merged_stress",
        "void (anonymous namespace)::merged_stress_kernel<3, 20, 10, true, "
        "true>(MergedArgs)": "fused_stress2",
        "void (anonymous namespace)::trace_exchange_kernel(ExchangeArgs)":
        "trace_exchange",
        "void at::native::_scatter_gather_elementwise_kernel<128, 4>":
        "pytorch gather/index",
        "void at::native::indexSelectLargeIndex<float, long>":
        "pytorch gather/index",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>>": "pytorch elementwise",
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n": "pytorch matmul",
        "CatArrayBatchedCopy_vectorized": "pytorch copy/cat",
        "memset": "other"}
    assert {n: ps.kernel_group(n) for n in names} == names
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ps.profile(n=2, degree=2)


def test_entry_points_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU (the tests pass device="cpu")."""
    from seigen_tpu_torch.ops import build_params, build_upwind_data
    from seigen_tpu_torch.solver import build_receivers, build_sources

    for fn in (build_params, build_sources, build_receivers,
               tbench.setup_case, build_upwind_data):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_port_never_imports_jax():
    code = ("import sys, seigen_tpu_torch.bench.throughput, "
            "seigen_tpu_torch.solver.lane_merged, "
            "seigen_tpu_torch.solver.lane_fused, "
            "seigen_tpu_torch.ops.fused_ops, "
            "seigen_tpu_torch.solver.lane_upwind, "
            "seigen_tpu_torch.solver.rk4, "
            "seigen_tpu_torch.solver.lane_unstructured, "
            "seigen_tpu_torch.mesh.gmsh_io, seigen_tpu_torch.mesh.recover, "
            "seigen_tpu_torch.ops.lane_kernels, "
            "seigen_tpu_torch.ops.merged_kernels, "
            "seigen_tpu_torch.ops.upwind_kernels; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'seigen_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().replace("'", '"')) == []
