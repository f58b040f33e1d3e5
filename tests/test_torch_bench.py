"""The port's throughput bench on the CPU, and the port's import guard.

``setup_case`` must build the JAX bench's case (same mesh, parameters,
source, sponge, dt; with ``scramble=True`` the same cell permutation);
``measure`` runs end to end on the CPU through the plain operator versions,
for the lane runners at LF2 and LF4, the v2 runner (LF4 only) and the
packed P1 merged runner too, and with ``vti=True`` through the general
Hooke law (the upwind impls refuse it); ``main`` refuses to measure
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


def test_measure_merged_pk_on_cpu(cases):
    """impl "merged_pk" forces the packed P1 layout (plain "merged" stays
    unpacked); it runs the bench's P1 case to the unpacked runner's state,
    and refuses P2 and the VTI stiffness."""
    dm, p, src, damp, dt, st = tbench.setup_case(
        n=2, degree=1, dtype=torch.float64, device="cpu")
    pk = tbench.make_runner("merged_pk", dm, p, src, damp, dt, "reference")
    un = tbench.make_runner("merged", dm, p, src, damp, dt, "reference")
    assert (pk.n_par, pk.plan.n_par, un.n_par) == (2, 2, 1)
    assert pk.plan.Ls * 2 == un.plan.Ls == dm.num_elements
    out_pk, out_un = pk.run(st, 2)[0], un.run(st, 2)[0]
    assert out_un.u.abs().max() > 0
    for a, b in ((out_pk.u, out_un.u), (out_pk.s, out_un.s)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-14)
    res = tbench.measure(p, src, damp, dt, st, dm, n_steps=2,
                         impl="merged_pk", kernel_impl="reference")
    assert res.n_dof == dm.num_elements * dm.re.n_p * 9
    assert np.isfinite(res.dof_updates_per_sec) and res.seconds > 0
    with pytest.raises(ValueError, match="P1"):
        tbench.make_runner("merged_pk", *cases[1][:5], "reference")
    with pytest.raises(ValueError, match="vti"):
        tbench.make_runner("merged_pk", dm, p, src, damp, dt, "reference",
                           vti=True)


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
        "void (anonymous namespace)::upwind_tile_kernel<3, 20, 10>"
        "(UpwindArgs)": "upwind_rhs",
        "void (anonymous namespace)::lane_upwind_tile_kernel<3, 20, 10, "
        "true>(LaneUpwindArgs)": "lane_upwind_axpy",
        "void (anonymous namespace)::lane_upwind_tile_kernel<3, 20, 10, "
        "false>(LaneUpwindArgs)": "lane_upwind_rhs",
        "void (anonymous namespace)::lane_stress_tile_kernel<3, 20, 10, "
        "false>(LaneArgs)": "lane_stress",
        "void (anonymous namespace)::lane_stress_tile_kernel<2, 6, 3, "
        "true>(LaneArgs)": "lane_stress",
        "void (anonymous namespace)::lane_vel_tile_kernel<3, 20, 10, "
        "false>(LaneArgs)": "lane_vel",
        "void (anonymous namespace)::lane_vel_tile_kernel<2, 6, 3, true>"
        "(LaneArgs)": "lane_vel",
        "void (anonymous namespace)::merged_tile_kernel<3, 20, 10, true, "
        "false, true>(MergedArgs)": "fused_vel2",
        "void (anonymous namespace)::merged_tile_kernel<3, 20, 10, true, "
        "false, false>(MergedArgs)": "merged_vel",
        "void (anonymous namespace)::merged_tile_kernel<3, 20, 10, false, "
        "false, false>(MergedArgs)": "merged_stress",
        "void (anonymous namespace)::merged_tile_kernel<2, 6, 3, false, "
        "true, false>(MergedArgs)": "merged_stress",
        "void (anonymous namespace)::merged_tile_kernel<3, 20, 10, false, "
        "false, true>(MergedArgs)": "fused_stress2",
        "void (anonymous namespace)::merged_tile_kernel<2, 6, 3, false, "
        "true, true>(MergedArgs)": "fused_stress2",
        "void (anonymous namespace)::merged_tile_pk_kernel<3, 4, 3, true, "
        "false>(MergedArgs)": "merged_vel[pk]",
        "void (anonymous namespace)::merged_tile_pk_kernel<3, 4, 3, false, "
        "false>(MergedArgs)": "merged_stress[pk]",
        "void (anonymous namespace)::merged_tile_pk_kernel<2, 3, 2, false, "
        "true>(MergedArgs)": "fused_stress2[pk]",
        "void (anonymous namespace)::merged_tile_pk_kernel<3, 4, 3, true, "
        "true>(MergedArgs)": "fused_vel2[pk]",
        "void (anonymous namespace)::merged_tile_pk_kernel<2, 3, 2, true, "
        "true>(MergedArgs)": "fused_vel2[pk]",
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


def test_merged_ab_family_tables():
    """bench/merged_ab.py's tables: each family times its kernel variants
    once each (fused: K9 plain, axpy, axpy + damp, K9-C, K8; upwind: K6
    among K3/K7; lane: every K5 mode of both Hooke laws and every K4
    mode; packed: every K1pk variant, K9pk plain, axpy and axpy + damp,
    K8pk plain and axpy and K11, with K2pk plain and axpy + damp and the
    unpacked K1 as controls), and each bench's label is the throughput
    command line of its impl and options; the first turn profiles the
    upwind steps, the fused one, lane LF2 and lane_u, and merged_pk."""
    import argparse

    from seigen_tpu_torch.bench import merged_ab as ab

    assert set(ab.FAMILIES) == set(ab.STEPS) == {"merged", "upwind",
                                                  "fused", "lane", "packed"}
    for variants in ab.FAMILIES.values():
        assert len(set(variants)) == len(variants)
    assert ab.FAMILIES["fused"] == (
        ("fused_stress2", "plain"), ("fused_stress2", "axpy"),
        ("fused_stress2", "axpy_damp"), ("fused_stress2[C]", "plain"),
        ("fused_stress2[C]", "axpy_damp"), ("fused_vel2", "plain"),
        ("fused_vel2", "axpy"))
    assert ("lane_upwind_rhs", "rhs") in ab.FAMILIES["upwind"]
    assert {v for k, v in ab.FAMILIES["lane"] if k.startswith(
        "lane_stress")} == {"TR", "SEL"}
    assert {k for k, _ in ab.FAMILIES["lane"]} == {
        "lane_stress", "lane_stress[C]", "lane_vel"}
    assert ab.FAMILIES["packed"] == (
        ("merged_vel[pk]", "plain"), ("merged_vel[pk]", "axpy"),
        ("merged_vel[pk]", "inject1"), ("merged_vel[pk]", "inject2"),
        ("fused_stress2[pk]", "plain"), ("fused_stress2[pk]", "axpy"),
        ("fused_stress2[pk]", "axpy_damp"), ("fused_vel2[pk]", "plain"),
        ("fused_vel2[pk]", "axpy"), ("p1_pack_vel", "plain"),
        ("merged_stress[pk]", "plain"), ("merged_stress[pk]", "axpy_damp"),
        ("merged_vel", "plain"))
    ap = argparse.ArgumentParser()
    tbench.add_vti_argument(ap)
    tbench.add_upwind_u_arguments(ap)
    ap.add_argument("--order", type=int, default=4)
    for steps in ab.STEPS.values():
        for label, impl, opts, _ in steps:
            first, *flags = label.split()
            a = ap.parse_args(flags)
            assert first == impl and impl in tbench.IMPLS
            assert opts == ({"vti": True} if a.vti else {}) | (
                {"order": a.order} if a.order != 4 else {}) | \
                tbench.upwind_u_options(a)
    profiled = {fam: [label for label, *_, prof in steps if prof]
                for fam, steps in ab.STEPS.items()}
    assert profiled == {
        "merged": [], "fused": ["fused"],
        "upwind": ["upwind_lane", "upwind_lane_u",
                   "upwind_lane_u --panel-emit",
                   "upwind_lane_u --no-fused-axpy"],
        "lane": ["lane --order 2", "lane_u"], "packed": ["merged_pk"]}


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
            "seigen_tpu_torch.ops.upwind_kernels, "
            "seigen_tpu_torch.bench.merged_ab, "
            "seigen_tpu_torch.bench.ptxas_ab; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'seigen_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().replace("'", '"')) == []


def test_chip_smoke_bound_rows_at_3d_p3():
    """chip_smoke.py's compulsory rows per lane of every K1/K2 variant at
    3D P3 (the main path's element; the rows do not depend on the mesh's
    size): the input's live rows, the neighbour traces, the geo rows and
    the variant's axpy (C_out x n_p each), damping (n_p) and source
    (C_out x n_p a group) rows, plus the outputs."""
    import importlib.util

    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dm = build_discrete(box_mesh(2, 2, 2), 3)
    p = build_params(dm, Material(1.0, 2.0, 1.0), device="cpu")
    r = MergedLaneRunner(p, detect_structured(dm), 0.01, impl="reference")
    rows = {(k, v): smoke.bound_rows(r.d, r.plan, k, variant=v)
            for k, vs in (("merged_vel", ("plain", "axpy", "inject1",
                                          "inject2")),
                          ("merged_stress", ("plain", "axpy", "axpy_damp",
                                             "inject1", "inject2")))
            for v in vs}
    assert rows == {
        ("merged_vel", "plain"): 474, ("merged_vel", "axpy"): 594,
        ("merged_vel", "inject1"): 534, ("merged_vel", "inject2"): 594,
        ("merged_stress", "plain"): 487, ("merged_stress", "axpy"): 727,
        ("merged_stress", "axpy_damp"): 747,
        ("merged_stress", "inject1"): 607,
        ("merged_stress", "inject2"): 727}
    assert smoke.bound_rows(r.d, r.plan, "merged_stress", aniso=True) == 521


def test_chip_smoke_upwind_bound_rows_at_3d_p3():
    """chip_smoke.py's compulsory rows per lane at 3D P3 of every K3
    variant (``bound_rows``: u and sigma's live rows, the payload of every
    face, 46 geo/impedance/ghost rows, the mask, a group's C x n_p source
    rows, and du, ds and the payload traces written) and of K6 and every
    K7 mode (``upwind_u_rows``: the state and the mode's accumulator, base,
    sponge and source rows, both panels' selected rows, 50 geometry rows,
    the output and the emitted panels)."""
    import importlib.util

    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.ops import Material, build_params, \
        build_upwind_data
    from seigen_tpu_torch.ops.lane_kernels import build_lane_data
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.lane_upwind import UpwindLaneRunner

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dm = build_discrete(box_mesh(2, 2, 2), 3)
    mat = Material(1.0, 2.0, 1.0)
    p = build_params(dm, mat, device="cpu")
    r = UpwindLaneRunner(p, detect_structured(dm),
                         build_upwind_data(dm, mat, device="cpu"), 0.01,
                         impl="reference")
    assert {v: smoke.bound_rows(r.d, r.plan, "upwind_rhs", variant=v)
            for v in ("plain", "inject1", "inject2")} == {
        "plain": 942, "inject1": 1122, "inject2": 1302}
    d = build_lane_data(p)
    assert {m: smoke.upwind_u_rows(d, m) for m in smoke.UPWIND_U_MODES} == {
        "rhs": 686, "stage": 1262, "final": 866, "final damp": 886,
        "stage inject1": 1442, "final damp inject2": 1246,
        "stage emit": 1502, "final damp emit": 1126}


def test_chip_smoke_fused_rows_at_3d_p3():
    """chip_smoke.py's compulsory rows per lane at 3D P3 of every K8/K9
    variant (``fused_rows``: the input's live rows, the dim*ftp exchanged
    trace rows, 29 geometry rows and the material rows, the variant's axpy
    (2 x C_out x n_p) and sponge (n_p) rows, the output and its traces)
    and of K10."""
    import importlib.util

    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.lane_fused import FusedLaneRunner

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dm = build_discrete(box_mesh(2, 2, 2), 3)
    p = build_params(dm, Material(1.0, 2.0, 1.0), device="cpu")
    d = FusedLaneRunner(p, detect_structured(dm), 0.01,
                        impl="reference").d
    rows = {(k, v, c): smoke.fused_rows(d, k, aniso=c, variant=v)
            for k, vs, cs in (("fused_vel2", ("plain", "axpy"), (False,)),
                              ("fused_stress2", ("plain", "axpy",
                                                 "axpy_damp"),
                               (False, True)))
            for v in vs for c in cs}
    assert rows == {
        ("fused_vel2", "plain", False): 462,
        ("fused_vel2", "axpy", False): 582,
        ("fused_stress2", "plain", False): 475,
        ("fused_stress2", "axpy", False): 715,
        ("fused_stress2", "axpy_damp", False): 735,
        ("fused_stress2", "plain", True): 509,
        ("fused_stress2", "axpy", True): 749,
        ("fused_stress2", "axpy_damp", True): 769}
    assert smoke.fused_rows(d, "trace_exchange") == 244


def test_ptxas_report_entries():
    """bench/ptxas_ab.py reads ptxas's -v report: per entry function its
    registers, stack frame, spill stores and spill loads; an entry without
    its properties line is left out."""
    from seigen_tpu_torch.bench.ptxas_ab import report_entries

    text = "\n".join([
        "ptxas info    : Compiling entry function '_Z1aILi3EEv8LaneArgs' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _Z1aILi3EEv8LaneArgs",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers, used 1 barriers, 560 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1bv",
        "    480 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads",
        "ptxas info    : Used 56 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_Z1cv' for 'sm_90a'",
        "ptxas info    : Used 12 registers"])
    assert report_entries(text) == {"_Z1aILi3EEv8LaneArgs": [48, 0, 0, 0],
                                    "_Z1bv": [56, 480, 8, 4]}


def test_chip_smoke_ptxas_tables_name_the_tile_kernels():
    """chip_smoke.py checks a ptxas line for every tile instantiation: K4
    in both layouts (TRAC/SEL, and SIG with the sigma trace rows) and K8
    among them, and the packed tile kernel's K1pk, K2pk, K8pk (K11's
    kernel at 3D P1) and K9pk at 2D and 3D P1, one for each packed
    mode."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tile = smoke.TILE_PTXAS
    assert tile["lane_vel"] == ("lane", "lane_vel_tile_kernel", "Lb0EE")
    assert tile["lane_vel[SIG]"] == ("lane", "lane_vel_tile_kernel",
                                     "Lb1EE")
    assert tile["fused_vel2"] == ("merged", "merged_tile_kernel",
                                  "Lb1ELb0ELb1EE")
    assert len({v for v in tile.values()}) == len(tile)
    assert {k for k, _ in smoke.KERNELS.items()} <= {
        k.split("[")[0] for k in tile} | {"trace_exchange", "p1_pack_vel"}
    assert smoke.PACKED_TILE_PTXAS == {
        f"{label} {dim}D P1": ("merged", f"merged_tile_pk_kernelILi{dim}E"
                               f"Li{dim + 1}ELi{dim}E{vel_v2}")
        for label, vel_v2 in (("merged_vel[pk]", "Lb1ELb0EE"),
                              ("merged_stress[pk]", "Lb0ELb0EE"),
                              ("fused_vel2[pk]", "Lb1ELb1EE"),
                              ("fused_stress2[pk]", "Lb0ELb1EE"))
        for dim in (2, 3)}
    assert {label.split()[0] for label in smoke.PACKED_TILE_PTXAS} == set(
        smoke.PACKED_MODES)
