"""The CUDA merged operators against their plain versions, on the card.

Every variant of K1 (merged_vel) and K2 (merged_stress) against
vel_merged_ref / stress_merged_ref, and of K3 (upwind_rhs: plain, 1 and 2
source groups, an acoustic vs = 0 half) against upwind_rhs_merged_ref, in
float32 on box_mesh(4, 4, 4) at P2 and P3; every mode of K4 (lane_vel:
SIG, TRAC, SEL) and K5 (lane_stress: TR, SEL) against its plain version on
box_mesh(4, 4, 4) and its scrambled copy at P2 and P3; K6
(lane_upwind_rhs) and every mode of K7 (lane_upwind_axpy: stage, final,
sponge row, 1 and 2 dense groups, panel emission) on scrambled
box_mesh(4, 4, 4) at P2 and P3 and scrambled rect_mesh(8, 8) P2; the
kernel runners (merged LF4, upwind RK4 elastic and viscoelastic, lane LF2,
lane_u LF4 with both select paths, upwind_lane_u with its three steppers
and viscoelastic) against the plain runners for a few steps, with their
launch counts; and the general Hooke law of K2 (plain, axpy, axpy + damp,
1 and 2 source groups) and K5 (TR, SEL) with a per-element non-symmetric
random stiffness on box_mesh(4, 4, 4) P2/P3 and rect_mesh(8, 8) P2, plus
the three runners with a VTI stiffness (``launches_c`` counts); the v2
engine's K8 (fused_vel2: plain, axpy) and K9 (fused_stress2: plain, axpy +
damp, and both with a per-element non-symmetric stiffness) on
box_mesh(4, 4, 4) P2/P3 and rect_mesh(8, 8) P2, K10 (trace_exchange,
tractions and velocities) on those meshes and their periodic twins, and
FusedLaneRunner against its plain runner and the kernel merged runner.
These tests need a CUDA device and nvcc; elsewhere they skip.  On the GPU
machine (which has no JAX, so the suite's conftest is not loaded):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Tolerance: |k - p| <= 2e-4*|p| + 2e-5*max|p| — float32 rounding of the
operator's large terms sets the absolute floor relative to the output's
scale (see chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
from seigen_tpu_torch.ops import (
    Material,
    build_params,
    build_upwind_data,
    build_visco,
)
from seigen_tpu_torch.ops import fused_ops as fo
from seigen_tpu_torch.ops import lane_kernels as lk
from seigen_tpu_torch.ops import lane_upwind_kernels as luk
from seigen_tpu_torch.ops import merged_kernels as mk
from seigen_tpu_torch.ops import upwind_kernels as uk
from seigen_tpu_torch.ops.structured_exchange import detect_structured
from seigen_tpu_torch.solver import lane_fused as lf
from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask
from seigen_tpu_torch.solver.lane_major import LaneMajorRunner
from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner
from seigen_tpu_torch.solver.lane_unstructured import \
    UnstructuredLaneRunner
from seigen_tpu_torch.solver.lane_upwind import UpwindLaneRunner
from seigen_tpu_torch.solver.lane_upwind_u import UnstructuredUpwindRunner
from seigen_tpu_torch.solver.source import PointSource, build_sources
from seigen_tpu_torch.solver.timestep import State

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2e-4, 2e-5
SIDES = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
VARIANTS = ["plain", "axpy", "inject1", "inject2"]


def _assert_close(got, ref):
    bound = RTOL * ref.abs() + ATOL * ref.abs().max()
    assert torch.isfinite(got).all()
    assert bool(((got - ref).abs() <= bound).all()), (
        (got - ref).abs().max().item())


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", params=[2, 3], ids=["P2", "P3"])
def case(request, device):
    ext = ((0.0, 1.0),) * 3
    dm = build_discrete(box_mesh(4, 4, 4), request.param,
                        bc_fn=absorbing_bc_fn(ext, free_sides=[(2, "hi")]))
    p = build_params(dm, Material(1.0, 2.0, 1.0), device=device)
    damp = torch.as_tensor(sponge_mask(dm, SIDES, width=0.3),
                           device=device).float()
    src = build_sources(dm, [PointSource(position=(0.5, 0.5, 0.7), f0=4.0,
                                         radius=0.25)], device=device)
    runner = MergedLaneRunner(p, detect_structured(dm), 0.01, src=src,
                              damp=damp, impl="kernel")
    d, plan = runner.d, runner.plan
    rng = np.random.default_rng(request.param)

    def field(C, used, rows, n):
        a = rng.standard_normal((n, C, rows, plan.Ls)).astype(np.float32)
        a[:, :, used:] = 0.0
        return torch.as_tensor(a.reshape(n, C * rows, plan.Ls),
                               device=device)

    data = {"vel": (field(d.n_sig, d.n_p, d.npp, 1)[0],
                    field(d.dim, d.n_p, d.npp, 4)),
            "stress": (field(d.dim, d.n_p, d.npp, 1)[0],
                       field(d.n_sig, d.n_p, d.npp, 4)),
            "trs": field(d.nf, d.dim * d.n_fp, plan.rtf, 1)[0]}
    return dm, p, src, damp, runner, data


@pytest.mark.parametrize("op", ["vel", "stress"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain(case, op, variant):
    *_, runner, data = case
    x, y = data[op]  # operator input; output-shaped operands
    kw = {}
    if variant == "axpy":
        dt = float(runner.dt)
        kw = dict(axpy=(y[0], y[1]), dt=dt, c3=dt**3 / 24.0)
    elif variant.startswith("inject"):
        kw = dict(inject=[(y[2 + g], (0.7, -1.3)[g])
                          for g in range(int(variant[-1]))])
    fused, plain, kernel = ((mk.vel_merged, mk.vel_merged_ref,
                             mk.VEL_KERNEL) if op == "vel" else
                            (mk.stress_merged, mk.stress_merged_ref,
                             mk.STRESS_KERNEL))
    args = (runner.plan, runner.d, x, data["trs"], runner.mask)
    n0 = kernel.launches
    got = fused(*args, **kw)  # dispatches to the kernel for CUDA tensors
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    for g, r in zip(got, ref):
        _assert_close(g, r)


def test_runner_kernels_match_plain(case, device):
    dm, p, src, damp, runner, _ = case
    plain = MergedLaneRunner(p, runner.ex, 0.01, src=src, damp=damp,
                             impl="reference")
    rng = np.random.default_rng(5)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=torch.as_tensor(rng.standard_normal((E, n_p, 3)),
                                 device=device).float(),
               s=torch.as_tensor(rng.standard_normal((E, n_p, 6)),
                                 device=device).float())
    n_vel, n_stress = mk.VEL_KERNEL.launches, mk.STRESS_KERNEL.launches
    out_k, _ = runner.run(st, 4)
    out_r, _ = plain.run(st, 4)
    assert mk.VEL_KERNEL.launches - n_vel == 12
    assert mk.STRESS_KERNEL.launches - n_stress == 12
    for a, b in ((out_k.u, out_r.u), (out_k.s, out_r.s)):
        assert torch.isfinite(a).all()
        assert ((a - b).norm() / b.norm()).item() < 1e-5


UPWIND_VARIANTS = ["plain", "inject1", "inject2", "acoustic"]


@pytest.fixture(scope="module", params=[2, 3], ids=["P2", "P3"])
def upwind_case(request, device):
    """Upwind kernel runners on box_mesh(4, 4, 4): the bench material, and
    one with vs = 0 where x < 0.5 (the acoustic guard)."""
    ext = ((0.0, 1.0),) * 3
    dm = build_discrete(box_mesh(4, 4, 4), request.param,
                        bc_fn=absorbing_bc_fn(ext, free_sides=[(2, "hi")]))
    vs = np.where(dm.coords.mean(axis=1)[:, 0] < 0.5, 0.0, 1.0)
    runners = {}
    for name, mat in (("elastic", Material(1.0, 2.0, 1.0)),
                      ("acoustic", Material(1.0, 2.0, vs))):
        p = build_params(dm, mat, device=device)
        w = build_upwind_data(dm, mat, device=device)
        runners[name] = UpwindLaneRunner(p, detect_structured(dm), w, 0.01,
                                         impl="kernel")
    d, plan = runners["elastic"].d, runners["elastic"].plan
    rng = np.random.default_rng(10 + request.param)

    def field(C, used, rows):
        a = rng.standard_normal((C, rows, plan.Ls)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * rows, plan.Ls), device=device)

    data = {"u": field(d.dim, d.n_p, d.npp),
            "s": field(d.n_sig, d.n_p, d.npp),
            "trs": field(d.nf, 2 * d.dim * d.n_fp, plan.rtf),
            "inj": [(field(d.dim, d.n_p, d.npp), field(d.n_sig, d.n_p, d.npp),
                     (0.7, -1.3)[g]) for g in range(2)]}
    return dm, runners, data


@pytest.mark.parametrize("variant", UPWIND_VARIANTS)
def test_upwind_kernel_matches_plain(upwind_case, variant):
    _, runners, x = upwind_case
    r = runners["acoustic" if variant == "acoustic" else "elastic"]
    n_inj = int(variant[-1]) if variant.startswith("inject") else 0
    args = (r.plan, r.d, r.uwg, x["u"], x["s"], x["trs"], r.mask)
    n0 = uk.UPWIND_KERNEL.launches
    got = uk.upwind_rhs_merged(*args, inject=x["inj"][:n_inj])
    ref = uk.upwind_rhs_merged_ref(*args, inject=x["inj"][:n_inj])
    torch.cuda.synchronize()
    assert uk.UPWIND_KERNEL.launches == n0 + 1
    for g, r_ in zip(got, ref):  # du, ds, payload traces
        _assert_close(g, r_)


@pytest.mark.parametrize("visco", [False, True], ids=["elastic", "visco"])
def test_upwind_runner_kernel_matches_plain(upwind_case, device, visco):
    """Dense-group injection (elastic) and the scatter path (visco)."""
    dm, runners, _ = upwind_case
    r = runners["elastic"]
    src = build_sources(dm, [PointSource(position=(0.5, 0.5, 0.7), f0=4.0,
                                         radius=0.25)], device=device)
    damp = torch.as_tensor(sponge_mask(dm, SIDES, width=0.3),
                           device=device).float()
    w = build_upwind_data(dm, Material(1.0, 2.0, 1.0), device=device)
    v = build_visco(r.p, 30.0, 20.0, 1.0, 8.0, L=3) if visco else None
    kern, plain = (UpwindLaneRunner(r.p, r.ex, w, 0.01, src=src, damp=damp,
                                    visco=v, impl=impl)
                   for impl in ("kernel", "reference"))
    assert (kern.src_dense is None) == visco
    rng = np.random.default_rng(6)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=torch.as_tensor(rng.standard_normal((E, n_p, 3)),
                                 device=device).float(),
               s=torch.as_tensor(rng.standard_normal((E, n_p, 6)),
                                 device=device).float())
    n0 = uk.UPWIND_KERNEL.launches
    out_k, _ = kern.run(st, 3)
    assert uk.UPWIND_KERNEL.launches - n0 == 12
    out_r, _ = plain.run(st, 3)
    for a, b in ((out_k.u, out_r.u), (out_k.s, out_r.s)):
        assert torch.isfinite(a).all()
        assert ((a - b).norm() / b.norm()).item() < 1e-5


@pytest.fixture(scope="module", params=[2, 3], ids=["P2", "P3"])
def lane_case(request, device):
    """Lane kernel runners on box_mesh(4, 4, 4) (structured, LF2) and on a
    scrambled copy (unstructured, LF4), each with a blob source and a
    sponge, plus numpy-seeded operator inputs."""
    import dataclasses

    ext = ((0.0, 1.0),) * 3
    bc = absorbing_bc_fn(ext, free_sides=[(2, "hi")])
    topo = box_mesh(4, 4, 4)
    perm = np.random.default_rng(0).permutation(topo.num_cells)
    runners = {}
    for name, t in (("lane", topo), ("lane_u", dataclasses.replace(
            topo, cells=topo.cells[perm], structure=None))):
        dm = build_discrete(t, request.param, bc_fn=bc)
        p = build_params(dm, Material(1.0, 2.0, 1.0), device=device)
        kw = dict(
            src=build_sources(dm, [PointSource(position=(0.5, 0.5, 0.7),
                                               f0=4.0, radius=0.25)],
                              device=device),
            damp=torch.as_tensor(sponge_mask(dm, SIDES, width=0.3),
                                 device=device).float())
        if name == "lane":
            runners[name] = (dm, lambda impl, fused, p=p, dm=dm, kw=kw:
                             LaneMajorRunner(p, detect_structured(dm), 0.01,
                                             order=2, impl=impl, **kw))
        else:
            runners[name] = (dm, lambda impl, fused, p=p, dm=dm, kw=kw:
                             UnstructuredLaneRunner(
                                 p, 0.01, order=4, impl=impl,
                                 centroids=dm.coords.mean(axis=1),
                                 fused_select=fused, **kw))
    d = runners["lane"][1]("kernel", True).d
    rng = np.random.default_rng(20 + request.param)

    def rows(C, used, pad):
        a = rng.standard_normal((C, pad, d.E)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * pad, d.E), device=device)

    data = {"sig": rows(d.n_sig, d.n_p, d.npp), "u": rows(d.dim, d.n_p, d.npp),
            "tr_sig": rows(d.n_sig, d.ftp, d.ftpp),
            "tr_u": rows(d.dim, d.ftp, d.ftpp),
            "panels": rows(d.nf, d.dim * d.ftp, (d.dim * d.ftp + 7) // 8 * 8)}
    return runners, data


LANE_MODES = ["SIG", "TRAC", "SEL_vel", "TR", "SEL_stress"]


@pytest.mark.parametrize("mode", LANE_MODES)
def test_lane_kernel_matches_plain(lane_case, mode):
    runners, x = lane_case
    r = runners["lane_u"][1]("kernel", True)
    d = r.d
    _, combo_u, _, cfg_u = r._pg_u
    _, combo_t, sign_t, cfg_t = r._pg_t
    fused, plain, kernel = {
        "SIG": (lk.vel_op_lm, lk.vel_op_lm_ref, lk.LANE_VEL),
        "TRAC": (lk.vel_op_lm_trac, lk.vel_op_lm_trac_ref, lk.LANE_VEL),
        "SEL_vel": (lk.vel_op_lm_trac_sel, lk.vel_op_lm_trac_sel_ref,
                    lk.LANE_VEL),
        "TR": (lk.stress_op_lm, lk.stress_op_lm_ref, lk.LANE_STRESS),
        "SEL_stress": (lk.stress_op_lm_sel, lk.stress_op_lm_sel_ref,
                       lk.LANE_STRESS)}[mode]
    args = {"SIG": (x["sig"], x["tr_sig"]), "TRAC": (x["sig"], x["tr_u"]),
            "SEL_vel": (x["sig"], x["panels"], combo_t, sign_t, cfg_t),
            "TR": (x["u"], x["tr_u"]),
            "SEL_stress": (x["u"], x["panels"], combo_u, cfg_u)}[mode]
    n0 = kernel.launches
    got = fused(d, *args)  # dispatches to the kernel for CUDA tensors
    ref = plain(d, *args)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    _assert_close(got, ref)


@pytest.mark.parametrize("name,fused,per_step", [
    ("lane", True, 1), ("lane_u", True, 3), ("lane_u", False, 3)],
    ids=["lane-LF2", "lane_u-LF4-sel", "lane_u-LF4-trac"])
def test_lane_runner_kernels_match_plain(lane_case, device, name, fused,
                                         per_step):
    runners, _ = lane_case
    dm, make = runners[name]
    kern, plain = make("kernel", fused), make("reference", fused)
    rng = np.random.default_rng(7)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=torch.as_tensor(rng.standard_normal((E, n_p, 3)),
                                 device=device).float(),
               s=torch.as_tensor(rng.standard_normal((E, n_p, 6)),
                                 device=device).float())
    n_vel, n_stress = lk.LANE_VEL.launches, lk.LANE_STRESS.launches
    out_k, _ = kern.run(st, 3)
    assert lk.LANE_VEL.launches - n_vel == 3 * per_step
    assert lk.LANE_STRESS.launches - n_stress == 3 * per_step
    out_r, _ = plain.run(st, 3)
    for a, b in ((out_k.u, out_r.u), (out_k.s, out_r.s)):
        assert torch.isfinite(a).all()
        assert ((a - b).norm() / b.norm()).item() < 1e-5


@pytest.fixture(scope="module", params=[(3, 2), (3, 3), (2, 2)],
                ids=["3d-P2", "3d-P3", "2d-P2"])
def upwind_u_case(request, device):
    """upwind_lane_u kernel runner factory on a scrambled free-top
    box_mesh(4, 4, 4) or rect_mesh(8, 8) with a blob source and a sponge,
    plus numpy-seeded K6/K7 operands (panels in both layouts)."""
    import dataclasses

    dim, degree = request.param
    topo = box_mesh(4, 4, 4) if dim == 3 else rect_mesh(8, 8)
    perm = np.random.default_rng(0).permutation(topo.num_cells)
    dm = build_discrete(
        dataclasses.replace(topo, cells=topo.cells[perm], structure=None),
        degree, bc_fn=absorbing_bc_fn(((0.0, 1.0),) * dim,
                                      free_sides=[(dim - 1, "hi")]))
    mat = Material(1.0, 2.0, 1.0)
    p = build_params(dm, mat, device=device)
    w = build_upwind_data(dm, mat, device=device)
    src = build_sources(dm, [PointSource(position=(0.5, 0.5, 0.7)[:dim],
                                         f0=4.0, radius=0.25)],
                        device=device)
    damp = sponge_mask(dm, [(0, "lo")], width=0.3)

    def make(impl, **opts):
        return UnstructuredUpwindRunner(
            p, w, 0.01, src=src, damp=damp, impl=impl,
            centroids=dm.coords.mean(axis=1), **opts)

    d = make("kernel").d
    rng = np.random.default_rng(30 + degree)

    def rows(C, used, pad):
        a = rng.standard_normal((C, pad, d.E)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * pad, d.E), device=device)

    def state():
        return rows(d.dim, d.n_p, d.npp), rows(d.n_sig, d.n_p, d.npp)

    rows_pad = (d.dim * d.ftp + 7) // 8 * 8
    data = {"x": state(), "base": state(), "acc": state(),
            "S": [state(), state()],
            "p": [rows(d.nf, d.dim * d.ftp, rows_pad) for _ in range(2)],
            "p_e": [rows(d.nf * d.dim, d.ftp, d.ftpp) for _ in range(2)]}
    return dm, p, make, data


UPWIND_U_MODES = {  # mode -> None (K6) or K7's (stage, damp, groups, emit)
    "rhs": None, "stage": (True, False, 0, False),
    "final": (False, False, 0, False), "final_damp": (False, True, 0, False),
    "stage_inject1": (True, False, 1, False),
    "final_damp_inject2": (False, True, 2, False),
    "stage_emit": (True, False, 0, True),
    "final_damp_emit": (False, True, 0, True)}


@pytest.mark.parametrize("mode", list(UPWIND_U_MODES))
def test_lane_upwind_kernel_matches_plain(upwind_u_case, mode):
    *_, make, x = upwind_u_case
    r = make("kernel")
    d = r.d
    spec = UPWIND_U_MODES[mode]
    emit = spec is not None and spec[3]
    args = (d, r.uw, *x["x"], *(x["p_e"] if emit else x["p"]), r.combo,
            r.sign_u, r.sign_t,
            luk.emitted_selcfg(r.selcfg) if emit else r.selcfg)
    if spec is None:
        fused, plain, kernel, kw = (luk.upwind_rhs_lm_sel,
                                    luk.upwind_rhs_lm_sel_ref,
                                    luk.LANE_UPWIND_RHS, {})
    else:
        stage, damp, n_inj, _ = spec
        fused, plain, kernel = (luk.upwind_rhs_lm_sel_axpy,
                                luk.upwind_rhs_lm_sel_axpy_ref,
                                luk.LANE_UPWIND_AXPY)
        args += (*x["acc"], 0.21)
        kw = dict(base_u=x["base"][0] if stage else None,
                  base_s=x["base"][1] if stage else None,
                  cs=0.37 if stage else None,
                  inject=[(*x["S"][g], (0.7, -1.3)[g])
                          for g in range(n_inj)],
                  damp_row=r.damp_u[: d.npp] if damp else None, emit=emit)
    n0 = kernel.launches
    got = fused(*args, **kw)  # dispatches to the kernel for CUDA tensors
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    _assert_close(got, ref)


@pytest.mark.parametrize("name,opts,axpy", [
    ("fused", {}, True), ("emit", {"panel_emit": True}, True),
    ("glue", {"fused_axpy": False}, False), ("visco", {}, False)])
def test_upwind_u_runner_kernels_match_plain(upwind_u_case, device, name,
                                             opts, axpy):
    dm, p, make, _ = upwind_u_case
    if name == "visco":
        opts = {"visco": build_visco(p, 30.0, 20.0, 1.0, 8.0, L=3)}
    kern, plain = make("kernel", **opts), make("reference", **opts)
    assert kern.fused_axpy == axpy
    rng = np.random.default_rng(9)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=torch.as_tensor(rng.standard_normal((E, n_p, p.dim)),
                                 device=device).float(),
               s=torch.as_tensor(rng.standard_normal((E, n_p, p.n_sig)),
                                 device=device).float())
    n6, n7 = luk.LANE_UPWIND_RHS.launches, luk.LANE_UPWIND_AXPY.launches
    out_k, _ = kern.run(st, 3)
    assert luk.LANE_UPWIND_AXPY.launches - n7 == (12 if axpy else 0)
    assert luk.LANE_UPWIND_RHS.launches - n6 == (0 if axpy else 12)
    out_r, _ = plain.run(st, 3)
    for a, b in ((out_k.u, out_r.u), (out_k.s, out_r.s)):
        assert torch.isfinite(a).all()
        assert ((a - b).norm() / b.norm()).item() < 1e-5


# --- the general Hooke law (per-element Voigt stiffness) of K2 and K5 ---


def _random_stiffness(E, n_sig, seed):
    """Per-element NON-symmetric matrices: a C[c, k] / C[k, c] swap or a
    transposed strain index hides behind a symmetric one."""
    return np.random.default_rng(seed).standard_normal((E, n_sig, n_sig))


@pytest.fixture(scope="module", params=[(3, 2), (3, 3), (2, 2)],
                ids=["3d-P2", "3d-P3", "2d-P2"])
def aniso_case(request, device):
    """Structured and scrambled copies of box_mesh(4, 4, 4) or
    rect_mesh(8, 8) with a blob source and a sponge, and runner factories
    taking a stiffness."""
    import dataclasses

    dim, degree = request.param
    topo = box_mesh(4, 4, 4) if dim == 3 else rect_mesh(8, 8)
    perm = np.random.default_rng(0).permutation(topo.num_cells)
    bc = absorbing_bc_fn(((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")])
    out = {}
    for name, t in (("structured", topo), ("scrambled", dataclasses.replace(
            topo, cells=topo.cells[perm], structure=None))):
        dm = build_discrete(t, degree, bc_fn=bc)
        p = build_params(dm, Material(1.0, 2.0, 1.0), device=device)
        kw = dict(
            src=build_sources(dm, [PointSource(
                position=(0.5, 0.5, 0.7)[:dim], f0=4.0, radius=0.25)],
                device=device),
            damp=torch.as_tensor(sponge_mask(dm, [(0, "lo"), (0, "hi")],
                                             width=0.3),
                                 device=device).float())
        out[name] = (dm, p, kw)
    return out


@pytest.mark.parametrize("variant", ["plain", "axpy", "axpy_damp", "inject1",
                                     "inject2"])
def test_merged_stress_kernel_with_stiffness_matches_plain(aniso_case,
                                                           variant):
    import dataclasses

    dm, p, kw = aniso_case["structured"]
    C = _random_stiffness(dm.num_elements, p.n_sig, 40)
    runner = MergedLaneRunner(p, detect_structured(dm), 0.01, impl="kernel",
                              stiffness=C, **kw)
    d, plan = runner.d, runner.plan
    assert d.off[6] >= 0
    if variant == "axpy":
        d = dataclasses.replace(d, damp=None)
    rng = np.random.default_rng(41)

    def field(Cn, used, rows):
        a = rng.standard_normal((Cn, rows, plan.Ls)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(Cn * rows, plan.Ls), device=p.device)

    u = field(d.dim, d.n_p, d.npp)
    y = [field(d.n_sig, d.n_p, d.npp) for _ in range(2)]
    trs = field(d.nf, d.dim * d.n_fp, plan.rtf)
    okw = {}
    if variant.startswith("axpy"):
        okw = dict(axpy=(y[0], y[1]), dt=0.01, c3=0.01**3 / 24.0)
    elif variant.startswith("inject"):
        okw = dict(inject=[(y[g], (0.7, -1.3)[g])
                           for g in range(int(variant[-1]))])
    args = (plan, d, u, trs, runner.mask)
    n0, c0 = mk.STRESS_KERNEL.launches, mk.STRESS_KERNEL.launches_c
    got = mk.stress_merged(*args, **okw)
    ref = mk.stress_merged_ref(*args, **okw)
    torch.cuda.synchronize()
    assert mk.STRESS_KERNEL.launches == n0 + 1
    assert mk.STRESS_KERNEL.launches_c == c0 + 1
    for g, r in zip(got, ref):
        _assert_close(g, r)


@pytest.mark.parametrize("mesh", ["structured", "scrambled"])
@pytest.mark.parametrize("mode", ["TR", "SEL"])
def test_lane_stress_kernel_with_cmat_matches_plain(aniso_case, mesh, mode):
    dm, p, kw = aniso_case[mesh]
    C = _random_stiffness(dm.num_elements, p.n_sig, 42)
    r = UnstructuredLaneRunner(p, 0.01, impl="kernel", stiffness=C,
                               centroids=dm.coords.mean(axis=1), **kw)
    d = r.d
    _, combo_u, _, cfg_u = r._pg_u
    rng = np.random.default_rng(43)

    def rows(Cn, used, pad):
        a = rng.standard_normal((Cn, pad, d.E)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(Cn * pad, d.E), device=p.device)

    u = rows(d.dim, d.n_p, d.npp)
    if mode == "TR":
        fused, plain = lk.stress_op_lm, lk.stress_op_lm_ref
        args = (d, u, rows(d.dim, d.ftp, d.ftpp))
    else:
        fused, plain = lk.stress_op_lm_sel, lk.stress_op_lm_sel_ref
        args = (d, u, rows(d.nf, d.dim * d.ftp, cfg_u[5]), combo_u, cfg_u)
    n0, c0 = lk.LANE_STRESS.launches, lk.LANE_STRESS.launches_c
    got = fused(*args, cmat=r.cmat)
    ref = plain(*args, cmat=r.cmat)
    iso = fused(*args)
    torch.cuda.synchronize()
    assert lk.LANE_STRESS.launches == n0 + 2
    assert lk.LANE_STRESS.launches_c == c0 + 1
    _assert_close(got, ref)
    assert not torch.allclose(got, iso)


@pytest.mark.parametrize("name", ["merged", "lane-LF4", "lane-LF2",
                                  "lane_u-sel", "lane_u-trac"])
def test_runner_kernels_with_stiffness_match_plain(aniso_case, device, name):
    from seigen_tpu_torch.ops.anisotropic import vti_stiffness

    dm, p, kw = aniso_case["scrambled" if name.startswith("lane_u")
                           else "structured"]
    if p.dim == 2:
        pytest.skip("the VTI stiffness is a 3D matrix")
    E, n_p = dm.num_elements, dm.re.n_p
    C = vti_stiffness(2.0, 1.0, 1.0,
                      epsilon=np.random.default_rng(1).uniform(0.05, 0.25, E),
                      delta=0.05, gamma=0.1)
    order = 2 if name.endswith("LF2") else 4

    def make(impl):
        if name == "merged":
            return MergedLaneRunner(p, detect_structured(dm), 0.005,
                                    impl=impl, stiffness=C, **kw)
        if name.startswith("lane-"):
            return LaneMajorRunner(p, detect_structured(dm), 0.005,
                                   order=order, impl=impl, stiffness=C, **kw)
        return UnstructuredLaneRunner(
            p, 0.005, impl=impl, stiffness=C,
            centroids=dm.coords.mean(axis=1),
            fused_select=name.endswith("sel"), **kw)

    rng = np.random.default_rng(7)
    st = State(u=torch.as_tensor(rng.standard_normal((E, n_p, 3)),
                                 device=device).float(),
               s=torch.as_tensor(rng.standard_normal((E, n_p, 6)),
                                 device=device).float())
    kernel = mk.STRESS_KERNEL if name == "merged" else lk.LANE_STRESS
    n0, c0 = kernel.launches, kernel.launches_c
    out_k, _ = make("kernel").run(st, 3)
    per_step = 1 if order == 2 else 3
    assert kernel.launches - n0 == 3 * per_step
    assert kernel.launches_c - c0 == 3 * per_step
    out_r, _ = make("reference").run(st, 3)
    for a, b in ((out_k.u, out_r.u), (out_k.s, out_r.s)):
        assert torch.isfinite(a).all()
        assert ((a - b).norm() / b.norm()).item() < 1e-5


@pytest.fixture(scope="module", params=[(3, 2), (3, 3), (2, 2)],
                ids=["3D-P2", "3D-P3", "2D-P2"])
def fused_case(request, device):
    """Free-top, sponge-damped box_mesh(4, 4, 4) (3D) or rect_mesh(8, 8)
    (2D) with a blob source, and the same mesh periodic."""
    dim, degree = request.param
    topo = box_mesh(4, 4, 4) if dim == 3 else rect_mesh(8, 8)
    dm = build_discrete(topo, degree, bc_fn=absorbing_bc_fn(
        ((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")]))
    p = build_params(dm, Material(1.0, 2.0, 1.0), device=device)
    kw = dict(
        damp=torch.as_tensor(sponge_mask(dm, [(0, "lo"), (0, "hi")],
                                         width=0.3), device=device).float(),
        src=build_sources(dm, [PointSource(
            position=(0.5,) * (dim - 1) + (0.7,), f0=4.0, radius=0.25)],
            device=device))
    per = (box_mesh(4, 4, 4, periodic=(0, 1, 2)) if dim == 3
           else rect_mesh(8, 8, periodic=(0, 1)))
    dm_per = build_discrete(per, degree)
    p_per = build_params(dm_per, Material(1.0, 2.0, 1.0), device=device)
    return dm, p, kw, dm_per, p_per


def _rows(rng, d, C, used, pad, device):
    a = rng.standard_normal((C, pad, d.E)).astype(np.float32)
    a[:, used:] = 0.0
    return torch.as_tensor(a.reshape(C * pad, d.E), device=device)


@pytest.mark.parametrize("op,variant", [
    ("vel", "plain"), ("vel", "axpy"), ("stress", "plain"),
    ("stress", "axpy_damp"), ("stress", "C"), ("stress", "C_axpy_damp")])
def test_fused_operator_kernels_match_plain(fused_case, device, op, variant):
    dm, p, kw, _, _ = fused_case
    C = (_random_stiffness(dm.num_elements, p.n_sig, 50)
         if variant.startswith("C") else None)
    d = lf.FusedLaneRunner(p, detect_structured(dm), 0.01, impl="kernel",
                           stiffness=C, **kw).d
    rng = np.random.default_rng(51)
    c_in, c_out = (d.n_sig, d.dim) if op == "vel" else (d.dim, d.n_sig)
    x = _rows(rng, d, c_in, d.n_p, d.npp, device)
    tr = _rows(rng, d, d.dim, d.ftp, d.ftpp, device)
    okw = {}
    if "axpy" in variant:
        okw = dict(axpy=tuple(_rows(rng, d, c_out, d.n_p, d.npp, device)
                              for _ in range(2)), dt=0.01, c3=0.01**3 / 24)
    fused, plain, kernel = ((fo.vel2_op, fo.vel2_op_ref, fo.VEL2_KERNEL)
                            if op == "vel" else
                            (fo.stress2_op, fo.stress2_op_ref,
                             fo.STRESS2_KERNEL))
    n0, c0 = kernel.launches, kernel.launches_c
    got = fused(d, x, tr, **okw)
    ref = plain(d, x, tr, **okw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    assert kernel.launches_c == c0 + int(C is not None)
    for g, r in zip(got, ref):
        _assert_close(g, r)


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["bounded", "periodic"])
@pytest.mark.parametrize("negate", [True, False])
def test_trace_exchange_kernel_matches_plain(fused_case, device, periodic,
                                             negate):
    dm, p, _, dm_per, p_per = fused_case
    if periodic:
        dm, p = dm_per, p_per
    r = lf.FusedLaneRunner(p, detect_structured(dm), 0.01, impl="kernel")
    d, xp = r.d, r.xplan
    tr = _rows(np.random.default_rng(52), d, d.dim, d.ftp, d.ftpp, device)
    n0 = lf.TRACE_EXCHANGE.launches
    got = lf.TRACE_EXCHANGE(xp, tr, negate)
    ref = lf.trace_exchange_ref(xp, tr, negate)
    torch.cuda.synchronize()
    assert lf.TRACE_EXCHANGE.launches == n0 + 1
    assert torch.equal(got, ref)  # a permutation: exact


@pytest.mark.parametrize("stiffness", [False, True], ids=["iso", "C"])
def test_fused_runner_kernels_match_plain(fused_case, device, stiffness):
    dm, p, kw, _, _ = fused_case
    E, n_p = dm.num_elements, dm.re.n_p
    C = _random_stiffness(E, p.n_sig, 53) * 0.1 if stiffness else None
    if stiffness:  # stable: the isotropic law plus a small perturbation
        from seigen_tpu_torch.ops.anisotropic import iso_stiffness

        C = C + iso_stiffness(2.0, 1.0, p.dim)[None]
    rng = np.random.default_rng(7)
    st = State(u=torch.as_tensor(rng.standard_normal((E, n_p, p.dim)),
                                 device=device).float(),
               s=torch.as_tensor(rng.standard_normal((E, n_p, p.n_sig)),
                                 device=device).float())
    ex = detect_structured(dm)
    counts = [fo.VEL2_KERNEL, fo.STRESS2_KERNEL, lf.TRACE_EXCHANGE,
              mk.VEL_KERNEL, mk.STRESS_KERNEL]
    n0 = [k.launches for k in counts]
    c0 = fo.STRESS2_KERNEL.launches_c
    out_k, _ = lf.FusedLaneRunner(p, ex, 0.005, impl="kernel", stiffness=C,
                                  **kw).run(st, 3)
    assert [k.launches - n for k, n in zip(counts, n0)] == [9, 9, 18, 0, 0]
    assert fo.STRESS2_KERNEL.launches_c - c0 == (9 if stiffness else 0)
    out_r, _ = lf.FusedLaneRunner(p, ex, 0.005, impl="reference",
                                  stiffness=C, **kw).run(st, 3)
    out_m, _ = MergedLaneRunner(p, ex, 0.005, impl="kernel", stiffness=C,
                                **kw).run(st, 3)
    for ref in (out_r, out_m):
        for a, b in ((out_k.u, ref.u), (out_k.s, ref.s)):
            assert torch.isfinite(a).all()
            assert ((a - b).norm() / b.norm()).item() < 1e-5
