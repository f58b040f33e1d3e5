"""The energy-conjugation gradient engines (solver/lane_diff.py) on the CPU,
f64, through the kernels' plain versions.

1. ``torch.autograd.gradcheck`` passes on A and B' of every engine (lane,
   merged, packed merged, lane_u; the vti engine runs lane's): the
   conjugated backward IS the transpose, boundary rows included.
2. Every engine's value and gradient match the port's einsum gradient
   (solver/adjoint.py make_fwi_gradient; itself held to JAX's in
   test_torch_adjoint.py): lane at LF2 and LF4 (also in checkpointed
   segments), merged, lane_u and packed merged at P1 on rect_mesh(4, 4),
   and aniso="vti" on box_mesh(2, 2, 2) P1 against autograd through the
   einsum anisotropic stress operator, theta carrying Thomsen parameters.
3. The source-wavelet and moment-tensor gradients pass finite differences;
   the joint mode returns vg_factory's material gradient.
4. ``illumination`` equals the einsum loop's (solver/imaging.py).

Tolerance: rtol 1e-10, atol 1e-12 * max|ref| (the engines and the einsum
path re-associate f64 sums).
"""

import numpy as np
import pytest
import torch

from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
from seigen_tpu_torch.ops import Material, build_params
from seigen_tpu_torch.ops.anisotropic import make_aniso_stress_op, \
    vti_stiffness_torch
from seigen_tpu_torch.ops.structured_exchange import detect_structured
from seigen_tpu_torch.solver import PointSource, State, absorbing_bc_fn, \
    build_receivers, build_sources, cfl_dt, line, sponge_mask
from seigen_tpu_torch.solver.adjoint import make_fwi_gradient, \
    run_segmented, value_and_grad, with_material
from seigen_tpu_torch.solver.imaging import source_illumination
from seigen_tpu_torch.solver.lane_diff import LaneDiffFwi
from seigen_tpu_torch.solver.shots import stack_shots

F64 = torch.float64
RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tiny CPU operators gain nothing from intra-op threads, and
    several pytest workers' thread pools fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, err_msg=""):
    got, ref = (x.detach().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in (got, ref))
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=1e-12 * np.abs(ref).max(),
                               err_msg=err_msg)


def make_case(dim, n, degree, seed, f0=10.0, t0=0.04, sponge=True):
    rng = np.random.default_rng(seed)
    dm = build_discrete(
        rect_mesh(n, n) if dim == 2 else box_mesh(n, n, n), degree,
        bc_fn=absorbing_bc_fn(((0.0, 1.0),) * dim,
                              free_sides=[(dim - 1, "hi")]))
    E = dm.num_elements
    mat = dict(rho=1.0 + rng.random(E), vp=2.0 + rng.random(E),
               vs=0.8 + 0.3 * rng.random(E))
    p = build_params(dm, Material(**mat), dtype=F64, device="cpu")
    pos = (0.45, 0.6) if dim == 2 else (0.45, 0.5, 0.6)
    src = build_sources(dm, [PointSource(
        position=pos, f0=f0, t0=t0, amplitude=100.0,
        radius=2.5 * float(dm.h.max()))], dtype=F64, device="cpu")
    a, b = ((0.2, 0.85), (0.8, 0.85)) if dim == 2 else \
        ((0.2, 0.5, 0.85), (0.8, 0.5, 0.85))
    rcv = build_receivers(dm, line(a, b, 3), dtype=F64, device="cpu")
    damp = (torch.as_tensor(sponge_mask(dm, [(0, "lo"), (0, "hi"),
                                             (1, "lo")], width=0.25),
                            dtype=F64) if sponge else None)
    n_p, n_sig = dm.re.n_p, 3 * (dim - 1)
    st = State(u=torch.zeros(E, n_p, dim, dtype=F64),
               s=torch.zeros(E, n_p, n_sig, dtype=F64))
    dt = cfl_dt(float(dm.h.min()), 3.5, degree, 0.25)
    return dict(dm=dm, p=p, ex=detect_structured(dm), src=src, rcv=rcv,
                damp=damp, st=st, dt=dt, mat=mat)


def engine(c, n_steps, **kw):
    return LaneDiffFwi(c["p"], c["dm"], c["ex"], c["dt"], n_steps,
                       stack_shots([c["src"]]), c["rcv"], None,
                       damp=c["damp"], **kw)


ENGINES = {"lane": {}, "merged": {"engine": "merged"},
           "merged_pk": {"engine": "merged", "packed": True},
           "lane_u": {"engine": "lane_u"}}


@pytest.fixture(scope="module")
def tiny():
    """rect_mesh(2, 2) P1 (8 elements), and rect_mesh(4, 4) P1 for the
    merged engines, the smallest mesh their plan takes."""
    return {n: make_case(2, n, 1, seed=4) for n in (2, 4)}


@pytest.mark.parametrize("op", ["A", "B"])
@pytest.mark.parametrize("name", list(ENGINES))
def test_gradcheck_conjugated_ops(tiny, name, op):
    """gradcheck of A (sigma rows -> u rows) and B' (u rows -> strain rows)
    on the node rows of the layout (padding rows stay zero)."""
    ldf = engine(tiny[4 if name.startswith("merged") else 2], 2,
                 **ENGINES[name])
    d = ldf.runner.d
    C = d.n_sig if op == "A" else d.dim
    j = torch.arange(d.npp)
    rows = torch.nonzero((j % (d.npp // ldf._npar)) < d.n_p)[:, 0]
    n_in = len(rows) * ldf._L
    fn = getattr(ldf.ops, op)

    def f(x):
        full = x.new_zeros((C, d.npp, ldf._L)).index_copy(
            1, rows, x.reshape(C, -1, ldf._L))
        out = fn(full.reshape(C * d.npp, -1))
        return out.reshape(-1, d.npp, ldf._L)[:, rows]

    x = torch.as_tensor(np.random.default_rng(7).standard_normal(C * n_in),
                        dtype=F64).requires_grad_(True)
    assert torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-8,
                                    rtol=1e-7)


@pytest.fixture(scope="module")
def case_p2():
    return make_case(2, 4, 2, seed=1)


@pytest.fixture(scope="module")
def case_p1():
    return make_case(2, 4, 1, seed=2)


def einsum_gradient(c, obs, n_steps, order=4):
    vg, init = make_fwi_gradient(c["p"], c["st"], c["dt"], n_steps,
                                 c["src"], c["rcv"], obs[0],
                                 fields=("vp", "vs", "rho"), order=order,
                                 damp=c["damp"])
    theta = init()
    return theta, vg(theta)


@pytest.mark.parametrize("name,kw,which", [
    ("lane-lf2", {"order": 2}, "p2"),
    ("lane", {}, "p2"),
    ("lane-segment", {"segment": 4}, "p2"),
    ("merged", {"engine": "merged"}, "p2"),
    ("lane_u", {"engine": "lane_u"}, "p2"),
    ("merged_pk", {"engine": "merged", "packed": True}, "p1"),
])
def test_engine_gradient_matches_einsum(case_p2, case_p1, name, kw, which):
    c = case_p2 if which == "p2" else case_p1
    n_steps = 12
    ldf = engine(c, n_steps, **kw)
    ldf.observed = ldf.synth({"vp": c["mat"]["vp"] * 1.07})
    theta, (v_ref, g_ref) = einsum_gradient(c, ldf.observed, n_steps,
                                            order=kw.get("order", 4))
    v, g = ldf.vg_factory(None)(theta)
    assert v_ref > 1e-10
    np.testing.assert_allclose(v, v_ref, rtol=RTOL)
    np.testing.assert_allclose(ldf.loss_shot(theta, 0), v, rtol=1e-13)
    for k in ("vp", "vs", "rho"):
        assert float(g_ref[k].abs().max()) > 0
        close(g[k], g_ref[k], err_msg=k)


def test_vti_gradient_matches_einsum():
    """aniso="vti": Thomsen-parameter gradients of the lane engine against
    autograd through make_aniso_stress_op with vti_stiffness_torch."""
    c = make_case(3, 2, 1, seed=11, f0=6.0, t0=0.1, sponge=False)
    E, n_steps = c["dm"].num_elements, 8
    rng = np.random.default_rng(12)
    eps0, del0, gam0 = (torch.as_tensor(a + b * rng.random(E))
                        for a, b in ((0.10, 0.05), (0.04, 0.02),
                                     (0.08, 0.04)))
    ldf = engine(c, n_steps, aniso="vti", theta_defaults={
        "epsilon": eps0, "delta": del0, "gamma": gam0})
    ldf.observed = ldf.synth({"epsilon": eps0 * 1.5})
    vp, vs, rho = (torch.as_tensor(c["mat"][k]) for k in ("vp", "vs", "rho"))
    theta = {"vp": vp, "epsilon": eps0, "delta": del0}
    v, g = ldf.vg_factory(None)(theta)
    obs = torch.as_tensor(ldf.observed[0])

    def loss_ref(th):
        full = {"vs": vs, "rho": rho, "gamma": gam0, **th}
        C = vti_stiffness_torch(full["vp"], full["vs"], full["rho"],
                                full["epsilon"], full["delta"],
                                full["gamma"])
        p = with_material(c["p"], vp=full["vp"], vs=full["vs"],
                          rho=full["rho"])
        _, seis = run_segmented(p, c["st"], c["dt"], n_steps, src=c["src"],
                                receivers=c["rcv"],
                                stress_op=make_aniso_stress_op(C))
        r = seis - obs
        return 0.5 * torch.sum(r * r)

    v_ref, g_ref = value_and_grad(loss_ref, theta)
    assert v_ref > 1e-12
    np.testing.assert_allclose(v, v_ref, rtol=RTOL)
    for k in theta:
        assert float(g_ref[k].abs().max()) > 0, k
        close(g[k], g_ref[k], err_msg=k)


def test_source_wavelet_gradient_finite_difference():
    """Per-shot (amp, f0, t0) gradients against central differences (the
    JAX package's steps and bar); the joint mode gives vg_factory's
    material gradient at the same wavelets."""
    c = make_case(2, 4, 1, seed=13, sponge=False)
    srcs = [c["src"], build_sources(c["dm"], [PointSource(
        position=(0.6, 0.45), f0=8.0, t0=0.05, amplitude=100.0,
        radius=2.5 * float(c["dm"].h.max()))], dtype=F64, device="cpu")]
    ldf = LaneDiffFwi(c["p"], c["dm"], c["ex"], c["dt"], 8,
                      stack_shots(srcs), c["rcv"], None)
    theta = {"vp": c["mat"]["vp"]}
    ldf.observed = ldf.synth(theta)  # the true wavelets
    wav0 = {k: ldf.src[k].numpy().copy() for k in ("amp", "f0", "t0")}
    wav = {"amp": wav0["amp"] * 1.15, "f0": wav0["f0"] * 0.95,
           "t0": wav0["t0"] + 0.003}
    svg = ldf.source_vg_factory()
    v0, gw = svg(wav, theta)
    assert v0 > 1e-12
    for k, eps in (("amp", 1e-4), ("f0", 1e-4), ("t0", 1e-6)):
        assert gw[k].shape == wav0[k].shape
        for s in range(2):
            wp, wm = ({kk: vv.copy() for kk, vv in wav.items()}
                      for _ in range(2))
            wp[k][s] += eps
            wm[k][s] -= eps
            fd = (svg(wp, theta)[0] - svg(wm, theta)[0]) / (2 * eps)
            np.testing.assert_allclose(np.sum(gw[k][s]), fd, rtol=2e-5,
                                       err_msg=f"{k}[{s}]")
    for k in wav:
        ldf.src[k] = torch.as_tensor(wav[k])
    v2, _, gt = ldf.source_vg_factory(with_theta=True)(wav, theta)
    np.testing.assert_allclose(v2, v0, rtol=1e-12)
    v3, g3 = ldf.vg_factory(None)(theta)
    np.testing.assert_allclose(v3, v0, rtol=1e-12)
    close(gt["vp"], g3["vp"])


def test_moment_tensor_gradient_finite_difference():
    c = make_case(2, 4, 1, seed=17, sponge=False)
    dm = c["dm"]
    src = build_sources(dm, [PointSource(
        position=(0.45, 0.6), f0=10.0, t0=0.04, amplitude=100.0,
        kind="moment", moment=(1.0, -0.5, 0.3),
        radius=2.5 * float(dm.h.max()))], dtype=F64, device="cpu")
    ldf = LaneDiffFwi(c["p"], dm, c["ex"], c["dt"], 10, stack_shots([src]),
                      c["rcv"], None)
    ldf.observed = ldf.synth({})
    mvg = ldf.moment_vg_factory()
    np.testing.assert_allclose(mvg.m_init[0], [1.0, -0.5, 0.3], rtol=1e-12)
    assert mvg(mvg.m_init, {})[0] < 1e-25  # the true moment: no misfit
    m = np.array([[0.8, -0.2, 0.5]])
    v, gm = mvg(m, {})
    assert gm.shape == (1, 3) and v > 0
    for i in range(3):
        mp, mm = m.copy(), m.copy()
        mp[0, i] += 1e-6
        mm[0, i] -= 1e-6
        fd = (mvg(mp, {})[0] - mvg(mm, {})[0]) / 2e-6
        np.testing.assert_allclose(gm[0, i], fd, rtol=1e-6)


@pytest.mark.parametrize("name", ["lane", "merged_pk"])
def test_illumination_matches_einsum(case_p1, name):
    ldf = engine(case_p1, 12, **ENGINES[name])
    c = case_p1
    ref = source_illumination(c["p"], c["st"], c["dt"], 12, c["src"],
                              damp=c["damp"])
    close(ldf.illumination(), ref)
