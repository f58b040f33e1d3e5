"""The port's einsum adjoint (solver/adjoint.py, the rk4 ``segment``)
against the JAX package, f64 on the CPU.

1. ``run_segmented`` (plain and in checkpointed segments) gives the JAX
   seismograms (of its plain scan: JAX's segments are the same
   arithmetic), and bitwise the final state of ``timestep.run``.
2. ``make_fwi_gradient`` gives the value and the (vp, vs, rho) gradients of
   JAX's ``make_fwi_gradient``, with ``segment`` off and on, and passes
   central finite differences.
   The lane, merged and lane_u engines of solver/lane_diff.py give JAX's
   gradient too.
3. ``make_visco_fwi_gradient`` (the Q^-1 gradient through
   ``run_rk4_visco(segment=)``) gives JAX's.
4. ``with_material`` rebuilds the Lame rows from (vp, vs, rho).

Case: rect_mesh(4, 4) P2 (visco: P1) with a free top, a sponge, a mollified
point source, 3 receivers and a numpy-seeded heterogeneous material.
Tolerance: rtol 1e-10, atol 1e-12 * max|ref| (f64 roundoff of differently
ordered sums, amplified by the seismogram residual).
"""

import dataclasses

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
from seigen_tpu.solver import adjoint as jadj
from seigen_tpu_torch.solver import adjoint as tadj

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


def close(got, ref, rtol=RTOL, err_msg=""):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-12 * np.abs(ref).max(),
                               err_msg=err_msg)


def build_case(degree=2, n=4, n_steps=12, seed=1):
    """The same 2D acquisition in both packages: (jax dict, torch dict)."""
    rng = np.random.default_rng(seed)
    out = []
    for mesh, ops, sol, dtype, kw in (
            (jmesh, jops, jsol, jnp.float64, {}),
            (tmesh, tops, tsol, F64, {"device": "cpu"})):
        dm = mesh.build_discrete(
            mesh.rect_mesh(n, n), degree,
            bc_fn=sol.absorbing_bc_fn(((0.0, 1.0),) * 2,
                                      free_sides=[(1, "hi")]))
        out.append(dict(dm=dm, sol=sol, dtype=dtype, kw=kw))
    E = out[0]["dm"].num_elements
    rho, vp, vs = 1.0 + rng.random(E), 2.0 + rng.random(E), \
        0.8 + 0.4 * rng.random(E)
    h = float(out[0]["dm"].h.min())
    for c, ops in zip(out, (jops, tops)):
        dm, sol, dtype, kw = c["dm"], c["sol"], c["dtype"], c["kw"]
        c["p"] = ops.build_params(dm, ops.Material(rho=rho, vp=vp, vs=vs),
                                  dtype=dtype, **kw)
        c["src"] = sol.build_sources(
            dm, [sol.PointSource(position=(0.45, 0.6), f0=10.0, t0=0.04,
                                 amplitude=100.0,
                                 radius=2.5 * float(dm.h.max()))],
            dtype=dtype, **kw)
        c["rcv"] = sol.build_receivers(
            dm, sol.line((0.2, 0.85), (0.8, 0.85), 3), dtype=dtype, **kw)
        damp = sol.sponge_mask(dm, [(0, "lo"), (0, "hi"), (1, "lo")],
                               width=0.25)
        n_p = dm.re.n_p
        if dtype is F64:
            c["damp"] = torch.as_tensor(damp, dtype=F64)
            c["st"] = tsol.State(u=torch.zeros(E, n_p, 2, dtype=F64),
                                 s=torch.zeros(E, n_p, 3, dtype=F64))
        else:
            c["damp"] = jnp.asarray(damp)
            c["st"] = jsol.State(u=jnp.zeros((E, n_p, 2)),
                                 s=jnp.zeros((E, n_p, 3)))
        c["dt"] = sol.cfl_dt(h, 3.0, degree, 0.3)
        c["n"] = n_steps
    return out[0], out[1], dict(rho=rho, vp=vp, vs=vs)


@pytest.fixture(scope="module")
def case():
    return build_case()


@pytest.fixture(scope="module")
def observed(case):
    """Seismograms of a 7 % faster vp model (the JAX einsum run)."""
    j, _, mat = case
    p_true = jadj.with_material(j["p"], vp=jnp.asarray(mat["vp"] * 1.07))
    _, seis = jsol.run(p_true, j["st"], j["dt"], j["n"], src=j["src"],
                       damp=j["damp"], receivers=j["rcv"])
    return np.asarray(seis)


@pytest.mark.parametrize("segment", [None, 4])
def test_run_segmented_matches_jax(case, observed, segment):
    """The port's run at the true model against JAX's (the observed data);
    JAX's segments are the same arithmetic as its plain scan."""
    _, t, mat = case
    p_true = tadj.with_material(t["p"], vp=mat["vp"] * 1.07)
    fin, seis = tadj.run_segmented(
        p_true, t["st"], t["dt"], t["n"], segment=segment, src=t["src"],
        damp=t["damp"], receivers=t["rcv"])
    close(seis, observed)
    fin_p, _ = tsol.run(p_true, t["st"], t["dt"], t["n"], src=t["src"],
                        damp=t["damp"])
    assert torch.equal(fin.u, fin_p.u) and torch.equal(fin.s, fin_p.s)
    with pytest.raises(ValueError, match="divide"):
        tadj.run_segmented(t["p"], t["st"], t["dt"], t["n"], segment=5)


@pytest.fixture(scope="module")
def jax_gradient(case, observed):
    """JAX make_fwi_gradient's value and (vp, vs, rho) gradients."""
    j, _, _ = case
    vg, init = jadj.make_fwi_gradient(
        j["p"], j["st"], j["dt"], j["n"], j["src"], j["rcv"],
        jnp.asarray(observed), fields=("vp", "vs", "rho"),
        damp=j["damp"])
    theta = init()
    v, g = vg(theta)
    return float(v), {k: np.asarray(x) for k, x in g.items()}, \
        {k: np.asarray(x) for k, x in theta.items()}


@pytest.mark.parametrize("segment", [None, 4])
def test_fwi_gradient_matches_jax(case, observed, jax_gradient, segment):
    _, t, _ = case
    v_j, g_j, th_j = jax_gradient
    vg, init = tadj.make_fwi_gradient(
        t["p"], t["st"], t["dt"], t["n"], t["src"], t["rcv"], observed,
        fields=("vp", "vs", "rho"), damp=t["damp"], segment=segment)
    theta = init()
    for k in theta:
        close(theta[k], th_j[k], err_msg=k)
    v, g = vg(theta)
    assert v > 1e-10
    np.testing.assert_allclose(v, v_j, rtol=RTOL)
    for k in ("vp", "vs", "rho"):
        assert np.abs(g_j[k]).max() > 0
        close(g[k], g_j[k], err_msg=k)


@pytest.mark.parametrize("engine", ["lane", "merged", "lane_u"])
def test_lane_engine_matches_jax_gradient(case, observed, jax_gradient,
                                          engine):
    """The energy-conjugation engines (solver/lane_diff.py, plain versions
    of their kernels) against JAX's einsum make_fwi_gradient directly."""
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.lane_diff import LaneDiffFwi

    _, t, _ = case
    v_j, g_j, th_j = jax_gradient
    ldf = LaneDiffFwi(t["p"], t["dm"], detect_structured(t["dm"]), t["dt"],
                      t["n"], t["src"], t["rcv"], observed[None],
                      damp=t["damp"], engine=engine)
    v, g = ldf.vg_factory(None)(th_j)
    np.testing.assert_allclose(v, v_j, rtol=RTOL)
    for k in ("vp", "vs", "rho"):
        close(g[k], g_j[k], err_msg=k)


def test_fwi_gradient_matches_finite_differences(case, observed):
    _, t, _ = case
    E = t["dm"].num_elements
    vg, init = tadj.make_fwi_gradient(
        t["p"], t["st"], t["dt"], t["n"], t["src"], t["rcv"], observed,
        fields=("vp",), damp=t["damp"], segment=4)
    theta = init()
    _, g = vg(theta)
    g = g["vp"].numpy()
    rng = np.random.default_rng(5)
    idxs = [int(np.argmax(np.abs(g))), int(rng.integers(0, E))]
    eps = 1e-5
    for i in idxs:
        dv = torch.zeros(E, dtype=F64)
        dv[i] = eps
        fd = (vg({"vp": theta["vp"] + dv})[0]
              - vg({"vp": theta["vp"] - dv})[0]) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=2e-5, atol=1e-12)


def test_with_material_matches_jax(case):
    j, t, _ = case
    E = t["dm"].num_elements
    vp, vs, rho = np.full(E, 2.3), np.full(E, 1.1), np.full(E, 1.7)
    pt = tadj.with_material(t["p"], vp=vp, vs=vs, rho=rho)
    pj = jadj.with_material(j["p"], vp=jnp.asarray(vp), vs=jnp.asarray(vs),
                            rho=jnp.asarray(rho))
    for name in ("lam", "mu", "inv_rho"):
        close(getattr(pt, name), getattr(pj, name), err_msg=name)
    # a partial update keeps the other fields
    p3 = tadj.with_material(pt, vs=torch.as_tensor(vs * 1.1))
    np.testing.assert_allclose((1.0 / p3.inv_rho).numpy(), 1.7, rtol=1e-14)
    th = tadj.theta_of_params(p3)
    np.testing.assert_allclose(th["vp"].numpy(), 2.3, rtol=1e-14)


@pytest.fixture(scope="module")
def visco_case():
    j, t, _ = build_case(degree=1, n=4, n_steps=8, seed=3)
    rng = np.random.default_rng(5)
    E = t["dm"].num_elements
    q_true = 8.0 + 20.0 * rng.random(E)
    f_band = (0.3, 5.0)
    for c, ops in ((j, jops), (t, tops)):
        mat = ops.Material(rho=1.0, vp=2.0, vs=1.0)
        c["p"] = ops.build_params(c["dm"], mat, dtype=c["dtype"], **c["kw"])
        c["w"] = ops.build_upwind_data(c["dm"], mat, dtype=c["dtype"],
                                       **c["kw"])
        c["dt"] = c["sol"].cfl_dt(float(c["dm"].h.min()), 2.0, 1, 0.3)
    v_true = tops.build_visco(t["p"], q_true, q_true, *f_band)
    _, _, obs = tsol.run_rk4_visco(t["p"], t["w"], v_true, t["st"], t["dt"],
                                   t["n"], src=t["src"], receivers=t["rcv"])
    return j, t, obs.numpy(), f_band, rng.standard_normal(E)


def test_visco_gradient_matches_jax(visco_case):
    """The Q^-1 gradient through the viscoelastic RK4 loop, segmented
    (checkpointed) on the port's side, against JAX's unsegmented one."""
    j, t, obs, f_band, dvec = visco_case
    vg_j, init_j = jadj.make_visco_fwi_gradient(
        j["p"], j["w"], j["st"], j["dt"], j["n"], j["src"], j["rcv"],
        jnp.asarray(obs), f_band, q0=50.0, damp=j["damp"])
    vg_t, init_t = tadj.make_visco_fwi_gradient(
        t["p"], t["w"], t["st"], t["dt"], t["n"], t["src"], t["rcv"], obs,
        f_band, q0=50.0, damp=t["damp"], segment=4)
    # a heterogeneous Q^-1 so each field's gradient is generic
    th_j = {k: v * (1.0 + 0.2 * jnp.asarray(np.tanh(dvec)))
            for k, v in init_j().items()}
    th_t = {k: torch.as_tensor(np.asarray(v)) for k, v in th_j.items()}
    v_j, g_j = vg_j(th_j)
    v_t, g_t = vg_t(th_t)
    assert float(v_j) > 1e-14
    np.testing.assert_allclose(v_t, float(v_j), rtol=RTOL)
    assert set(g_t) == {"qinv_kappa", "qinv_mu"}
    for k in g_t:
        close(g_t[k], g_j[k], err_msg=k)


def test_rk4_visco_segment_is_exact(visco_case):
    """run_rk4_visco(segment=) is the same computation in checkpointed
    chunks: bitwise equal outputs, and a segment must divide the steps."""
    _, t, _, f_band, _ = visco_case
    from seigen_tpu_torch.ops.viscoelastic import build_visco

    v = build_visco(t["p"], 20.0, 30.0, *f_band)
    outs = [tsol.run_rk4_visco(t["p"], t["w"], v, t["st"], t["dt"], t["n"],
                               src=t["src"], damp=t["damp"],
                               receivers=t["rcv"], segment=seg)
            for seg in (None, 4)]
    for a, b in zip(outs[0][2:], outs[1][2:]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1])
    with pytest.raises(ValueError, match="divide"):
        tsol.run_rk4_visco(t["p"], t["w"], v, t["st"], t["dt"], t["n"],
                           segment=3)
    assert dataclasses.is_dataclass(outs[0][0])
