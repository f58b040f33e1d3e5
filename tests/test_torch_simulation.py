"""The port's ``ElasticSimulation`` facade on the CPU against the JAX
package's, f64, the same topology, material, config, sources and receiver
points handed to both.

1. The cases of tests/test_simulation.py through both facades: end to end
   (sponge, free top, source, receivers), the operator backends against
   each other (port ``einsum`` vs ``lane`` vs ``lane_u``; JAX ``einsum``),
   ``upwind-rk4`` with and without attenuation.  Before a run is compared
   the two facades must agree on ``dt``, ``params`` and ``damp`` (1e-14);
   final states agree to 1e-9 of the state's largest magnitude, seismograms
   likewise.
2. ``stiffness=`` (tests/test_anisotropic.py:test_facade_stiffness_option):
   the einsum anisotropic path, isotropic and per-element anisotropic C,
   equal ``dt`` in f64 and f32; the ``ValueError``s of the option.
3. What the port refuses: the element-major impls that have no port yet
   (``NotImplementedError``), unknown impls and schemes, attenuation
   without ``upwind-rk4``.
4. ``zero_state``/``state_from``/``step_fn``/``sample``, and the material
   builders of ``solver/models.py`` against the JAX package's.
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
from seigen_tpu.solver import models as jmodels
from seigen_tpu.solver import simulation as jsim
from seigen_tpu_torch.ops.anisotropic import iso_stiffness
from seigen_tpu_torch.solver import models as tmodels
from seigen_tpu_torch.solver import simulation as tsim


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


MAT = dict(rho=1.0, vp=2.0, vs=1.0)
SPONGE = dict(free_sides=((1, "hi"),),
              absorbing_sides=((0, "lo"), (0, "hi"), (1, "lo")),
              sponge_width=0.2)


def _both(mesh_args, mesh_kw=None, cfg=None, source=None, receivers=None,
          stiffness=None, mat=None, timpl=None):
    """(JAX facade, port facade) from the same inputs; ``timpl`` overrides
    the port's impl."""
    cfg = dict(cfg or {})
    out = []
    for mesh, ops, sol, sim, extra in (
            (jmesh, jops, jsol, jsim, {}),
            (tmesh, tops, tsol, tsim, {"device": "cpu"})):
        c = dict(cfg)
        if timpl is not None and sim is tsim:
            c["impl"] = timpl
        out.append(sim.ElasticSimulation(
            mesh.rect_mesh(*mesh_args, **(mesh_kw or {})),
            ops.Material(**(mat or MAT)),
            sim.SimConfig(**c),
            sources=None if source is None else [sol.PointSource(**source)],
            receiver_points=None if receivers is None
            else sol.line(*receivers),
            stiffness=stiffness, **extra))
    return out


def _same_dt(js, ts):
    np.testing.assert_allclose(ts.dt, js.dt, rtol=1e-14, atol=0)


def _same_setup(js, ts):
    """dt, params and damp of the two facades are equal (to f64 roundoff:
    the packages compute the mesh size h with differently ordered sums)."""
    _same_dt(js, ts)
    for name in ("Ginv", "Fscale", "normals", "inv_rho", "lam", "mu",
                 "beta_t", "delta_u"):
        ref = np.asarray(getattr(js.params, name))
        np.testing.assert_allclose(getattr(ts.params, name).numpy(), ref,
                                   rtol=1e-13,
                                   atol=1e-14 * np.abs(ref).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(ts.params.nbr.numpy(),
                                  np.asarray(js.params.nbr))
    assert (ts.damp is None) == (js.damp is None)
    if ts.damp is not None:
        np.testing.assert_allclose(ts.damp.numpy(), np.asarray(js.damp),
                                   rtol=1e-14)


def _close(got, ref, rel=1e-9):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * np.abs(ref).max())


def _runs_agree(js, ts, T):
    _same_setup(js, ts)
    fj, sj = js.run(T)
    ft, st = ts.run(T)
    assert torch.isfinite(ft.u).all() and ft.u.abs().max() > 1e-12
    _close(ft.u, fj.u)
    _close(ft.s, fj.s)
    assert (st is None) == (sj is None)
    if st is not None:
        assert isinstance(st, np.ndarray)
        _close(st, sj)
    return ft, st


# --- 1. the cases of tests/test_simulation.py ------------------------------


def test_facade_end_to_end_matches_jax():
    js, ts = _both(
        (16, 8), dict(lx=2.0, ly=1.0),
        cfg=dict(degree=2, order=4, dtype="float64", impl="auto", **SPONGE),
        source=dict(position=(1.0, 0.8), f0=6.0, radius=0.15),
        receivers=((0.3, 0.9), (1.7, 0.9), 5))
    assert ts._impl == "einsum"  # auto on the CPU
    assert ts.damp is not None
    _, seis = _runs_agree(js, ts, 0.15)
    assert seis.shape[1] == 5 and np.all(np.isfinite(seis))


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("impl", ["lane", "lane_u"])
def test_facade_impl_equivalence(impl, order):
    """The lane runners through the facade reproduce the einsum facade and
    the JAX einsum facade (sponge, source and receivers included)."""
    kw = dict(cfg=dict(degree=2, order=order, dtype="float64",
                       impl="einsum", **SPONGE),
              source=dict(position=(0.5, 0.5), f0=6.0, radius=0.15),
              receivers=((0.2, 0.9), (0.8, 0.9), 4))
    js, te = _both((8, 8), **kw)
    _, tl = _both((8, 8), timpl=impl, **kw)
    assert te._impl == "einsum" and tl._impl == impl
    fe, se = _runs_agree(js, te, 0.1)
    fl, sl = tl.run(0.1)
    assert tl._lane_runner is not None and tl._lane_runner.impl == "reference"
    _close(fl.u, fe.u)
    _close(fl.s, fe.s)
    _close(sl, se)
    # a second run reuses the runner
    runner = tl._lane_runner
    tl.run(0.02)
    assert tl._lane_runner is runner


@pytest.mark.parametrize("q", [None, 15.0], ids=["elastic", "Q15"])
def test_facade_upwind_and_attenuation(q):
    cfg = dict(degree=1, dtype="float64", scheme="upwind-rk4", **SPONGE)
    if q is not None:
        cfg.update(q_kappa=q, q_mu=q, q_band=(1.0, 10.0))
    js, ts = _both((12, 6), dict(lx=2.0, ly=1.0), cfg=cfg,
                   source=dict(position=(1.0, 0.7), f0=4.0, radius=0.2),
                   receivers=((0.3, 0.9), (1.7, 0.9), 4))
    _, seis = _runs_agree(js, ts, 0.8)
    if q is not None:  # weaker than the elastic twin at late times
        n = len(seis) // 2
        cfg_e = {k: v for k, v in cfg.items() if not k.startswith("q_")}
        _, te = _both((12, 6), dict(lx=2.0, ly=1.0), cfg=cfg_e,
                      source=dict(position=(1.0, 0.7), f0=4.0, radius=0.2),
                      receivers=((0.3, 0.9), (1.7, 0.9), 4))
        _, seis_e = te.run(0.8)
        assert np.abs(seis[n:]).max() < np.abs(seis_e[n:]).max()


# --- 2. stiffness= ----------------------------------------------------------


def _stiffness_2d(E, seed):
    """Per-element symmetric positive definite 3x3 Voigt matrices around
    the isotropic one."""
    mat = tops.Material(**MAT)
    Ci = iso_stiffness(float(mat.lam), float(mat.mu), 2)
    A = 0.15 * np.random.default_rng(seed).standard_normal((E, 3, 3))
    return Ci + 0.5 * (A + A.transpose(0, 2, 1))


@pytest.mark.parametrize("kind", ["iso", "per-element"])
def test_facade_stiffness_option(kind):
    mat = tops.Material(**MAT)
    C = (iso_stiffness(float(mat.lam), float(mat.mu), 2) if kind == "iso"
         else _stiffness_2d(128, 3))
    kw = dict(cfg=dict(degree=2, dtype="float64", **SPONGE),
              source=dict(position=(0.5, 0.6), f0=3.0, radius=0.2),
              receivers=((0.3, 0.9), (0.7, 0.9), 3))
    js, ts = _both((8, 8), stiffness=C, **kw)
    assert ts._impl == "einsum" and js._impl == "einsum"
    fa, _ = _runs_agree(js, ts, 0.25)
    if kind == "iso":
        # the isotropic C reproduces the isotropic facade solution (its dt
        # differs: the Frobenius bound is looser than vp)
        _, ti = _both((8, 8), **kw)
        assert ts.dt < ti.dt
        fi, _ = ti.run(0.25)
        u_i, u_a = fi.u.numpy().ravel(), fa.u.numpy().ravel()
        corr = (u_i @ u_a) / (np.linalg.norm(u_i) * np.linalg.norm(u_a))
        assert corr > 0.999, corr


def test_facade_stiffness_dt_and_refusals():
    C = _stiffness_2d(32, 4)
    # the CFL bound is taken from the stiffness as the run dtype holds it
    for dtype in ("float32", "float64"):
        js, ts = _both((4, 4), cfg=dict(degree=1, dtype=dtype), stiffness=C)
        _same_dt(js, ts)
        assert ts._stiffness.dtype == getattr(torch, dtype)
    with pytest.raises(ValueError, match="scheme='lf'"):
        _both((4, 4), cfg=dict(degree=1, scheme="upwind-rk4"), stiffness=C)
    with pytest.raises(ValueError, match="einsum"):
        tsim.ElasticSimulation(
            tmesh.rect_mesh(4, 4), tops.Material(**MAT),
            tsim.SimConfig(degree=1, impl="lane"), stiffness=C, device="cpu")
    with pytest.raises(ValueError):  # not (n_sig, n_sig)
        tsim.ElasticSimulation(
            tmesh.rect_mesh(4, 4), tops.Material(**MAT),
            tsim.SimConfig(degree=1), stiffness=np.eye(6), device="cpu")


# --- 3. refusals ------------------------------------------------------------


def _port(**cfg):
    return tsim.ElasticSimulation(tmesh.rect_mesh(4, 4),
                                  tops.Material(**MAT),
                                  tsim.SimConfig(degree=1, **cfg),
                                  device="cpu")


@pytest.mark.parametrize("impl", ["xla_roll", "pallas", "pallas_roll"])
def test_facade_refuses_unported_impls(impl):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(impl=impl)


def test_facade_refuses_bad_options():
    with pytest.raises(ValueError, match="unknown impl"):
        _port(impl="mosaic")
    with pytest.raises(ValueError, match="unknown scheme"):
        _port(scheme="rk2")
    with pytest.raises(ValueError, match="upwind-rk4"):
        _port(q_mu=20.0, q_band=(1.0, 10.0))
    with pytest.raises(ValueError, match="q_band"):
        _port(scheme="upwind-rk4", q_mu=20.0)
    # a scrambled mesh has no structure to recover lanes from
    import dataclasses

    topo = tmesh.rect_mesh(4, 4, periodic=(0, 1))
    perm = np.random.default_rng(0).permutation(topo.num_cells)
    topo = dataclasses.replace(topo, cells=topo.cells[perm], structure=None)
    with pytest.raises(ValueError, match="structured"):
        tsim.ElasticSimulation(topo, tops.Material(**MAT),
                               tsim.SimConfig(degree=1, impl="lane"),
                               device="cpu")
    assert tsol.ElasticSimulation is tsim.ElasticSimulation
    assert tsol.SimConfig is tsim.SimConfig


# --- 4. the rest of the surface ---------------------------------------------


def test_state_from_step_fn_and_sample_match_jax():
    mat_j, mat_t = jops.Material(**MAT), tops.Material(**MAT)
    k = 2 * np.pi * np.array([1.0, 0.0])
    pol = np.array([0.0, 1.0])
    pw_j = jsol.PlaneWave(mat=mat_j, k=k, mode="S", polarization=pol)
    pw_t = tsol.PlaneWave(mat=mat_t, k=k, mode="S", polarization=pol)
    out = []
    for mesh, ops, sol, sim, extra, pw in (
            (jmesh, jops, jsol, jsim, {}, pw_j),
            (tmesh, tops, tsol, tsim, {"device": "cpu"}, pw_t)):
        s = sim.ElasticSimulation(
            mesh.rect_mesh(4, 4, periodic=(0, 1)), ops.Material(**MAT),
            sim.SimConfig(degree=2, dtype="float64", impl="einsum"),
            receiver_points=sol.line((0.2, 0.5), (0.8, 0.5), 3), **extra)
        st = s.state_from(pw.u, pw.sigma)
        z = s.zero_state()
        assert z.u.shape == st.u.shape and z.s.shape == st.s.shape
        assert float(abs(np.asarray(z.u)).max()) == 0.0
        step = s.step_fn()
        st1 = step(step(st, 0.0), s.dt)
        fin, _ = s.run(2 * s.dt, state=st)
        np.testing.assert_allclose(np.asarray(fin.u), np.asarray(st1.u),
                                   rtol=1e-12, atol=1e-14)
        out.append((s, st, st1, s.sample(st1)))
    (js, st_j, st1_j, smp_j), (ts, st_t, st1_t, smp_t) = out
    _same_setup(js, ts)
    for a, b in ((st_t, st_j), (st1_t, st1_j)):
        _close(a.u, b.u, rel=1e-11)
        _close(a.s, b.s, rel=1e-11)
    assert isinstance(smp_t, np.ndarray) and smp_t.shape == (3, 2)
    _close(smp_t, smp_j, rel=1e-11)
    no_rcv = tsim.ElasticSimulation(
        tmesh.rect_mesh(4, 4), tops.Material(**MAT),
        tsim.SimConfig(degree=1), device="cpu")
    assert no_rcv.sample(no_rcv.zero_state()) is None
    assert no_rcv.zero_state().u.dtype == torch.float32


def test_material_models_equal_jax():
    dmj = jmesh.build_discrete(jmesh.rect_mesh(6, 6), 1)
    dmt = tmesh.build_discrete(tmesh.rect_mesh(6, 6), 1)
    np.testing.assert_array_equal(tmodels.element_centroids(dmt),
                                  jmodels.element_centroids(dmj))
    layers = [(0.0, 0.4, 1.0, 2.0, 1.0), (0.4, 0.7, 1.2, 2.5, 1.3),
              (0.7, 1.01, 1.5, 3.0, 1.6)]
    mj = jmodels.layered_model(dmj, [jmodels.Layer(*a) for a in layers])
    mt = tmodels.layered_model(dmt, [tmodels.Layer(*a) for a in layers])
    body = dict(center=(0.5, 0.5), radii=(0.3, 0.15), rho=2.0, vp=4.0, vs=2.0)
    mj2 = jmodels.add_ellipsoid_body(dmj, mj, **body)
    mt2 = tmodels.add_ellipsoid_body(dmt, mt, **body)
    for a, b in ((mt, mj), (mt2, mj2)):
        assert isinstance(a, tops.Material)
        for name in ("rho", "vp", "vs"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)))
    assert len(np.unique(mt.vp)) == 3 and (mt2.vp == 4.0).any()
    # the per-element material drives the facade (dt from the fastest layer)
    sim = tsim.ElasticSimulation(tmesh.rect_mesh(6, 6), mt2,
                                 tsim.SimConfig(degree=1, dtype="float64"),
                                 device="cpu")
    ref = jsim.ElasticSimulation(jmesh.rect_mesh(6, 6), mj2,
                                 jsim.SimConfig(degree=1, dtype="float64"))
    _same_setup(ref, sim)
