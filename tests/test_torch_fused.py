"""The port's v2 exchange-fused LF4 engine (CPU, plain versions).

1. ``vel2_op_ref``/``stress2_op_ref`` (the CPU path of K8/K9) against the
   JAX ``vel2_op``/``stress2_op(interpret=True)`` at f64 on the operator data
   of the JAX ``FusedLaneRunner``: outputs and emitted traces row for row on
   the first E lanes (rtol 1e-10: f64 roundoff of differently ordered
   sums), plain, axpy, axpy + sponge, and with a per-element non-symmetric
   stiffness.
2. The port's permuted ``FusedOpData`` (geo, drr, lift, damp; with a
   stiffness) equals the JAX runner's arrays row for row.
3. The plain trace exchange against the JAX loop exchange
   ``make_trace_exchange`` exactly (a permutation) on bounded and periodic
   2D/3D meshes and the period-2 ``box_mesh(2, 16, 16)``, and against the
   JAX Pallas exchange (interpret mode, traction traces) on
   ``box_mesh(4, 4, 8)`` to two float32 ulps: that kernel permutes with a float32 one-hot matmul
   (seigen_tpu/ops/fused_kernels.py:358-377), so even in f64 its output is
   rounded to float32.
4. ``FusedLaneRunner(impl="reference")`` against the JAX
   ``FusedLaneRunner(interpret=True, block=8)`` on the cases of
   tests/test_fused.py, two to a JAX compile: 3D P1 periodic in x and y with
   the full pipeline (source, bottom sponge, receivers with pressure) and a
   per-element stiffness; 2D P3 periodic in x with a source, step0 0 and 5.
   Tolerance 1e-6 of the output's largest magnitude, not 1e-10: the JAX
   runner rounds its u-damping rows, source patterns and traction-seed
   normals to float32 on the host even in an f64 run
   (seigen_tpu/solver/lane_fused.py:551, :571, :588-603); the port keeps
   them in the run dtype.
5. The tight check of the whole runner: the port's own engines at f64 —
   fused against ``MergedLaneRunner`` and ``LaneMajorRunner`` (LF4) on
   bounded 2D and 3D meshes with source, sponge and receivers recording
   pressure, and against ``LaneMajorRunner`` on fully periodic 2D and 3D
   meshes, rtol 1e-10 (as tests/test_fused.py and tests/test_merged.py:48
   chain them).
6. ``impl="kernel"`` refuses CPU tensors; ``order=2`` raises.
"""

import dataclasses

import jax
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
from seigen_tpu.ops.fused_kernels import build_fused_data as jfused_data
from seigen_tpu.ops.fused_kernels import stress2_op, vel2_op
from seigen_tpu.ops.structured_exchange import detect_structured as jdetect
from seigen_tpu.solver.lane_fused import FusedLaneRunner as JaxRunner
from seigen_tpu.solver.lane_fused import make_pallas_exchange
from seigen_tpu.solver.lane_fused import make_trace_exchange as jexchange
from seigen_tpu_torch.ops.fused_kernels import build_fused_data
from seigen_tpu_torch.ops.fused_ops import stress2_op_ref, vel2_op_ref
from seigen_tpu_torch.ops.structured_exchange import \
    detect_structured as tdetect
from seigen_tpu_torch.solver.lane_fused import FusedLaneRunner, \
    build_exchange_plan, trace_exchange_ref
from seigen_tpu_torch.solver.lane_major import LaneMajorRunner
from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner


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


MAT = (1.0, 2.0, 1.0)  # rho, vp, vs
SIDES3 = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
RUNNER_TOL = 1e-6  # JAX runner's float32 host rounding, see the docstring


def _meshes(topo, degree, bounded=True):
    """(JAX, port) discretisations of one topology expression, e.g.
    "box_mesh(3, 3, 3)"; bounded: free top, absorbing elsewhere."""
    out = []
    for pkg, sol in ((jmesh, jsol), (tmesh, tsol)):
        t = eval(f"pkg.{topo}")
        kw = {}
        if bounded:
            dim = t.dim
            kw["bc_fn"] = sol.absorbing_bc_fn(((0.0, 1.0),) * dim,
                                              free_sides=[(dim - 1, "hi")])
        out.append(pkg.build_discrete(t, degree, **kw))
    return out


def _params(dm_j, dm_t):
    return (jops.build_params(dm_j, jops.Material(*MAT), dtype=jnp.float64),
            tops.build_params(dm_t, tops.Material(*MAT), dtype=torch.float64,
                              device="cpu"))


def _sources(dm_j, dm_t, pos, f0=4.0, radius=0.25):
    return (jsol.build_sources(dm_j, [jsol.PointSource(
                position=pos, f0=f0, radius=radius)], dtype=jnp.float64),
            tsol.build_sources(dm_t, [tsol.PointSource(
                position=pos, f0=f0, radius=radius)], dtype=torch.float64,
                device="cpu"))


def _random_state(E, n_p, dim, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, n_p, dim)),
            rng.standard_normal((E, n_p, 3 if dim == 2 else 6)))


def _run_both(jr, tr, u, s, n_steps, step0=0):
    out_j, seis_j = jr.run(jsol.State(u=jnp.asarray(u), s=jnp.asarray(s)),
                           n_steps, step0=step0)
    out_t, seis_t = tr.run(tsol.State(u=torch.as_tensor(u),
                                      s=torch.as_tensor(s)), n_steps,
                           step0=step0)
    return out_j, seis_j, out_t, seis_t


def _close_to_scale(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), (
        np.abs(a - b).max() / np.abs(b).max())


def _random_stiffness(E, n_sig, seed):
    """Isotropic plus a per-element NON-symmetric perturbation: a C[c, k] /
    C[k, c] swap or a transposed strain index hides behind a symmetric
    one; the isotropic part keeps a few steps stable."""
    from seigen_tpu_torch.ops.anisotropic import iso_stiffness

    rng = np.random.default_rng(seed)
    return (iso_stiffness(2.0, 1.0, 3 if n_sig == 6 else 2)[None]
            + 0.2 * rng.standard_normal((E, n_sig, n_sig)))


# ---------------------------------------------------------------------------
# 1-2. operators and their data


@pytest.fixture(scope="module")
def op_case():
    """box_mesh(3, 3, 3) P2, sponge; JAX and port v2 runners, isotropic and
    with a stiffness (their operator data only)."""
    dm_j, dm_t = _meshes("box_mesh(3, 3, 3)", 2)
    p_j, p_t = _params(dm_j, dm_t)
    damp = tsol.sponge_mask(dm_t, SIDES3, width=0.3)
    C = _random_stiffness(dm_t.num_elements, 6, 3)
    runners = {}
    for key, stiff in (("iso", None), ("C", C)):
        runners[key] = (
            JaxRunner(p_j, jdetect(dm_j), 0.01, damp=jnp.asarray(damp),
                      block=8, interpret=True, stiffness=stiff),
            FusedLaneRunner(p_t, tdetect(dm_t), 0.01, damp=damp,
                            stiffness=stiff))
    return runners


@pytest.mark.parametrize("law", ["iso", "C"])
def test_operator_data_matches_jax(op_case, law):
    jr, tr = op_case[law]
    E = tr.d.E
    assert jr.E == E and jr.E_pad > E  # the JAX lanes are padded to 8
    assert tr.d.off == jr.d.off
    for name in ("geo", "damp"):
        np.testing.assert_allclose(
            getattr(tr.d, name).numpy(),
            np.asarray(getattr(jr.d, name))[:, :E], rtol=1e-13, atol=1e-15,
            err_msg=name)
    for name in ("drr", "lift"):
        np.testing.assert_allclose(getattr(tr.d, name).numpy(),
                                   np.asarray(getattr(jr.d, name)),
                                   rtol=1e-13, atol=1e-15, err_msg=name)


@pytest.mark.parametrize("law,op,variant", [
    ("iso", "vel", "plain"), ("iso", "vel", "axpy"),
    ("iso", "stress", "plain"), ("iso", "stress", "axpy"),
    ("iso", "stress", "axpy_damp"), ("C", "stress", "plain"),
    ("C", "stress", "axpy_damp")])
def test_operators_match_jax(op_case, law, op, variant):
    jr, tr = op_case[law]
    dj, dt_ = jr.d, tr.d
    if variant == "axpy":  # the update without a sponge
        dj, dt_ = (dataclasses.replace(x, damp=None) for x in (dj, dt_))
    E, E_pad = tr.d.E, jr.E_pad
    rng = np.random.default_rng(11)

    def rows(C, used, pad):
        a = rng.standard_normal((C, pad, E))
        a[:, used:] = 0.0
        return a.reshape(C * pad, E)

    c_in, c_out = ((dt_.n_sig, dt_.dim) if op == "vel"
                   else (dt_.dim, dt_.n_sig))
    x = rows(c_in, dt_.n_p, dt_.npp)
    trs = rows(dt_.dim, dt_.ftp, dt_.ftpp)
    pair = [rows(c_out, dt_.n_p, dt_.npp) for _ in range(2)]

    def jpad(a):
        return jnp.asarray(np.pad(a, ((0, 0), (0, E_pad - E))))

    jkw, tkw = {}, {}
    if variant.startswith("axpy"):
        jkw = dict(axpy=tuple(jpad(a) for a in pair), dt=0.013,
                   c3=0.013**3 / 24)
        tkw = dict(axpy=tuple(torch.as_tensor(a) for a in pair), dt=0.013,
                   c3=0.013**3 / 24)
    jop, top = (vel2_op, vel2_op_ref) if op == "vel" else (stress2_op,
                                                          stress2_op_ref)
    got = top(dt_, torch.as_tensor(x), torch.as_tensor(trs), **tkw)
    # jitted: one compile in place of the eager per-op compiles (the
    # arrays ride as arguments, the floats as constants)
    arrays = {k: jkw.pop(k) for k in ("axpy",) if k in jkw}
    ref = jax.jit(lambda a, t, kw: jop(dj, a, t, block=8, interpret=True,
                                       **kw, **jkw))(
        jpad(x), jpad(trs), arrays)
    for g, r in zip(got, ref):  # the field, then its emitted traces
        np.testing.assert_allclose(g.numpy(), np.asarray(r)[:, :E],
                                   rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# 3. the trace exchange


@pytest.mark.parametrize("topo,degree,bounded", [
    ("box_mesh(3, 3, 3)", 2, True),
    ("rect_mesh(4, 4)", 2, True),
    ("box_mesh(2, 2, 2, periodic=(0, 1, 2))", 2, False),
    ("rect_mesh(4, 4, periodic=(0, 1))", 2, False),
    ("box_mesh(2, 16, 16)", 1, True)],
    ids=["bounded3d", "bounded2d", "periodic3d", "periodic2d", "period2"])
def test_exchange_matches_jax_loop_exchange(topo, degree, bounded):
    dm_j, dm_t = _meshes(topo, degree, bounded)
    p_j, p_t = _params(dm_j, dm_t)
    dj, dt_ = jfused_data(p_j), build_fused_data(p_t)
    E = dm_t.num_elements
    tr = np.random.default_rng(3).standard_normal((dt_.dim * dt_.ftpp, E))
    for negate in (True, False):
        # jitted: one compile in place of the eager per-op compiles
        ref = jax.jit(jexchange(jdetect(dm_j), dj, dj.dim, E, E, negate))(
            jnp.asarray(tr))
        got = trace_exchange_ref(build_exchange_plan(tdetect(dm_t), dt_),
                                 torch.as_tensor(tr), negate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_exchange_matches_jax_pallas_exchange():
    """box_mesh(4, 4, 8): NC = 128, the smallest grid the Pallas kernel's
    block rule admits; traction traces (sign and boundary select)."""
    dm_j, dm_t = _meshes("box_mesh(4, 4, 8)", 1)
    p_j, p_t = _params(dm_j, dm_t)
    dj, dt_ = jfused_data(p_j), build_fused_data(p_t)
    E = dm_t.num_elements
    tr = np.random.default_rng(4).standard_normal((dt_.dim * dt_.ftpp, E))
    xp = make_pallas_exchange(jdetect(dm_j), dj, dj.dim, E, E, True,
                              interpret=True)
    assert xp is not None
    got = trace_exchange_ref(build_exchange_plan(tdetect(dm_t), dt_),
                             torch.as_tensor(tr), True)
    # jitted: one compile in place of the eager per-op compiles
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.jit(xp)(jnp.asarray(tr))),
                               rtol=1.2e-7, atol=0)


# ---------------------------------------------------------------------------
# 4. the runner against the JAX runner


def _half_periodic(topo, degree):
    """(JAX, port) discretisations periodic along every axis but the last,
    which has a free top and an absorbing bottom: one run crosses the wrap
    and the boundary faces."""
    out = []
    for pkg, sol in ((jmesh, jsol), (tmesh, tsol)):
        t = eval(f"pkg.{topo}")
        out.append(pkg.build_discrete(t, degree, bc_fn=sol.absorbing_bc_fn(
            ((0.0, 1.0),) * t.dim, free_sides=[(t.dim - 1, "hi")])))
    return out


def test_runner_matches_jax_full_pipeline():
    """box_mesh(3, 3, 3) P1 periodic in x and y: blob source, sponge at the
    bottom, 3 receivers with pressure, a per-element stiffness (the full
    pipeline and the periodic 3D case of tests/test_fused.py in one JAX
    compile).  The isotropic bounded pipeline is held to the port's merged
    and v1 runners at 1e-10 below."""
    dm_j, dm_t = _half_periodic("box_mesh(3, 3, 3, periodic=(0, 1))", 1)
    p_j, p_t = _params(dm_j, dm_t)
    src_j, src_t = _sources(dm_j, dm_t, (0.5, 0.5, 0.7))
    pts = tsol.line((0.2, 0.5, 0.9), (0.8, 0.5, 0.9), 3)
    rcv_j = jsol.build_receivers(dm_j, pts, dtype=jnp.float64)
    rcv_t = tsol.build_receivers(dm_t, pts, dtype=torch.float64,
                                 device="cpu")
    damp = tsol.sponge_mask(dm_t, [(2, "lo")], width=0.3)
    assert damp.min() < 1.0
    dt = tsol.cfl_dt(dm_t.h.min(), 2.0, 1, 0.4)
    C = _random_stiffness(dm_t.num_elements, 6, 5)
    jr = JaxRunner(p_j, jdetect(dm_j), dt, src=src_j, damp=jnp.asarray(damp),
                   receivers=rcv_j, record_pressure=True, block=8,
                   interpret=True, stiffness=C)
    tr = FusedLaneRunner(p_t, tdetect(dm_t), dt, src=src_t, damp=damp,
                         receivers=rcv_t, record_pressure=True, stiffness=C)
    assert tr.impl == "reference"
    u, s = _random_state(dm_t.num_elements, p_t.n_p, 3)
    out_j, seis_j, out_t, seis_t = _run_both(jr, tr, u, s, 5)
    _close_to_scale(out_t.u.numpy(), out_j.u, RUNNER_TOL)
    _close_to_scale(out_t.s.numpy(), out_j.s, RUNNER_TOL)
    assert seis_t.shape == (5, 3, 4)  # 3 velocity columns + pressure
    _close_to_scale(seis_t, seis_j, RUNNER_TOL)


def test_runner_matches_jax_2d_p3_step0():
    """rect_mesh(4, 4) P3 periodic in x, with a source from rest, the
    wavelet phase started at step0 = 0 and at step0 = 5 (one JAX runner
    for both; the periodic 2D and bounded 2D P3 cases of
    tests/test_fused.py in one JAX compile)."""
    dm_j, dm_t = _half_periodic("rect_mesh(4, 4, periodic=(0,))", 3)
    p_j, p_t = _params(dm_j, dm_t)
    src_j, src_t = _sources(dm_j, dm_t, (0.5, 0.7), radius=0.3)
    dt = tsol.cfl_dt(dm_t.h.min(), 2.0, 3, 0.4)
    jr = JaxRunner(p_j, jdetect(dm_j), dt, src=src_j, block=8,
                   interpret=True)
    tr = FusedLaneRunner(p_t, tdetect(dm_t), dt, src=src_t)
    E = dm_t.num_elements
    u, s = np.zeros((E, p_t.n_p, 2)), np.zeros((E, p_t.n_p, 3))
    outs = []
    for step0 in (0, 5):
        out_j, _, out_t, _ = _run_both(jr, tr, u, s, 4, step0=step0)
        assert np.abs(np.asarray(out_j.u)).max() > 0
        _close_to_scale(out_t.u.numpy(), out_j.u, RUNNER_TOL)
        _close_to_scale(out_t.s.numpy(), out_j.s, RUNNER_TOL)
        outs.append(out_t.u)
    assert not torch.allclose(outs[0], outs[1])


# ---------------------------------------------------------------------------
# 5. the port's own engines at f64


@pytest.fixture(scope="module", params=["3d", "2d"])
def bounded_case(request):
    """Port-only bounded cases with a free top: box_mesh(3, 3, 3) P1 and
    rect_mesh(4, 4) P2, each with a blob source, a sponge on the other
    sides and 3 receivers."""
    if request.param == "3d":
        topo, degree, pos = "box_mesh(3, 3, 3)", 1, (0.5, 0.5, 0.7)
        sides = SIDES3
        pts = tsol.line((0.2, 0.5, 0.9), (0.8, 0.5, 0.9), 3)
    else:
        topo, degree, pos = "rect_mesh(4, 4)", 2, (0.5, 0.7)
        sides = [(0, "lo"), (0, "hi"), (1, "lo")]
        pts = tsol.line((0.2, 0.9), (0.8, 0.9), 3)
    t = eval(f"tmesh.{topo}")
    dm = tmesh.build_discrete(t, degree, bc_fn=tsol.absorbing_bc_fn(
        ((0.0, 1.0),) * t.dim, free_sides=[(t.dim - 1, "hi")]))
    p = tops.build_params(dm, tops.Material(*MAT), dtype=torch.float64,
                          device="cpu")
    src = tsol.build_sources(dm, [tsol.PointSource(
        position=pos, f0=4.0, radius=0.25)], dtype=torch.float64,
        device="cpu")
    rcv = tsol.build_receivers(dm, pts, dtype=torch.float64, device="cpu")
    damp = tsol.sponge_mask(dm, sides, width=0.3)
    dt = tsol.cfl_dt(dm.h.min(), 2.0, degree, 0.4)
    return dm, p, src, rcv, damp, dt


def test_runner_matches_merged_and_v1_runners(bounded_case):
    """Also the merged runner's record_pressure, in 2D and 3D."""
    dm, p, src, rcv, damp, dt = bounded_case
    ex = tdetect(dm)
    u, s = _random_state(dm.num_elements, p.n_p, dm.dim, seed=9)
    st = tsol.State(u=torch.as_tensor(u), s=torch.as_tensor(s))
    kw = dict(src=src, damp=damp, receivers=rcv, record_pressure=True)
    out, seis = FusedLaneRunner(p, ex, dt, **kw).run(st, 4)
    assert seis.shape == (4, 3, dm.dim + 1)
    for other in (MergedLaneRunner(p, ex, dt, **kw),
                  LaneMajorRunner(p, ex, dt, order=4, **kw)):
        ref, seis_ref = other.run(st, 4)
        np.testing.assert_allclose(out.u.numpy(), ref.u.numpy(),
                                   rtol=1e-10, atol=1e-11)
        np.testing.assert_allclose(out.s.numpy(), ref.s.numpy(),
                                   rtol=1e-10, atol=1e-11)
        np.testing.assert_allclose(seis, seis_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("topo,degree", [
    ("box_mesh(2, 2, 2, periodic=(0, 1, 2))", 3),
    ("rect_mesh(4, 4, periodic=(0, 1))", 2)], ids=["3d", "2d"])
def test_runner_matches_v1_runner_periodic(topo, degree):
    dm = tmesh.build_discrete(eval(f"tmesh.{topo}"), degree)
    p = tops.build_params(dm, tops.Material(*MAT), dtype=torch.float64,
                          device="cpu")
    ex = tdetect(dm)
    dt = tsol.cfl_dt(dm.h.min(), 2.0, degree, 0.4)
    u, s = _random_state(dm.num_elements, p.n_p, dm.dim, seed=10)
    st = tsol.State(u=torch.as_tensor(u), s=torch.as_tensor(s))
    out, _ = FusedLaneRunner(p, ex, dt).run(st, 4)
    ref, _ = LaneMajorRunner(p, ex, dt, order=4).run(st, 4)
    np.testing.assert_allclose(out.u.numpy(), ref.u.numpy(), rtol=1e-10,
                               atol=1e-11)
    np.testing.assert_allclose(out.s.numpy(), ref.s.numpy(), rtol=1e-10,
                               atol=1e-11)


# ---------------------------------------------------------------------------
# 6. refusals


def test_refusals(bounded_case):
    dm, p, *_ = bounded_case
    ex = tdetect(dm)
    with pytest.raises(ValueError, match="CUDA"):
        FusedLaneRunner(p, ex, 0.01, impl="kernel")
    with pytest.raises(ValueError, match="LF4"):
        FusedLaneRunner(p, ex, 0.01, order=2)
