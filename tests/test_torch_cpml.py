"""The port's C-PML (ops/cpml.py, solver/pml.py, solver/lane_cpml.py) vs
the JAX package, at f64 on the CPU.

1. The direction-split operators equal JAX's on rect_mesh(4, 4) and
   box_mesh(2, 2, 2) P2 with a free top (rtol 1e-10), and their sums
   reproduce the port's unsplit einsum operators.
2. The einsum ``run_cpml`` for 6 steps equals JAX's ``run_cpml`` on the
   meshes of tests/test_cpml.py (rect_mesh(6, 6), box_mesh(3, 3, 3) P2,
   heterogeneous material, a mollified source, C-PML on the non-free
   sides, receivers): rtol 1e-9, atol 1e-11 x max.  One JAX run per
   dimension (a module fixture) serves 2 and 3.
3. ``CpmlLaneRunner`` on the plain K1/K2 versions against the same JAX
   run, same tolerances, seismograms included.
4. Zero profiles keep the memory fields exactly zero (einsum on a
   periodic mesh, the lane runner on a bounded one); a step makes
   exactly 4 x 2 x dim plain operator calls and no axpy variant; the
   field-only source scatter (``_inject`` with tr=None) equals the field
   part of the field-and-traces one; impl="kernel" on CPU tensors and
   packed=True raise.
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
from seigen_tpu.ops import cpml as jcpml
from seigen_tpu.solver import pml as jpml
from seigen_tpu_torch.ops import cpml as tcpml
from seigen_tpu_torch.ops.elastic import apply_stress_op, apply_vel_op
from seigen_tpu_torch.ops.structured_exchange import detect_structured


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


MAT = (1.2, 2.0, 1.1)  # rho, vp, vs
N_STEPS = 6


def _meshes(name, *size, free=True, **kw):
    """The JAX and the port's DiscreteMesh of one P2 mesh, free top and
    absorbing elsewhere (free=False: no BC function)."""
    out = []
    for mesh, sol in ((jmesh, jsol), (tmesh, tsol)):
        topo = getattr(mesh, name)(*size, **kw)
        dim = len(size)
        bc = sol.absorbing_bc_fn([(0.0, 1.0)] * dim, [(dim - 1, "hi")]) \
            if free else None
        out.append(mesh.build_discrete(topo, 2, bc_fn=bc))
    return out


def _params(dm_j, dm_t, rho, vp, vs):
    """JAX and port ElasticParams of one material at f64 (the port's on the
    CPU)."""
    return (jops.build_params(dm_j, jops.Material(rho, vp, vs),
                              dtype=jnp.float64),
            tops.build_params(dm_t, tops.Material(rho, vp, vs),
                              dtype=torch.float64, device="cpu"))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("dim", [2, 3])
def test_split_operators_match_jax(dim):
    dm_j, dm_t = (_meshes("rect_mesh", 4, 4) if dim == 2
                  else _meshes("box_mesh", 2, 2, 2))
    p_j, p_t = _params(dm_j, dm_t, *MAT)
    E, n_p, n_sig = dm_t.num_elements, dm_t.re.n_p, p_t.n_sig
    rng = np.random.default_rng(0)
    s = rng.standard_normal((E, n_p, n_sig))
    u = rng.standard_normal((E, n_p, dim))
    st, ut = torch.as_tensor(s), torch.as_tensor(u)

    v_t = tcpml.apply_vel_op_split(p_t, st)
    g_t = tcpml.apply_grad_op_split(p_t, ut)
    np.testing.assert_allclose(
        v_t.numpy(), np.asarray(jcpml.apply_vel_op_split(p_j, s)),
        rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        g_t.numpy(), np.asarray(jcpml.apply_grad_op_split(p_j, u)),
        rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        tcpml.hooke_pointwise(p_t, g_t).numpy(),
        np.asarray(jcpml.hooke_pointwise(p_j, g_t.numpy())),
        rtol=1e-10, atol=1e-10)
    # the splits sum to the unsplit operators
    np.testing.assert_allclose(
        (p_t.inv_rho[:, None, None] * v_t.sum(dim=1)).numpy(),
        apply_vel_op(p_t, st).numpy(), atol=1e-12)
    np.testing.assert_allclose(
        tcpml.hooke_pointwise(p_t, g_t).numpy(),
        apply_stress_op(p_t, ut).numpy(), atol=1e-12)


CASE = dict(width=0.3, vp_max=3.0, f0=4.0)


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def jax_case(request):
    """The case of tests/test_cpml.py:test_lane_cpml_matches_einsum_scan
    with receivers: one JAX einsum run_cpml per dimension, the port's
    inputs of the same case, and the numpy-seeded state."""
    dim = request.param
    rng = np.random.default_rng(7)
    if dim == 2:
        dm_j, dm_t = _meshes("rect_mesh", 6, 6)
        sides = [(0, "lo"), (0, "hi"), (1, "lo")]
        pos = (0.55, 0.6)
    else:
        dm_j, dm_t = _meshes("box_mesh", 3, 3, 3)
        sides = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
        pos = (0.5, 0.5, 0.6)
    E, n_p = dm_t.num_elements, dm_t.re.n_p
    n_sig = 3 if dim == 2 else 6
    p_j, p_t = _params(dm_j, dm_t, 1.0 + rng.random(E), 2.0 + rng.random(E),
                       0.8 + 0.3 * rng.random(E))
    h = float(dm_t.h.min())
    dt = tsol.cfl_dt(h, 3.0, 2, 0.2)
    point = dict(position=pos, f0=CASE["f0"], t0=0.15, amplitude=50.0,
                 radius=2 * h)
    rec = tsol.line([0.2] * dim, [0.8] * (dim - 1) + [0.9], 3)
    src_j = jsol.build_sources(dm_j, [jsol.PointSource(**point)],
                               dtype=jnp.float64)
    rcv_j = jsol.build_receivers(dm_j, rec, dtype=jnp.float64)
    dprof, aprof = jpml.cpml_profiles(dm_j, sides, CASE["width"],
                                      CASE["vp_max"], f0=CASE["f0"])
    rhs = jpml.make_cpml_rhs(p_j, dprof, aprof, src=src_j)
    u0 = 0.01 * rng.standard_normal((E, n_p, dim))
    s0 = 0.01 * rng.standard_normal((E, n_p, n_sig))
    fin, seis = jpml.run_cpml(
        p_j, jpml.cpml_init(p_j, jnp.asarray(u0), jnp.asarray(s0)), dt,
        N_STEPS, rhs, receivers=rcv_j)
    return dict(
        dm=dm_t, p=p_t, sides=sides, dprof=dprof, aprof=aprof, dt=dt,
        src=tsol.build_sources(dm_t, [tsol.PointSource(**point)],
                               dtype=torch.float64, device="cpu"),
        rcv=tsol.build_receivers(dm_t, rec, dtype=torch.float64,
                                 device="cpu"),
        u0=torch.as_tensor(u0), s0=torch.as_tensor(s0),
        u=np.asarray(fin.u), s=np.asarray(fin.s), pv=np.asarray(fin.pv),
        ps=np.asarray(fin.ps), seis=np.asarray(seis))


def _close(got, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(_np(got), ref, rtol=1e-9, atol=1e-11 * scale)


def test_run_cpml_matches_jax(jax_case):
    c = jax_case
    p = c["p"]
    dprof, aprof = tsol.cpml_profiles(c["dm"], c["sides"], CASE["width"],
                                      CASE["vp_max"], f0=CASE["f0"])
    np.testing.assert_allclose(dprof, c["dprof"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(aprof, c["aprof"], rtol=1e-12, atol=1e-12)
    rhs = tsol.make_cpml_rhs(p, dprof, aprof, src=c["src"])
    fin, seis = tsol.run_cpml(p, tsol.cpml_init(p, c["u0"], c["s0"]),
                              c["dt"], N_STEPS, rhs, receivers=c["rcv"])
    for name in ("u", "s", "pv", "ps"):
        _close(getattr(fin, name), c[name])
    _close(seis, c["seis"])


def test_lane_runner_matches_jax(jax_case):
    c = jax_case
    lr = tsol.CpmlLaneRunner(c["p"], c["dm"], detect_structured(c["dm"]),
                             c["dt"], c["sides"], CASE["width"],
                             CASE["vp_max"], f0=CASE["f0"], src=c["src"],
                             receivers=c["rcv"])
    assert lr.impl == "reference" and lr.src_dense is None
    st, seis = lr.run(tsol.State(u=c["u0"], s=c["s0"]), N_STEPS)
    _close(st.u, c["u"])
    _close(st.s, c["s"])
    _close(seis, c["seis"])


def _small_lane_runner():
    """The port's rect_mesh(4, 4) P2 case (free top) and the profile
    arguments of a C-PML on its three other sides."""
    _, dm = _meshes("rect_mesh", 4, 4)
    p = tops.build_params(dm, tops.Material(*MAT), dtype=torch.float64,
                          device="cpu")
    return dm, p, dict(sides=[(0, "lo"), (0, "hi"), (1, "lo")], width=0.3,
                       vp_max=2.0)


def _random_state(p, seed):
    rng = np.random.default_rng(seed)
    E = p.Ginv.shape[0]
    return tsol.State(
        u=torch.as_tensor(rng.standard_normal((E, p.n_p, p.dim))),
        s=torch.as_tensor(rng.standard_normal((E, p.n_p, p.n_sig))))


def test_zero_profiles_keep_memory_zero():
    # einsum, periodic
    _, dm = _meshes("rect_mesh", 4, 4, free=False, periodic=(0, 1))
    p = tops.build_params(dm, tops.Material(*MAT), dtype=torch.float64,
                          device="cpu")
    st = _random_state(p, 1)
    z = np.zeros((dm.num_elements, p.n_p, 2))
    dt = tsol.cfl_dt(dm.h.min(), 2.0, 2, 0.3)
    fin, _ = tsol.run_cpml(p, tsol.cpml_init(p, st.u, st.s), dt, 10,
                           tsol.make_cpml_rhs(p, z, z))
    assert fin.pv.abs().max().item() == 0.0
    assert fin.ps.abs().max().item() == 0.0
    assert torch.isfinite(fin.u).all()
    # lane runner, bounded: no sides, no memory
    dm, p, kw = _small_lane_runner()
    kw["sides"] = []
    lr = tsol.CpmlLaneRunner(p, dm, detect_structured(dm), dt, **kw)
    carry, _ = lr.run_lm(lr.init_carry(_random_state(p, 2)), 4)
    assert carry[2].abs().max().item() == 0.0
    assert carry[3].abs().max().item() == 0.0
    assert torch.isfinite(carry[0]).all()


def test_lane_runner_operator_calls_per_step():
    """Each step: 4 stages x (dim K1 + dim K2) plain operator calls, on
    the direction-masked operator data, and no axpy/inject variant."""
    dm, p, kw = _small_lane_runner()
    lr = tsol.CpmlLaneRunner(p, dm, detect_structured(dm), 1e-3, **kw)
    calls = []

    def counted(op, name):
        def f(plan, d, x, trs, mask, **extra):
            assert not extra, extra
            calls.append((name, d))
            return op(plan, d, x, trs, mask)
        return f

    lr._vel_op = counted(lr._vel_op, "vel")
    lr._stress_op = counted(lr._stress_op, "stress")
    lr.run_lm(lr.init_carry(_random_state(p, 3)), 2)
    assert len(calls) == 2 * 4 * 2 * p.dim
    assert sum(n == "vel" for n, _ in calls) == len(calls) // 2
    assert all(any(d is dk for dk in lr._d_dir) for _, d in calls)
    # the masked geo zeroes the other directions' Ginv and normal rows
    o_ginv, o_nrm = lr.d.off[:2]
    for k, dk in enumerate(lr._d_dir):
        for r in range(p.dim):
            for d in range(p.dim):
                row = dk.geo[o_ginv + r * p.dim + d]
                assert (row == lr.d.geo[o_ginv + r * p.dim + d]).all() \
                    if d == k else (row == 0).all()
            sec = dk.geo[o_nrm + 8 * r : o_nrm + 8 * r + 8]
            assert (sec == lr.d.geo[o_nrm + 8 * r : o_nrm + 8 * r + 8]
                    ).all() if r == k else (sec == 0).all()


def test_field_only_inject_equals_field_part():
    dm, p, kw = _small_lane_runner()
    src = tsol.build_sources(
        dm, [tsol.PointSource(position=(0.4, 0.5), f0=3.0, radius=0.2),
             tsol.PointSource(position=(0.6, 0.4), f0=2.0, radius=0.2,
                              kind="force", direction=(1.0, 1.0))],
        dtype=torch.float64, mat=tops.Material(*MAT), device="cpu")
    lr = tsol.CpmlLaneRunner(p, dm, detect_structured(dm), 1e-3, src=src,
                             **kw)
    ulm, slm = lr.to_lm_state(_random_state(p, 4))
    tr = lr.traction_traces(slm)
    for part, field in ((0, ulm), (1, slm)):
        both, tr_out = lr._inject(field, tr, part, 0.31)
        alone, none = lr._inject(field, None, part, 0.31)
        assert none is None and not torch.equal(tr_out, tr)
        assert torch.equal(alone, both) and not torch.equal(alone, field)


def test_lane_runner_refusals():
    dm, p, kw = _small_lane_runner()
    ex = detect_structured(dm)
    with pytest.raises(ValueError):
        tsol.CpmlLaneRunner(p, dm, ex, 1e-3, impl="kernel", **kw)
    with pytest.raises(ValueError):
        tsol.CpmlLaneRunner(p, dm, ex, 1e-3, packed=True, **kw)
