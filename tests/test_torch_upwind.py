"""The port's upwind (Godunov) operators, viscoelastic Q and eigenmode tools
against the JAX package (f64, CPU).

1. ``build_upwind_data``, ``build_upwind_rows`` and ``build_visco`` give the
   JAX arrays exactly; ``upwind_data_from_numpy``/``visco_from_numpy`` carry
   them across.
2. The einsum oracle ``apply_coupled_upwind`` and the anelastic rates
   (standard and lane-major) match their JAX counterparts on numpy-seeded
   inputs, with an acoustic (vs = 0) zone in half the box.
3. ``upwind_rhs_merged_ref`` (the CPU path of K3) matches the JAX merged
   Pallas kernel ``upwind_rhs_merged`` in interpret mode with 0, 1 and 2
   dense source groups on ``box_mesh(3, 3, 3)`` P2 with the same zone.  The
   JAX runner's lane block (9) divides NC = 27, so both packages use the
   same lane layout and the outputs AND the payload trace arrays compare
   row for row.
4. ``PlaneWave``, ``l2_error``, ``staggered_init`` and the eigenmode path:
   the port's ``run_rk4`` gives the JAX L2 errors on periodic 2D P2 meshes
   and the q+1 order.

Tolerance: rtol 1e-10, atol 1e-12 * max|ref| (f64 roundoff of differently
ordered sums).
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
from seigen_tpu.ops import viscoelastic as jvis
from seigen_tpu.ops.structured_exchange import detect_structured as jdetect
from seigen_tpu.ops.upwind_kernels import build_upwind_rows as jrows
from seigen_tpu.ops.upwind_kernels import upwind_rhs_merged as jrhs
from seigen_tpu.solver.damping import absorbing_bc_fn
from seigen_tpu.solver.lane_upwind import UpwindLaneRunner as JaxRunner
from seigen_tpu.solver.rk4 import run_rk4 as jrun_rk4
from seigen_tpu.solver.timestep import staggered_init as jstaggered
from seigen_tpu_torch.ops import viscoelastic as tvis
from seigen_tpu_torch.ops.structured_exchange import \
    detect_structured as tdetect
from seigen_tpu_torch.ops.upwind_kernels import (
    UPWIND_KERNEL,
    build_upwind_rows,
    upwind_rhs_merged,
    upwind_rhs_merged_ref,
)
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


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=1e-12 * np.abs(ref).max())


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def case(request):
    """Free top, absorbing sides, rigid nothing; vs = 0 where x < 0.5."""
    dim = request.param
    ext = ((0.0, 1.0),) * dim
    bc = absorbing_bc_fn(ext, free_sides=[(dim - 1, "hi")])
    if dim == 3:
        topo_j, topo_t = jmesh.box_mesh(3, 3, 3), tmesh.box_mesh(3, 3, 3)
    else:
        topo_j, topo_t = jmesh.rect_mesh(4, 4), tmesh.rect_mesh(4, 4)
    dm_j = jmesh.build_discrete(topo_j, 2, bc_fn=bc)
    dm_t = tmesh.build_discrete(topo_t, 2, bc_fn=bc)
    vs = np.where(dm_j.coords.mean(axis=1)[:, 0] < 0.5, 0.0, 1.0)
    mj, mt = jops.Material(1.0, 2.0, vs), tops.Material(1.0, 2.0, vs)
    p_j = jops.build_params(dm_j, mj, dtype=jnp.float64)
    p_t = tops.build_params(dm_t, mt, dtype=torch.float64, device="cpu")
    w_j = jops.build_upwind_data(dm_j, mj, dtype=jnp.float64)
    w_t = tops.build_upwind_data(dm_t, mt, dtype=torch.float64, device="cpu")
    return dm_j, p_j, p_t, w_j, w_t


def test_upwind_data_matches_jax(case):
    _, _, _, w_j, w_t = case
    ref = _fields(w_j)
    for name, a in ref.items():
        np.testing.assert_array_equal(getattr(w_t, name).numpy(), a, name)
    carried = tops.upwind_data_from_numpy(ref, "cpu", torch.float64)
    for name, a in ref.items():
        np.testing.assert_array_equal(getattr(carried, name).numpy(), a)
    np.testing.assert_array_equal(build_upwind_rows(w_t), jrows(w_j))


def test_visco_data_matches_jax(case):
    _, p_j, p_t, _, _ = case
    v_j = jvis.build_visco(p_j, 30.0, 20.0, 1.0, 8.0, L=3)
    v_t = tvis.build_visco(p_t, 30.0, 20.0, 1.0, 8.0, L=3)
    assert v_t.L == v_j.L == 3
    for name in ("omegas", "y_kappa", "y_mu"):
        np.testing.assert_array_equal(getattr(v_t, name).numpy(),
                                      np.asarray(getattr(v_j, name)), name)
        np.testing.assert_array_equal(
            getattr(tops.visco_from_numpy(_fields(v_j), "cpu",
                                          torch.float64), name).numpy(),
            np.asarray(getattr(v_j, name)))
    w, y = tvis.fit_anelastic_unit(1.0, 8.0, 3)
    np.testing.assert_array_equal(
        tvis.model_q_inv(w, y, [1.0, 3.0, 8.0]),
        jvis.model_q_inv(*jvis.fit_anelastic_unit(1.0, 8.0, 3),
                         [1.0, 3.0, 8.0]))


def test_apply_coupled_upwind_matches_jax(case):
    dm_j, p_j, p_t, w_j, w_t = case
    E, n_p, dim, n_sig = p_t.Ginv.shape[0], p_t.n_p, p_t.dim, p_t.n_sig
    rng = np.random.default_rng(4)
    u = rng.standard_normal((E, n_p, dim))
    s = rng.standard_normal((E, n_p, n_sig))
    gather = [rng.standard_normal((E, p_t.n_faces * p_t.n_fp, C))
              for C in (dim, n_sig)]
    ref = jops.apply_coupled_upwind(p_j, w_j, *(jnp.asarray(a) for a in (
        u, s, *gather)))
    got = tops.apply_coupled_upwind(p_t, w_t, *(torch.as_tensor(a) for a in (
        u, s, *gather)))
    for g, r in zip(got, ref):
        _close(g, r)


def test_anelastic_rates_match_jax(case):
    _, p_j, p_t, _, _ = case
    v_j = jvis.build_visco(p_j, 30.0, 20.0, 1.0, 8.0, L=2)
    v_t = tvis.build_visco(p_t, 30.0, 20.0, 1.0, 8.0, L=2)
    E, n_p, dim, n_sig = p_t.Ginv.shape[0], p_t.n_p, p_t.dim, p_t.n_sig
    rng = np.random.default_rng(5)
    ds = rng.standard_normal((E, n_p, n_sig))
    xi = rng.standard_normal((E, n_p, n_sig, 2))
    got = tvis.anelastic_rates(v_t, torch.as_tensor(ds),
                               torch.as_tensor(xi), dim)
    ref = jvis.anelastic_rates(v_j, jnp.asarray(ds), jnp.asarray(xi), dim)
    for g, r in zip(got, ref):
        _close(g, r)
    # lane-major twin on (rows, lanes) arrays
    npp, Ls = 8 * ((n_p + 7) // 8), 13
    ds_lm = rng.standard_normal((n_sig * npp, Ls))
    xi_lm = rng.standard_normal((2, n_sig * npp, Ls))
    yk, ym = (rng.standard_normal((2, 1, Ls)) for _ in range(2))
    om = np.array(v_j.omegas)
    got = tvis.anelastic_rates_lm(*(torch.as_tensor(a) for a in (
        ds_lm, xi_lm, yk, ym, om)), dim, n_sig, npp)
    ref = jvis.anelastic_rates_lm(*(jnp.asarray(a) for a in (
        ds_lm, xi_lm, yk, ym, om)), dim, n_sig, npp)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.fixture(scope="module")
def rhs_case():
    """JAX and port upwind runners on box_mesh(3, 3, 3) P2 (vs = 0 where
    x < 0.5) for their plans, operator data and impedance rows; numpy-seeded
    operands in the shared lane layout."""
    ext = ((0.0, 1.0),) * 3
    bc = absorbing_bc_fn(ext, free_sides=[(2, "hi")])
    dm_j = jmesh.build_discrete(jmesh.box_mesh(3, 3, 3), 2, bc_fn=bc)
    dm_t = tmesh.build_discrete(tmesh.box_mesh(3, 3, 3), 2, bc_fn=bc)
    vs = np.where(dm_j.coords.mean(axis=1)[:, 0] < 0.5, 0.0, 1.0)
    mj, mt = jops.Material(1.0, 2.0, vs), tops.Material(1.0, 2.0, vs)
    jr = JaxRunner(
        jops.build_params(dm_j, mj, dtype=jnp.float64), jdetect(dm_j),
        jops.build_upwind_data(dm_j, mj, dtype=jnp.float64), 0.01, block=9,
        interpret=True)
    p_t = tops.build_params(dm_t, mt, dtype=torch.float64, device="cpu")
    tr = UpwindLaneRunner(
        p_t, tdetect(dm_t),
        tops.build_upwind_data(dm_t, mt, dtype=torch.float64, device="cpu"),
        0.01)
    assert (jr.plan.NCs, jr.plan.NCt, jr.plan.h0) == (27, 27, 0)
    assert (tr.plan.Ls, tr.plan.rtf, tr.plan.pay) == (
        jr.plan.Ls, jr.plan.rtf, jr.plan.pay)
    np.testing.assert_array_equal(tr.uwg.numpy(), np.asarray(jr.uwg))
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))

    d, plan = tr.d, tr.plan
    rng = np.random.default_rng(11)

    def field(C, used, rows, n=1):
        a = rng.standard_normal((n, C, rows, plan.Ls))
        a[:, :, used:] = 0.0  # dead node / pad trace rows are zero
        return a.reshape(n, C * rows, plan.Ls)

    data = {
        "u": field(d.dim, d.n_p, d.npp)[0],
        "s": field(d.n_sig, d.n_p, d.npp)[0],
        "trs": field(d.nf, 2 * d.dim * d.n_fp, plan.rtf)[0],
        "Su": field(d.dim, d.n_p, d.npp, 2),
        "Ss": field(d.n_sig, d.n_p, d.npp, 2),
    }
    return jr, tr, data


@pytest.mark.parametrize("n_inj", [0, 1, 2])
def test_upwind_rhs_matches_jax_kernel(rhs_case, n_inj):
    jr, tr, x = rhs_case
    rs = (0.7, -1.3)
    j_inj = [(jnp.asarray(x["Su"][g]), jnp.asarray(x["Ss"][g]),
              jnp.full((8, tr.plan.Ls), rs[g], jnp.float64))
             for g in range(n_inj)]
    t_inj = [(torch.as_tensor(x["Su"][g]), torch.as_tensor(x["Ss"][g]), rs[g])
             for g in range(n_inj)]
    ref = jrhs(jr.plan, jr.d, jr.uwg, jnp.asarray(x["u"]),
               jnp.asarray(x["s"]), jnp.asarray(x["trs"]), jr.mask,
               interpret=True, inject=j_inj)
    got = upwind_rhs_merged_ref(
        tr.plan, tr.d, tr.uwg, torch.as_tensor(x["u"]),
        torch.as_tensor(x["s"]), torch.as_tensor(x["trs"]), tr.mask,
        inject=t_inj)
    for g, r in zip(got, ref):  # du, ds, payload traces
        _close(g, r)


def test_upwind_kernel_refuses_cpu_tensors(rhs_case):
    """On the CPU the dispatch goes to the plain version and never reaches
    the kernel; the kernel wrapper itself takes CUDA tensors only."""
    _, tr, x = rhs_case
    args = (tr.plan, tr.d, tr.uwg, torch.as_tensor(x["u"]),
            torch.as_tensor(x["s"]), torch.as_tensor(x["trs"]), tr.mask)
    n0 = UPWIND_KERNEL.launches
    for a, b in zip(upwind_rhs_merged(*args), upwind_rhs_merged_ref(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        UPWIND_KERNEL(*args)
    assert UPWIND_KERNEL.launches == n0


def _eigen_errors_jax(Ns, pw, T):
    errs = []
    for N in Ns:
        dm = jmesh.build_discrete(jmesh.rect_mesh(N, N, periodic=(0, 1)), 2)
        mat = jops.Material(1.0, 2.0, 1.0)
        p = jops.build_params(dm, mat, dtype=jnp.float64)
        w = jops.build_upwind_data(dm, mat, dtype=jnp.float64)
        dt = jsol.cfl_dt(dm.h.min(), 2.0, 2, 0.4)
        n = int(np.ceil(T / dt))
        st = jsol.State(u=jnp.asarray(jsol.interpolate(dm, pw.u, 0.0)),
                        s=jnp.asarray(jsol.interpolate(dm, pw.sigma, 0.0)))
        fin, _ = jrun_rk4(p, w, st, T / n, n)
        errs.append(jsol.l2_error(dm, np.asarray(fin.u), pw.u, T))
    return errs


def test_eigenmode_errors_match_jax():
    """Upwind RK4 on a travelling S wave over one period, 2D P2 periodic
    rect_mesh(4, 4) and (8, 8): the port's errors are the JAX errors, and
    the observed order is the scheme's q+1 (bar of tests/test_upwind.py)."""
    mat = tops.Material(1.0, 2.0, 1.0)
    k = 2 * np.pi * np.array([1.0, 1.0])
    pw = tsol.PlaneWave(mat=mat, k=k, mode="S")
    pw_j = jsol.PlaneWave(mat=jops.Material(1.0, 2.0, 1.0), k=k, mode="S")
    T = pw.period
    assert T == pw_j.period
    x = np.random.default_rng(2).random((5, 2))
    np.testing.assert_array_equal(pw.u(x, 0.3), pw_j.u(x, 0.3))
    np.testing.assert_array_equal(pw.sigma(x, 0.3), pw_j.sigma(x, 0.3))
    errs, hs = [], []
    for N in (4, 8):
        dm = tmesh.build_discrete(tmesh.rect_mesh(N, N, periodic=(0, 1)), 2)
        p = tops.build_params(dm, mat, dtype=torch.float64, device="cpu")
        w = tops.build_upwind_data(dm, mat, dtype=torch.float64, device="cpu")
        dt = tsol.cfl_dt(dm.h.min(), 2.0, 2, 0.4)
        n = int(np.ceil(T / dt))
        st = tsol.State(u=torch.as_tensor(tsol.interpolate(dm, pw.u, 0.0)),
                        s=torch.as_tensor(tsol.interpolate(dm, pw.sigma, 0.0)))
        fin, _ = tsol.run_rk4(p, w, st, T / n, n)
        errs.append(tsol.l2_error(dm, fin.u, pw.u, T))
        hs.append(1.0 / N)
        assert tsol.l2_norm(dm, fin.u) > 0
    np.testing.assert_allclose(errs, _eigen_errors_jax((4, 8), pw_j, T),
                               rtol=RTOL)
    order = tsol.convergence_order(hs, errs)
    assert order > 2.7, (errs, order)


def test_staggered_init_matches_jax(case):
    dm_j, p_j, p_t, _, _ = case
    E, n_p, dim, n_sig = p_t.Ginv.shape[0], p_t.n_p, p_t.dim, p_t.n_sig
    rng = np.random.default_rng(6)
    u = rng.standard_normal((E, n_p, dim))
    s = rng.standard_normal((E, n_p, n_sig))
    for order in (2, 4):
        got = tsol.staggered_init(p_t, torch.as_tensor(u),
                                  torch.as_tensor(s), 0.01, order=order)
        ref = jstaggered(p_j, jnp.asarray(u), jnp.asarray(s), 0.01,
                         order=order)
        _close(got.u, ref.u)
        _close(got.s, ref.s)
