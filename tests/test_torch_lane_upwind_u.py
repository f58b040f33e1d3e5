"""The port's unstructured upwind-RK4 path (CPU, plain versions) against
the JAX package, f64, on scrambled ``box_mesh(3, 3, 3)`` P2 and
``rect_mesh(5, 4)`` P2 (the cases of tests/test_upwind_lane_u.py).

1. The runner's host rows (impedances, sign rows with the folded ghosts,
   combo codes, dense source patterns) equal the JAX runner's exactly on
   the E real lanes.
2. ``upwind_rhs_lm_sel_ref`` and ``upwind_rhs_lm_sel_axpy_ref`` against the
   JAX kernels in interpret mode (``block=8``), numpy-seeded inputs: 3D,
   2D and an acoustic (vs = 0) half; stage, final, final + damp, 1 and 2
   dense groups, ``emit=True`` in both modes with the emitted-layout
   select plan (2D P2: ftp = 9, ftpp = 16, so a wrong component stride
   shows).  rtol 1e-10.
3. ``UnstructuredUpwindRunner(impl="reference")`` against the JAX runner
   (``interpret=True, block=8``) and the port's einsum ``run_rk4`` /
   ``run_rk4_visco``: 3D with source, sponge and receivers; viscoelastic;
   2D mixed BCs; the three-wavelet scatter fallback; ``panel_emit`` (2D
   with source and receivers, 3D without sources and with the resume
   seam); the glue ladder; ``run_xi`` chunks resume bitwise.
4. ``impl="kernel"`` refuses CPU tensors; the emission gate raises; the
   bench measures ``upwind_lane_u`` on the CPU.
"""

import dataclasses
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
from seigen_tpu.ops import pallas_kernels as jpk
from seigen_tpu.ops.viscoelastic import build_visco as jvisco
from seigen_tpu.solver.lane_upwind_u import \
    UnstructuredUpwindRunner as JaxRunner
from seigen_tpu_torch.bench import throughput as tbench
from seigen_tpu_torch.ops import lane_upwind_kernels as luk
from seigen_tpu_torch.ops.viscoelastic import build_visco as tvisco
from seigen_tpu_torch.solver.lane_upwind_u import UnstructuredUpwindRunner


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
JAX = (jmesh, jops, jsol, jnp.float64, {})
PORT = (tmesh, tops, tsol, torch.float64, {"device": "cpu"})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rtol=RTOL):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=rtol,
                               atol=1e-12 * np.abs(ref).max())


def _case(pkg, dim, seed, acoustic=False, n_src=1):
    """Scrambled mesh, params, impedances, sources, receivers, sponge and
    dt of one package: the 3D and 2D cases of tests/test_upwind_lane_u.py
    (``acoustic``: vs = 0 where x < 0.5; ``n_src`` = 3: distinct
    wavelets)."""
    mesh, ops, sol, dtype, dev = pkg
    topo = mesh.box_mesh(3, 3, 3) if dim == 3 else mesh.rect_mesh(5, 4)
    perm = np.random.default_rng(seed).permutation(topo.num_cells)
    topo = dataclasses.replace(topo, cells=topo.cells[perm], structure=None)
    dm = mesh.build_discrete(
        topo, 2, bc_fn=sol.absorbing_bc_fn(
            ((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")]))
    vs = 1.0
    if acoustic:
        vs = np.where(np.asarray(dm.coords).mean(axis=1)[:, 0] < 0.5, 0.0,
                      1.0)
    mat = ops.Material(1.0, 2.0, vs)
    p = ops.build_params(dm, mat, dtype=dtype, **dev)
    w = ops.build_upwind_data(dm, mat, dtype=dtype, **dev)
    if dim == 3:
        pts = [sol.PointSource(position=(0.5, 0.5, 0.7), f0=4.0,
                               radius=0.25)]
        ends, sides = ((0.2, 0.5, 0.9), (0.8, 0.5, 0.9)), [(0, "lo"),
                                                          (0, "hi")]
    else:
        pts = [sol.PointSource(position=(0.5, 0.5), f0=4.0, radius=0.25)]
        ends, sides = ((0.2, 0.8), (0.8, 0.8)), [(0, "lo")]
        if n_src == 3:
            pts = [sol.PointSource(position=pos, f0=f0, t0=t0, radius=0.2)
                   for pos, f0, t0 in (((0.35, 0.5), 4.0, 0.3),
                                       ((0.65, 0.5), 5.0, 0.25),
                                       ((0.5, 0.3), 6.0, 0.2))]
    src = sol.build_sources(dm, pts, dtype=dtype, **dev)
    rcv = sol.build_receivers(dm, sol.line(*ends, 3), dtype=dtype, **dev)
    damp = sol.sponge_mask(dm, sides, width=0.3)
    dt = sol.cfl_dt(dm.h.min(), 2.0, 2, 0.25)
    return dm, p, w, src, rcv, damp, dt


@functools.cache
def _cases(dim, seed=None, acoustic=False, n_src=1):
    seed = (11 if dim == 3 else 7) if seed is None else seed
    return (_case(JAX, dim, seed, acoustic, n_src),
            _case(PORT, dim, seed, acoustic, n_src))


def _runners(dim, seed=None, acoustic=False, n_src=1, src=False, damp=False,
             rcv=False, visco=False, **opts):
    """(JAX runner, port runner, dm, dt) on one case; ``src``/``damp``/
    ``rcv``/``visco`` switch the case's pieces on."""
    (dm_j, p_j, w_j, src_j, rcv_j, dmp, dt), (
        dm_t, p_t, w_t, src_t, rcv_t, _, _) = _cases(dim, seed, acoustic,
                                                     n_src)
    cent = np.asarray(dm_j.coords).mean(axis=1)
    vj = jvisco(p_j, 30.0, 20.0, 1.0, 10.0) if visco else None
    vt = tvisco(p_t, 30.0, 20.0, 1.0, 10.0) if visco else None
    jr = JaxRunner(p_j, w_j, dt, src=src_j if src else None,
                   damp=jnp.asarray(dmp) if damp else None,
                   receivers=rcv_j if rcv else None, block=8,
                   interpret=True, visco=vj, centroids=cent, **opts)
    tr = UnstructuredUpwindRunner(
        p_t, w_t, dt, src=src_t if src else None,
        damp=dmp if damp else None, receivers=rcv_t if rcv else None,
        visco=vt, centroids=cent, **opts)
    assert tr.impl == "reference"
    return jr, tr, dm_t, dt


def _state(dm, dim, seed=3):
    E, n_p = dm.num_elements, dm.re.n_p
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, n_p, dim)),
            rng.standard_normal((E, n_p, 3 if dim == 2 else 6)))


# ---------------------------------------------------------------------------
# 1. host rows


@pytest.mark.parametrize("dim,n_src", [(3, 1), (2, 1), (2, 3)])
def test_host_rows_match_jax(dim, n_src):
    jr, tr, _, _ = _runners(dim, n_src=n_src, seed=11 if n_src == 3 else None,
                            src=True, damp=True)
    E = tr.E
    np.testing.assert_array_equal(tr._old_of_new, jr._old_of_new)
    for got, ref in zip(tr.uw, (jr.zpn, jr.zsn, jr.zown)):
        np.testing.assert_array_equal(_np(got), _np(ref)[:, :E])
    np.testing.assert_array_equal(_np(tr.sign_u), _np(jr.sign_u)[:, :E])
    np.testing.assert_array_equal(_np(tr.sign_t), _np(jr.sign_t)[:, :E])
    np.testing.assert_array_equal(_np(tr.combo), _np(jr._pg_u[1])[:, :E])
    assert tr.selcfg == jr._pg_u[3]
    # both sign rows carry a boundary and an interior value
    assert set(np.unique(_np(tr.sign_t)[: dim + 1])) >= {-1.0, 0.0}
    if n_src == 3:  # more than two wavelets: the scatter fallback
        assert tr.src_dense is None and jr.src_dense is None
        return
    assert len(tr.src_dense) == len(jr.src_dense) == 1
    # the two packages' SourceData differ in the last bit in 2D, so the
    # patterns equal the JAX runner's to 1e-13 and, exactly, the JAX
    # formula applied to the port's own sources
    src = _cases(dim)[1][3]
    lanes = tr._new_of_old[src.elems.numpy()]
    for got, ref, vec in zip(tr.src_dense[0], jr.src_dense[0],
                             (src.vec_u, src.vec_s)):
        np.testing.assert_allclose(_np(got), _np(ref)[:, :E], rtol=1e-13,
                                   atol=0)
        own = np.zeros((vec.shape[2], tr.d.npp, E))
        for k, lane in enumerate(lanes):
            own[:, : tr.d.n_p, lane] += (vec[k] * src.amp[k]).numpy().T
        np.testing.assert_array_equal(_np(got), own.reshape(-1, E))
    np.testing.assert_array_equal(
        _np(tr.damp_u[: tr.d.npp]), _np(jr._aux()["damp_row"])[:, :E])


# ---------------------------------------------------------------------------
# 2. the plain operators against the JAX kernels (interpret mode)


@functools.cache
def _op_case(dim, acoustic=False):
    """Runners' operator data and numpy-seeded operands in the gathered
    and in the emitted panel layout."""
    jr, tr, _, _ = _runners(dim, acoustic=acoustic, damp=True)
    d, E, E_pad = tr.d, tr.E, jr.E_pad
    C, nf, nfp, ftp, ftpp, rows_pad, fc, pm = tr.selcfg
    cfg_e = (C, nf, nfp, ftpp, ftpp, C * ftpp, fc, pm)
    rng = np.random.default_rng(dim + 10 * acoustic)
    nu, ns = d.dim * d.npp, d.n_sig * d.npp

    def rows(n, used=None, sect=None):
        a = rng.standard_normal((n, E))
        if used is not None:  # zero pad rows of every (sect)-row section
            a.reshape(-1, sect, E)[:, used:] = 0.0
        return a

    x = {"u": rows(nu, d.n_p, d.npp), "s": rows(ns, d.n_p, d.npp),
         "pu": rows(nf * rows_pad), "pt": rows(nf * rows_pad),
         "pu_e": rows(nf * C * ftpp), "pt_e": rows(nf * C * ftpp),
         "bu": rows(nu, d.n_p, d.npp), "bs": rows(ns, d.n_p, d.npp),
         "au": rows(nu, d.n_p, d.npp), "as": rows(ns, d.n_p, d.npp),
         "Su": [rows(nu, d.n_p, d.npp) for _ in range(2)],
         "Ss": [rows(ns, d.n_p, d.npp) for _ in range(2)]}
    return jr, tr, cfg_e, x, E, E_pad


def _j(a, E_pad):
    """numpy (rows, E) -> JAX (rows, E_pad), dead lanes zero."""
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, E_pad - a.shape[1])))


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("dim,acoustic", [(3, False), (2, False), (3, True)],
                         ids=["3d", "2d", "3d-acoustic"])
def test_rhs_ref_matches_jax_kernel(dim, acoustic):
    jr, tr, _, x, E, E_pad = _op_case(dim, acoustic)
    if acoustic:  # faces with Zs- + Zs+ = 0 exist, and elastic ones too
        zs_sum = _np(tr.uw[2])[1] + _np(tr.uw[1])[: tr.d.ftp]
        assert (zs_sum == 0).any() and (zs_sum > 0).any()
    ref = jpk.upwind_rhs_lm_sel(
        jr.d, (jr.zpn, jr.zsn, jr.zown), *(_j(x[k], E_pad) for k in
                                           ("u", "s", "pu", "pt")),
        jr._pg_u[1], jr.sign_u, jr.sign_t, jr._pg_u[3], 8, True)
    args = (tr.d, tr.uw, *(_t(x[k]) for k in ("u", "s", "pu", "pt")),
            tr.combo, tr.sign_u, tr.sign_t, tr.selcfg)
    got = luk.upwind_rhs_lm_sel_ref(*args)
    _close(got, _np(ref)[:, :E])
    # on CPU tensors the public operator is its plain version
    assert luk.lane_upwind_op("upwind_rhs_lm_sel", "reference") \
        is luk.upwind_rhs_lm_sel_ref
    np.testing.assert_array_equal(luk.upwind_rhs_lm_sel(*args).numpy(),
                                  got.numpy())


AXPY_MODES = {  # name -> (stage, damp, dense groups, emit)
    "stage": (True, False, 0, False),
    "final": (False, False, 0, False),
    "final_damp": (False, True, 0, False),
    "stage_inject1": (True, False, 1, False),
    "final_damp_inject2": (False, True, 2, False),
    "stage_emit": (True, False, 0, True),
    "final_damp_emit": (False, True, 0, True),
}


@pytest.mark.parametrize("dim,mode", [
    *((2, m) for m in AXPY_MODES), (3, "stage_inject1"),
    (3, "final_damp_emit"), (3, "stage_emit")])
def test_axpy_ref_matches_jax_kernel(dim, mode):
    stage, damp, n_inj, emit = AXPY_MODES[mode]
    jr, tr, cfg_e, x, E, E_pad = _op_case(dim)
    d = tr.d
    if dim == 2:
        assert d.ftp != d.ftpp  # the two panel layouts differ
    pu, pt = ("pu_e", "pt_e") if emit else ("pu", "pt")
    cs, wa, r = 0.37, 0.21, (0.7, -1.3)
    jdamp = jr._aux()["damp_row"] if damp else None
    ref = jpk.upwind_rhs_lm_sel_axpy(
        jr.d, (jr.zpn, jr.zsn, jr.zown),
        *(_j(x[k], E_pad) for k in ("u", "s", pu, pt)), jr._pg_u[1],
        jr.sign_u, jr.sign_t, cfg_e if emit else jr._pg_u[3],
        _j(x["au"], E_pad), _j(x["as"], E_pad), wa,
        _j(x["bu"], E_pad) if stage else None,
        _j(x["bs"], E_pad) if stage else None, cs if stage else None,
        [(_j(x["Su"][g], E_pad), _j(x["Ss"][g], E_pad),
          jnp.full((8, E_pad), r[g])) for g in range(n_inj)],
        jdamp, 8, True, emit=emit)
    args = (d, tr.uw, *(_t(x[k]) for k in ("u", "s", pu, pt)), tr.combo,
            tr.sign_u, tr.sign_t, cfg_e if emit else tr.selcfg,
            _t(x["au"]), _t(x["as"]), wa)
    kw = dict(base_u=_t(x["bu"]) if stage else None,
              base_s=_t(x["bs"]) if stage else None,
              cs=cs if stage else None,
              inject=[(_t(x["Su"][g]), _t(x["Ss"][g]), r[g])
                      for g in range(n_inj)],
              damp_row=tr.damp_u[: d.npp] if damp else None, emit=emit)
    got = luk.upwind_rhs_lm_sel_axpy_ref(*args, **kw)
    rows = (2 if stage else 1) * (d.dim + d.n_sig) * d.npp \
        + (2 * d.dim * d.ftpp if emit else 0)
    assert got.shape == (rows, E)
    _close(got, _np(ref)[:, :E])
    np.testing.assert_array_equal(
        luk.upwind_rhs_lm_sel_axpy(*args, **kw).numpy(), got.numpy())


def test_epilogue_arguments_are_checked():
    _, tr, _, x, _, _ = _op_case(2)
    args = (tr.d, tr.uw, *(_t(x[k]) for k in ("u", "s", "pu", "pt")),
            tr.combo, tr.sign_u, tr.sign_t, tr.selcfg, _t(x["au"]),
            _t(x["as"]), 0.1)
    with pytest.raises(ValueError, match="together"):
        luk.upwind_rhs_lm_sel_axpy(*args, base_u=_t(x["bu"]))
    with pytest.raises(ValueError, match="final mode"):
        luk.upwind_rhs_lm_sel_axpy(
            *args, base_u=_t(x["bu"]), base_s=_t(x["bs"]), cs=0.5,
            damp_row=tr.damp_u[: tr.d.npp])
    with pytest.raises(ValueError, match="CUDA"):
        luk.LANE_UPWIND_AXPY(*args)
    with pytest.raises(ValueError, match="CUDA"):
        luk.LANE_UPWIND_RHS(*args[:10])


# ---------------------------------------------------------------------------
# 3. the runner


def _run_both(jr, tr, dm, dim, n, step0=0):
    u, s = _state(dm, dim)
    out_j, seis_j = jr.run(jsol.State(u=jnp.asarray(u), s=jnp.asarray(s)),
                           n, step0=step0)
    st = tsol.State(u=_t(u), s=_t(s))
    out_t, seis_t = tr.run(st, n, step0=step0)
    _close(out_t.u, out_j.u)
    _close(out_t.s, out_j.s)
    if seis_j is not None:
        _close(seis_t, seis_j)
    return st, out_t, seis_t


def _einsum(dim, st, dt, n, src=False, damp=False, rcv=False, visco=None,
            **case):
    _, (_, p, w, s, r, dmp, _) = _cases(dim, **case)
    kw = dict(src=s if src else None,
              damp=_t(dmp) if damp else None,
              receivers=r if rcv else None)
    if visco is not None:
        ref, _, seis = tsol.run_rk4_visco(p, w, visco, st, dt, n, **kw)
        return ref, seis
    return tsol.run_rk4(p, w, st, dt, n, **kw)


def test_runner_3d_full_matches_jax_and_einsum():
    jr, tr, dm, dt = _runners(3, src=True, damp=True, rcv=True)
    assert tr.fused_axpy and tr.src_dense is not None
    st, out, seis = _run_both(jr, tr, dm, 3, 3)
    ref, seis_ref = _einsum(3, st, dt, 3, src=True, damp=True, rcv=True)
    _close(out.u, ref.u)
    _close(out.s, ref.s)
    _close(seis, seis_ref)
    assert seis.shape == (3, 3, 3)


def test_runner_3d_visco_matches_jax_and_einsum():
    jr, tr, dm, dt = _runners(3, src=True, damp=True, rcv=True, visco=True)
    assert not tr.fused_axpy and tr.src_dense is None
    st, out, seis = _run_both(jr, tr, dm, 3, 3)
    ref, seis_ref = _einsum(3, st, dt, 3, src=True, damp=True, rcv=True,
                            visco=tr.visco)
    _close(out.u, ref.u)
    _close(out.s, ref.s)
    _close(seis, seis_ref)


def test_runner_2d_mixed_bcs_matches_jax_and_einsum():
    jr, tr, dm, dt = _runners(2)
    st, out, _ = _run_both(jr, tr, dm, 2, 3)
    ref, _ = _einsum(2, st, dt, 3)
    _close(out.u, ref.u)
    _close(out.s, ref.s)


def test_runner_scatter_fallback_matches_jax_and_einsum():
    """Three wavelets: column scatters after each launch, the sponge after
    the last scatter."""
    jr, tr, dm, dt = _runners(2, seed=11, n_src=3, src=True, damp=True)
    assert tr.fused_axpy and tr.src_dense is None and len(
        tr._src_groups) == 3
    st, out, _ = _run_both(jr, tr, dm, 2, 4)
    assert np.abs(out.u.numpy()).max() > 0
    ref, _ = _einsum(2, st, dt, 4, src=True, damp=True, seed=11, n_src=3)
    _close(out.u, ref.u)
    _close(out.s, ref.s)


def test_runner_panel_emit_2d_matches_jax_and_glue():
    opts = dict(src=True, damp=True, rcv=True)
    jr, tr, dm, dt = _runners(2, panel_emit=True, **opts)
    assert tr.panel_emit and tr.src_dense is not None
    assert tr._selcfg_e == jr._selcfg_e and tr._selcfg_e[3] != tr.selcfg[3]
    st, out, seis = _run_both(jr, tr, dm, 2, 4, step0=1)
    _, glue, _, _ = _runners(2, fused_axpy=False, **opts)
    assert not glue.fused_axpy
    out_g, seis_g = glue.run(st, 4, step0=1)
    _close(out.u, out_g.u)
    _close(out.s, out_g.s)
    _close(seis, seis_g)


def test_runner_panel_emit_3d_resume_and_glue_match_jax():
    """3D emission without sources, with the resume seam (the panels are
    rebuilt from the state at every run entry); then the glue ladder on
    the same case against the JAX glue ladder."""
    jr, tr, dm, dt = _runners(3, panel_emit=True)
    st, out, _ = _run_both(jr, tr, dm, 3, 4)
    mid, _ = tr.run(st, 2)
    res, _ = tr.run(mid, 2, step0=2)
    np.testing.assert_array_equal(res.u.numpy(), out.u.numpy())
    np.testing.assert_array_equal(res.s.numpy(), out.s.numpy())
    ref, _ = _einsum(3, st, dt, 4)
    _close(out.u, ref.u)
    _close(out.s, ref.s)


def test_runner_glue_matches_jax():
    jr, tr, dm, _ = _runners(2, src=True, damp=True, fused_axpy=False)
    assert not tr.fused_axpy and tr.src_dense is None
    _run_both(jr, tr, dm, 2, 3)


def test_run_xi_chunks_resume_bitwise():
    _, tr, dm, _ = _runners(3, src=True, damp=True, visco=True)
    u, s = _state(dm, 3)
    st = tsol.State(u=_t(u), s=_t(s))
    full, xi_f, _ = tr.run_xi(st, None, 4)
    half, xi_h, _ = tr.run_xi(st, None, 2)
    res, xi_r, _ = tr.run_xi(half, xi_h, 2, step0=2)
    assert xi_f.shape == (dm.num_elements, tr.d.n_p, 6, tr.visco.L)
    np.testing.assert_array_equal(res.u.numpy(), full.u.numpy())
    np.testing.assert_array_equal(res.s.numpy(), full.s.numpy())
    np.testing.assert_array_equal(xi_r.numpy(), xi_f.numpy())
    np.testing.assert_array_equal(
        tr.xi_from_lm(tr.xi_to_lm(xi_f)).numpy(), xi_f.numpy())


# ---------------------------------------------------------------------------
# 4. refusals and the bench


def test_kernel_impl_and_emission_gate_refuse():
    _, (dm, p, w, _, _, _, dt) = _cases(2)
    _, (_, _, _, src3, _, _, _) = _cases(2, seed=11, n_src=3)
    with pytest.raises(ValueError, match="CUDA"):
        UnstructuredUpwindRunner(p, w, dt, impl="kernel")
    with pytest.raises(ValueError, match="fused-axpy"):
        UnstructuredUpwindRunner(p, w, dt, fused_axpy=False,
                                 panel_emit=True)
    with pytest.raises(ValueError, match="fused-axpy"):
        UnstructuredUpwindRunner(p, w, dt, panel_emit=True,
                                 visco=tvisco(p, 30.0, 20.0, 1.0, 10.0))
    with pytest.raises(ValueError, match="dense source groups"):
        UnstructuredUpwindRunner(p, w, dt, src=src3, panel_emit=True)


@pytest.mark.parametrize("opts", [{}, {"panel_emit": True},
                                  {"fused_axpy": False}],
                         ids=["fused", "emit", "glue"])
def test_bench_measures_upwind_lane_u_on_cpu(opts):
    dm, p, src, damp, dt, st = tbench.setup_case(
        n=2, degree=2, dtype=torch.float64, device="cpu", scramble=True)
    res = tbench.measure(p, src, damp, dt, st, dm, n_steps=2,
                         impl="upwind_lane_u", kernel_impl="reference",
                         **opts)
    assert res.n_dof == dm.num_elements * dm.re.n_p * 9
    assert np.isfinite(res.dof_updates_per_sec) and res.seconds > 0
    assert tbench.scheme_name("upwind_lane_u", 4) == "RK4"
    assert tbench.scheme_name("lane_u", 4) == "LF4"


@pytest.mark.parametrize("dim,degree", [(3, 3), (3, 2), (2, 1)])
def test_lane_tile_table_holds_dr_and_lift(dim, degree):
    """LaneOpData.ktile, the K7 tile kernel's product table in float32:
    row j*dim + r holds Dr_r[:, j], row dim*n_p + q holds LIFT[:, q], the
    node index padded to a multiple of 4 with zeros."""
    from seigen_tpu_torch.ops.lane_kernels import build_lane_data

    topo = tmesh.box_mesh(1, 1, 1) if dim == 3 else tmesh.rect_mesh(2, 2)
    p = tops.build_params(tmesh.build_discrete(topo, degree),
                          tops.Material(1.0, 2.0, 1.0), device="cpu")
    d = build_lane_data(p)
    Dr = p.Dr.double().numpy().astype(np.float32)
    LIFT = p.LIFT.double().numpy().astype(np.float32)
    n_p = Dr.shape[1]
    assert d.ktile.dtype == torch.float32 and d.ktile.is_contiguous()
    tab = d.ktile.numpy()
    assert tab.shape == (dim * n_p + LIFT.shape[1], -(-n_p // 4) * 4)
    for r in range(dim):
        for j in range(n_p):
            np.testing.assert_array_equal(tab[j * dim + r, :n_p], Dr[r, :, j])
    np.testing.assert_array_equal(tab[dim * n_p :, :n_p], LIFT.T)
    assert not tab[:, n_p:].any()
