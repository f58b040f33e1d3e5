"""The packed P1 layout (two elements per lane) of the port against the JAX
package, at f64 on the CPU (the plain versions of K1/K2/K8/K9/K11).

(a) ``build_packed_fused_data`` row for row (exact) in 2D and 3D, and a P2
    mesh raises;
(b) the packed merged plan's links against the JAX ``build_merged_plan(
    n_par=2)``, decoded from its faces, slots and permutation blocks;
(c) every packed ``vel_merged_ref``/``stress_merged_ref`` variant against the
    JAX ``vel_merged``/``stress_merged(interpret=True)`` on box_mesh(2, 2, 2)
    P1, where the JAX runner's lane block is NC, so both packages lay the
    lanes out alike (rtol 1e-10, atol 1e-12: f64 sums in another order);
(d) the packed ``vel2_op_ref``/``stress2_op_ref`` against the JAX packed
    ``vel2_op``/``stress2_op(interpret=True)``, same tolerance;
(e) the P1 pack probe's tables, ``pack_*``/``unpack_state`` and
    ``packed_vel_op_ref`` against ``seigen_tpu/bench/p1_pack_probe.py``, and
    the probe's geo rows as K11 reads them (1/rho at parity stride 4)
    against the unpacked elements' rows;
(f) one JAX ``MergedLaneRunner(packed=True, block=8, interpret=True)`` run
    (box_mesh(2, 2, 2) P1, blob source, sponge, free top, receivers with
    pressure, 4 steps) against the port's packed runner (rtol 1e-10);
(g) the port's packed runner against its unpacked one (held to JAX in
    tests/test_torch_lane_merged.py) in 2D and 3D, bare and full, rtol 1e-10;
(h) the ``"auto"`` rule and the two refusals.

The JAX interpret-mode calls are jitted: their compiles are this file's
time, so each runs once.
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
from seigen_tpu.bench import p1_pack_probe as jprobe
from seigen_tpu.ops.fused_kernels import build_packed_fused_data as jpacked
from seigen_tpu.ops.fused_kernels import stress2_op as jstress2
from seigen_tpu.ops.fused_kernels import vel2_op as jvel2
from seigen_tpu.ops.merged_kernels import build_merged_plan as jplan
from seigen_tpu.ops.merged_kernels import stress_merged as jstress
from seigen_tpu.ops.merged_kernels import vel_merged as jvel
from seigen_tpu.ops.structured_exchange import detect_structured as jdetect
from seigen_tpu.solver.lane_merged import MergedLaneRunner as JaxRunner
from seigen_tpu_torch.bench import p1_pack_probe as tprobe
from seigen_tpu_torch.ops.fused_kernels import (
    build_fused_data,
    build_packed_fused_data,
)
from seigen_tpu_torch.ops.fused_ops import stress2_op_ref, vel2_op_ref
from seigen_tpu_torch.ops.merged_kernels import (
    VEL_KERNEL,
    build_merged_plan,
    stress_merged_ref,
    vel_merged,
    vel_merged_ref,
)
from seigen_tpu_torch.ops.structured_exchange import \
    detect_structured as tdetect
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


RTOL, ATOL = 1e-10, 1e-12
DT, C3 = 0.013, 0.013**3 / 24.0
MAT = (1.0, 2.0, 1.0)


def _meshes(dim, degree=1, bc=False):
    """(JAX discrete mesh, port discrete mesh) of box_mesh(2, 2, 2) or
    rect_mesh(4, 4), with a free top and absorbing sides when ``bc``."""
    ext = ((0.0, 1.0),) * dim
    bc_fn = (jsol.absorbing_bc_fn(ext, free_sides=[(dim - 1, "hi")])
             if bc else None)
    shape = (2, 2, 2) if dim == 3 else (4, 4)
    mk_j = jmesh.box_mesh if dim == 3 else jmesh.rect_mesh
    mk_t = tmesh.box_mesh if dim == 3 else tmesh.rect_mesh
    return (jmesh.build_discrete(mk_j(*shape), degree, bc_fn=bc_fn),
            tmesh.build_discrete(mk_t(*shape), degree, bc_fn=bc_fn))


def _params(dm_j):
    """The JAX parameters and the port's, carried over exactly."""
    p_j = jops.build_params(dm_j, jops.Material(*MAT), dtype=jnp.float64)
    arrays = {f.name: np.asarray(getattr(p_j, f.name))
              for f in dataclasses.fields(p_j)}
    return p_j, tops.params_from_numpy(arrays, "cpu", torch.float64)


def _sponge(dm):
    return tsol.sponge_mask(dm, [(0, "lo"), (0, "hi")], width=0.3)


# --- (a) packed operator data ---------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_packed_fused_data_matches_jax(dim):
    dm_j, dm_t = _meshes(dim, bc=True)
    p_j, p_t = _params(dm_j)
    E = dm_t.num_elements
    perm = np.random.default_rng(dim).permutation(E)
    pair0, pair1 = perm[: E // 2], perm[E // 2 :]
    damp = _sponge(dm_t)
    a = jpacked(p_j, pair0, pair1, damp=jnp.asarray(damp))
    b = build_packed_fused_data(p_t, pair0, pair1, damp=damp)
    for name in ("dim", "n_p", "npp", "ftp", "ftpp", "n_sig", "E", "nf",
                 "n_fp", "off", "n_par"):
        assert getattr(b, name) == getattr(a, name), name
    for name in ("drr", "lift", "geo", "damp", "gexp"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(a, name)),
                                      err_msg=name)
    assert b.tables.dr.shape == (dim, p_t.n_p, p_t.n_p)
    assert b.tables.lift.shape == (p_t.n_p, p_t.n_faces * p_t.n_fp)


def test_packed_fused_data_refuses_p2():
    _, dm_t = _meshes(2, degree=2)
    p_t = tops.build_params(dm_t, tops.Material(*MAT), dtype=torch.float64,
                            device="cpu")
    with pytest.raises(ValueError, match="P1"):
        build_packed_fused_data(p_t, np.array([0]), np.array([1]))


@pytest.fixture(scope="module")
def packed_vs_unpacked():
    """{dim: (packed, unpacked FusedOpData, their parameters)} of one
    free-top, absorbing P1 mesh (box_mesh(2, 2, 2), rect_mesh(4, 4)) with a
    random material per element, so that a row read at the other parity
    shows."""
    out = {}
    for dim in (2, 3):
        ext = ((0.0, 1.0),) * dim
        topo = tmesh.box_mesh(2, 2, 2) if dim == 3 else tmesh.rect_mesh(4, 4)
        dm = tmesh.build_discrete(topo, 1, bc_fn=tsol.absorbing_bc_fn(
            ext, free_sides=[(dim - 1, "hi")]))
        rng = np.random.default_rng(40 + dim)
        E = dm.num_elements
        mat = tops.Material(rng.uniform(1.0, 2.0, E), rng.uniform(3.0, 4.0, E),
                            rng.uniform(1.0, 1.5, E))
        p = tops.build_params(dm, mat, dtype=torch.float64, device="cpu")
        out[dim] = (build_fused_data(p, packed=True), build_fused_data(p), p)
    return out


def _geo_row_map(section, dim, o_pk, o_u, irho_par=1):
    """[(packed row, unpacked row, parity)] of one geo section, as the tile
    kernels' geo_row (csrc/merged_tile.cuh) reads it for the element of
    parity par, from the packed and unpacked offsets o_pk, o_u: ginv o_ginv
    + 2r + par; a face section (normal d of face f, scb, bfs, dfs) its
    unpacked row + par*4; 1/rho o_mat + par*irho_par (FusedOpData 1, the
    pack probe's geo 4); lambda and mu (q = 1, 2) o_mat + 2q + par,
    unpacked o_mat + q."""
    nf = dim + 1
    if section == "ginv":
        return [(o_pk[0] + 2 * r + par, o_u[0] + r, par)
                for r in range(dim * dim) for par in (0, 1)]
    if section == "normals":
        return [(o_pk[1] + 8 * d + 4 * par + f, o_u[1] + 8 * d + f, par)
                for d in range(dim) for f in range(nf) for par in (0, 1)]
    if section in ("scb", "bfs", "dfs"):
        k = ("scb", "bfs", "dfs").index(section) + 2
        return [(o_pk[k] + 4 * par + f, o_u[k] + f, par)
                for f in range(nf) for par in (0, 1)]
    q = ("irho", "lam", "mu").index(section)
    step = irho_par if q == 0 else 1
    return [(o_pk[5] + 2 * q + par * step, o_u[5] + q, par)
            for par in (0, 1)]


@pytest.mark.parametrize("section", ["ginv", "normals", "scb", "bfs", "dfs",
                                     "irho", "lam", "mu"])
@pytest.mark.parametrize("dim", [2, 3])
def test_packed_tile_rows_are_the_unpacked_elements_rows(packed_vs_unpacked,
                                                         dim, section):
    """The rows a parity of the packed tile kernels (K1pk, K2pk, K9pk)
    reads are its element's unpacked rows: packed row r_pk(r, par) at lane
    j equals unpacked row r_u(r) at the lane of element 2j + par, for every
    geo section the tile reads."""
    pk, u, _ = packed_vs_unpacked[dim]
    assert (pk.n_par, u.n_par) == (2, 1)
    got, want = pk.geo.numpy(), u.geo.numpy()
    for r_pk, r_u, par in _geo_row_map(section, dim, pk.off, u.off):
        np.testing.assert_array_equal(got[r_pk], want[r_u, par::2],
                                      err_msg=f"{section} rows {r_pk}, {r_u}")


@pytest.mark.parametrize("section", ["ginv", "normals", "scb", "bfs",
                                     "irho"])
def test_pack_probe_rows_are_the_unpacked_elements_rows(packed_vs_unpacked,
                                                        section):
    """The rows K11 (the packed velocity tile on the P1 pack probe's geo,
    irho_par = 4) reads for the element of parity par are element 2j +
    par's unpacked rows, with a random density per element: the probe
    keeps 1/rho at rows o_irho + par*4 + i (all four), has no dfs section
    (off[4] = -1) and builds its geo in float32 (so the unpacked rows are
    compared rounded to float32)."""
    _, u, p = packed_vs_unpacked[3]
    pr = tprobe.build_packed_vel_data(p)
    assert pr.n_par == 2 and pr.off[4] == -1 and pr.geo.shape[0] == 72
    got = pr.geo.numpy()
    want = u.geo.numpy().astype(np.float32)
    rows = _geo_row_map(section, 3, pr.off, u.off, irho_par=4)
    if section == "irho":
        rows = [(r + i, r_u, par) for r, r_u, par in rows for i in range(4)]
    for r_pr, r_u, par in rows:
        np.testing.assert_array_equal(got[r_pr], want[r_u, par::2],
                                      err_msg=f"{section} rows {r_pr}, {r_u}")
    irho = got[pr.off[5] : pr.off[5] + 8 : 4]
    assert not np.allclose(irho[0], irho[1])


@pytest.mark.parametrize("dim", [2, 3])
def test_packed_v2_trace_rows_are_the_paritys(packed_vs_unpacked, dim):
    """The v2 trace rows the packed tile kernels read and emit at
    c*ftpp + par*NFT + q (NFT = nf*n_fp): the restriction block of the
    packed drr maps row par*ftq + q to node par*4 + fnodes[q], with ftq ==
    nf*n_fp, and no row past 2*ftq (the pad rows) to any node."""
    pk, _, _ = packed_vs_unpacked[dim]
    ftq = pk.nf * pk.n_fp
    assert pk.ftp == 2 * ftq and pk.ftpp >= 2 * ftq
    R = pk.drr.numpy()[pk.dim * pk.npp :]
    want = np.zeros((pk.ftpp, pk.npp))
    fn = np.array(pk.fnodes).reshape(-1)
    for par in (0, 1):
        want[par * ftq + np.arange(ftq), par * 4 + fn] = 1.0
    np.testing.assert_array_equal(R, want)


# --- (b) the packed plan --------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_packed_plan_links_match_jax(dim):
    dm_j, dm_t = _meshes(dim, bc=True)
    p_j, p_t = _params(dm_j)
    ex_j, ex_t = jdetect(dm_j), tdetect(dm_t)
    E = dm_t.num_elements
    d_j = jpacked(p_j, np.arange(0, E, 2), np.arange(1, E, 2))
    d_t = build_packed_fused_data(p_t, np.arange(0, E, 2),
                                  np.arange(1, E, 2))
    NC = int(np.prod(ex_t.grid))
    bx = NC  # one lane block per class: the window offsets are whole classes
    jp = jplan(ex_j, d_j, bx, n_par=2)
    tp = build_merged_plan(ex_t, d_t, n_par=2)
    assert (tp.m, tp.rtf, tp.rtq, tp.n_par, tp.NC) == (
        jp.m, jp.rtf, jp.rtq, 2, jp.NCloc)
    table = tp.table.numpy()
    nfp = ex_t.n_fp
    for u in range(jp.m):
        P = np.asarray(jp.P[u]).reshape(ex_t.n_faces * 2, jp.rtq, jp.rtq)
        for f in range(ex_t.n_faces):
            for par in range(2):
                q = f * 2 + par
                kind, sm, sA, _ = jp.faces[u][q]
                g, u2, oA = jp.slots[u][sA]
                t2, f2 = u2 * 2 + g % 2, g // 2
                pi = P[q, :nfp, :nfp].argmax(axis=1)
                want = [t2, f2, oA * bx + sm, *pi]
                np.testing.assert_array_equal(table[2 * u + par, f], want)
    assert build_merged_plan(dataclasses.replace(ex_t, m=ex_t.m - 1), d_t,
                             n_par=2) is None


# --- (c) the merged operators on packed data --------------------------------

@pytest.fixture(scope="module")
def merged_case():
    """JAX and port packed runners on box_mesh(2, 2, 2) P1 with a sponge
    (lane block = NC = 8) and numpy-seeded f64 operands."""
    dm_j, dm_t = _meshes(3, bc=True)
    p_j, p_t = _params(dm_j)
    damp = _sponge(dm_t)
    jr = JaxRunner(p_j, jdetect(dm_j), DT, block=8, interpret=True,
                   packed=True, damp=jnp.asarray(damp))
    tr = MergedLaneRunner(p_t, tdetect(dm_t), DT, damp=damp, packed=True)
    assert (jr.plan.NCs, jr.plan.NCt, jr.plan.h0) == (8, 8, 0)
    assert tr.plan.Ls == jr.plan.Ls and tr.plan.rtf == jr.plan.rtf
    d, plan = tr.d, tr.plan
    rng = np.random.default_rng(11)

    def field(C, n=1):  # live rows par*4 + i, i < n_p; pad rows zero
        a = rng.standard_normal((n, C, 2, 4, plan.Ls))
        a[:, :, :, d.n_p:] = 0.0
        return a.reshape(n, C * 8, plan.Ls)

    trs = rng.standard_normal((plan.nf, 2, plan.rtq, plan.Ls))
    trs[:, :, d.dim * d.n_fp:] = 0.0
    data = {"sig": field(d.n_sig, 3), "u": field(d.dim, 3),
            "trs": trs.reshape(plan.nf * plan.rtf, plan.Ls),
            "Su": field(d.dim, 2), "Ss": field(d.n_sig, 2)}
    return jr, tr, data


def _variants():
    out = [(op, v) for op in ("vel", "stress")
           for v in ("plain", "axpy", "inject1", "inject2")]
    return out + [("stress", "axpy_damp")]


@pytest.mark.parametrize("op,variant", _variants())
def test_packed_merged_op_matches_jax(merged_case, op, variant):
    jr, tr, data = merged_case
    x = data["sig" if op == "vel" else "u"]
    y = data["u" if op == "vel" else "sig"]  # output-shaped (axpy pair)
    S = data["Su" if op == "vel" else "Ss"]
    jd, td = jr.d, tr.d
    if variant == "axpy":  # the undamped update
        jd, td = (dataclasses.replace(jd, damp=None),
                  dataclasses.replace(td, damp=None))
    rs = (0.7, -1.3)
    jf, tf = (jvel, vel_merged_ref) if op == "vel" else (
        jstress, stress_merged_ref)
    if variant.startswith("axpy"):
        jfn = jax.jit(lambda a, t, b, c: jf(
            jr.plan, jd, a, t, jr.mask, interpret=True, axpy=(b, c), dt=DT,
            c3=C3))
        j_out = jfn(x[0], data["trs"], y[1], y[2])
        tkw = dict(axpy=(torch.as_tensor(y[1]), torch.as_tensor(y[2])),
                   dt=DT, c3=C3)
    else:
        g = int(variant[-1]) if variant.startswith("inject") else 0
        jfn = jax.jit(lambda a, t, *s: jf(
            jr.plan, jd, a, t, jr.mask, interpret=True, inject=[
                (s[i], jnp.full((8, tr.plan.Ls), rs[i], jnp.float64))
                for i in range(g)] or None))
        j_out = jfn(x[0], data["trs"], *S[:g])
        tkw = dict(inject=[(torch.as_tensor(S[i]), rs[i])
                           for i in range(g)] or None)
    t_out = tf(tr.plan, td, torch.as_tensor(x[0]),
               torch.as_tensor(data["trs"]), tr.mask, **tkw)
    for got, want in zip(t_out, j_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_packed_runner_layout_matches_jax(merged_case):
    """Placed geo/damp/mask and the seeded traction traces, row for row;
    the kernel wrapper keeps CPU tensors on the plain version."""
    jr, tr, data = merged_case
    np.testing.assert_array_equal(tr.d.geo.numpy(), np.asarray(jr.d.geo))
    np.testing.assert_array_equal(tr.d.damp.numpy(), np.asarray(jr.d.damp))
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    s = data["sig"][0]
    np.testing.assert_allclose(
        tr.traction_traces(torch.as_tensor(s)).numpy(),
        np.asarray(jr.traction_traces(jnp.asarray(s))), rtol=RTOL, atol=ATOL)
    sig, trs = torch.as_tensor(s), torch.as_tensor(data["trs"])
    n0 = (VEL_KERNEL.launches, VEL_KERNEL.launches_pk)
    out = vel_merged(tr.plan, tr.d, sig, trs, tr.mask)
    ref = vel_merged_ref(tr.plan, tr.d, sig, trs, tr.mask)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        VEL_KERNEL(tr.plan, tr.d, sig.float(), trs.float(),
                   tr.mask.float())
    assert (VEL_KERNEL.launches, VEL_KERNEL.launches_pk) == n0


# --- (d) the v2 operators on packed data ------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_packed_v2_ops_match_jax(dim):
    dm_j, dm_t = _meshes(dim, bc=True)
    p_j, p_t = _params(dm_j)
    E = dm_t.num_elements
    B, damp = E // 2, _sponge(dm_t)
    pairs = (np.arange(0, E, 2), np.arange(1, E, 2))
    dj = jpacked(p_j, *pairs, damp=jnp.asarray(damp))
    dt_ = build_packed_fused_data(p_t, *pairs, damp=damp)
    rng = np.random.default_rng(20 + dim)

    def rows(C, used, pad):
        a = rng.standard_normal((C, 2, pad, B))
        a[:, :, used:] = 0.0
        return a.reshape(C * 2 * pad, B)

    ftq = dt_.ftp // 2
    tr = np.zeros((dim, dt_.ftpp, B))
    tr[:, : dt_.ftp] = rng.standard_normal((dim, dt_.ftp, B))
    tr = tr.reshape(dim * dt_.ftpp, B)
    sig, u = rows(dt_.n_sig, dt_.n_p, 4), rows(dim, dt_.n_p, 4)
    ax_u = (rows(dim, dt_.n_p, 4), rows(dim, dt_.n_p, 4))
    ax_s = (rows(dt_.n_sig, dt_.n_p, 4), rows(dt_.n_sig, dt_.n_p, 4))
    assert ftq == p_t.n_faces * p_t.n_fp
    T = torch.as_tensor
    cases = [
        (lambda: jvel2(dj, sig, tr, block=B, interpret=True),
         lambda: vel2_op_ref(dt_, T(sig), T(tr))),
        (lambda: jvel2(dj, sig, tr, block=B, interpret=True, axpy=ax_u,
                       dt=DT, c3=C3),
         lambda: vel2_op_ref(dt_, T(sig), T(tr), axpy=tuple(map(T, ax_u)),
                             dt=DT, c3=C3)),
        (lambda: jstress2(dj, u, tr, block=B, interpret=True),
         lambda: stress2_op_ref(dt_, T(u), T(tr))),
        (lambda: jstress2(dj, u, tr, block=B, interpret=True, axpy=ax_s,
                          dt=DT, c3=C3),
         lambda: stress2_op_ref(dt_, T(u), T(tr), axpy=tuple(map(T, ax_s)),
                                dt=DT, c3=C3)),
    ]
    for jfn, tfn in cases:
        for got, want in zip(tfn(), jfn()):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)


# --- (e) the P1 pack probe ---------------------------------------------------

def test_pack_probe_matches_jax():
    dm_j, dm_t = _meshes(3)
    p_j, p_t = _params(dm_j)
    E = dm_t.num_elements
    j_drr, j_lift, _, j_gexp, j_geo, j_off = jprobe.build_packed_vel_data(
        p_j)
    d = tprobe.build_packed_vel_data(p_t)
    assert (d.off[1], d.off[2], d.off[3], d.off[5]) == j_off
    for got, want in ((d.drr, j_drr), (d.lift, j_lift), (d.geo, j_geo),
                      (d.gexp[: j_gexp.shape[0], :24], j_gexp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    rng = np.random.default_rng(3)
    sig = rng.standard_normal((E, 4, 6))
    trc = rng.standard_normal((E, 3, 12))
    sig_p, tr_p = tprobe.pack_state(sig, 4), tprobe.pack_traces(trc)
    np.testing.assert_array_equal(sig_p, jprobe.pack_state(sig, 4))
    np.testing.assert_array_equal(tr_p, jprobe.pack_traces(trc))
    np.testing.assert_array_equal(tprobe.unpack_state(sig_p, 4, 6, E), sig)
    np.testing.assert_array_equal(tprobe.unpack_state(sig_p, 4, 6, E),
                                  jprobe.unpack_state(sig_p, 4, 6, E))

    j_out = jprobe.packed_vel_op(
        (j_drr, j_lift, _, j_gexp, j_geo, j_off), jnp.asarray(sig_p),
        jnp.asarray(tr_p), block=E // 2, interpret=True)
    t_out = tprobe.packed_vel_op(d, torch.as_tensor(sig_p),
                                 torch.as_tensor(tr_p))
    for got, want in zip(t_out, j_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    n0 = tprobe.PACK_VEL_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tprobe.PACK_VEL_KERNEL(d, torch.as_tensor(sig_p).float(),
                               torch.as_tensor(tr_p).float())
    assert tprobe.PACK_VEL_KERNEL.launches == n0


# --- (f), (g) the packed runner ---------------------------------------------

N_STEPS = 4


def _runner_case(dim, full, dm):
    """Source, receivers, sponge and state of the runner comparisons."""
    tdt = dict(dtype=torch.float64, device="cpu")
    if dim == 3:
        src = tsol.PointSource(position=(0.5, 0.5, 0.7), f0=4.0, radius=0.25)
        line = tsol.line((0.2, 0.5, 0.9), (0.8, 0.5, 0.9), 3)
    else:
        src = tsol.PointSource(position=(0.5, 0.6), f0=4.0, radius=0.2)
        line = tsol.line((0.2, 0.9), (0.8, 0.9), 3)
    E, n_p = dm.num_elements, dm.re.n_p
    rng = np.random.default_rng(7)
    st = tsol.State(
        u=torch.as_tensor(rng.standard_normal((E, n_p, dim)) * 0.01),
        s=torch.as_tensor(rng.standard_normal((E, n_p, 3 * dim - 3)) * 0.01))
    kw = (dict(src=tsol.build_sources(dm, [src], **tdt), damp=_sponge(dm),
               receivers=tsol.build_receivers(dm, line, **tdt),
               record_pressure=True) if full else {})
    return kw, st


@pytest.fixture(scope="module")
def jax_packed_run():
    """The JAX packed merged runner on box_mesh(2, 2, 2) P1 with a free
    top, a blob source (kernel-fused dense injection), a sponge and 3
    receivers with pressure: N_STEPS steps from a numpy-seeded state."""
    dm_j, dm_t = _meshes(3, bc=True)
    p_j, _ = _params(dm_j)
    _, st = _runner_case(3, False, dm_t)
    src = jsol.build_sources(dm_j, [jsol.PointSource(
        position=(0.5, 0.5, 0.7), f0=4.0, radius=0.25)], dtype=jnp.float64)
    rcv = jsol.build_receivers(
        dm_j, jsol.line((0.2, 0.5, 0.9), (0.8, 0.5, 0.9), 3),
        dtype=jnp.float64)
    dt = float(tsol.cfl_dt(dm_t.h.min(), 2.0, 1, 0.4))
    jr = JaxRunner(p_j, jdetect(dm_j), dt, src=src, receivers=rcv,
                   damp=jnp.asarray(_sponge(dm_t)), record_pressure=True,
                   block=8, interpret=True, packed=True)
    assert jr.plan.n_par == 2 and jr.src_dense is not None
    out, seis = jr.run(jsol.State(u=jnp.asarray(st.u.numpy()),
                                  s=jnp.asarray(st.s.numpy())), N_STEPS)
    return dt, out, np.asarray(seis)


def test_packed_runner_matches_jax(jax_packed_run):
    dt, out_j, seis_j = jax_packed_run
    _, dm_t = _meshes(3, bc=True)
    p_t = tops.build_params(dm_t, tops.Material(*MAT), dtype=torch.float64,
                            device="cpu")
    kw, st = _runner_case(3, True, dm_t)
    tr = MergedLaneRunner(p_t, tdetect(dm_t), dt, packed=True, **kw)
    assert tr.n_par == 2 and tr.src_dense is not None
    out_t, seis_t = tr.run(st, N_STEPS)
    assert seis_t.shape == (N_STEPS, 3, 4) and np.abs(seis_j).max() > 0
    np.testing.assert_allclose(out_t.u.numpy(), np.asarray(out_j.u),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_t.s.numpy(), np.asarray(out_j.s),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(seis_t, seis_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dim,full,groups",
                         [(2, False, 1), (3, False, 1), (2, True, 1),
                          (3, True, 1), (3, True, 3)],
                         ids=["2d-bare", "3d-bare", "2d-full", "3d-full",
                              "3d-scatter"])
def test_packed_runner_matches_unpacked(dim, full, groups):
    """Packed and unpacked port runners, bare and with the full feature set
    (mixed BCs, sponge, receivers with pressure, a blob source through the
    kernel-fused dense injection, or with three wavelet groups through the
    scatter fallback)."""
    _, dm = _meshes(dim, bc=full)
    p = tops.build_params(dm, tops.Material(*MAT), dtype=torch.float64,
                          device="cpu")
    ex = tdetect(dm)
    kw, st = _runner_case(dim, full, dm)
    if groups > 1:
        kw["src"] = tsol.build_sources(dm, [
            tsol.PointSource(position=pos, f0=f0, radius=0.25)
            for pos, f0 in (((0.5, 0.5, 0.7), 4.0), ((0.3, 0.6, 0.5), 3.0),
                            ((0.6, 0.4, 0.3), 5.0))],
            dtype=torch.float64, device="cpu")
    dt = tsol.cfl_dt(dm.h.min(), 2.0, 1, 0.4)
    un = MergedLaneRunner(p, ex, dt, **kw)
    pk = MergedLaneRunner(p, ex, dt, packed=True, **kw)
    assert (pk.plan.m, pk.plan.Ls) == (ex.m // 2, dm.num_elements // 2)
    if full:
        assert (pk.src_dense is None) is (groups > 2)
    out_u, seis_u = un.run(st, N_STEPS)
    out_p, seis_p = pk.run(st, N_STEPS)
    assert out_u.u.abs().max() > 0
    for a, b in ((out_p.u, out_u.u), (out_p.s, out_u.s)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=1e-14)
    if full:
        np.testing.assert_allclose(seis_p, seis_u, rtol=RTOL, atol=1e-14)
    # the lane layout round-trips
    back = pk.from_lm_state(*pk.to_lm_state(st))
    assert torch.equal(back.u, st.u) and torch.equal(back.s, st.s)


# --- (h) "auto" and the refusals ----------------------------------------------

def test_packed_auto_rule_and_refusals():
    _, dm1 = _meshes(3)
    _, dm2 = _meshes(3, degree=2)
    p1, p2 = (tops.build_params(dm, tops.Material(*MAT), dtype=torch.float64,
                                device="cpu") for dm in (dm1, dm2))
    ex1, ex2 = tdetect(dm1), tdetect(dm2)
    C = np.eye(6)
    assert MergedLaneRunner(p1, ex1, DT, packed="auto").n_par == 2
    assert MergedLaneRunner(p2, ex2, DT, packed="auto").n_par == 1
    assert MergedLaneRunner(p1, ex1, DT, packed="auto",
                            stiffness=C).n_par == 1
    assert MergedLaneRunner(p1, ex1, DT).n_par == 1  # default: unpacked
    with pytest.raises(ValueError, match="isotropic"):
        MergedLaneRunner(p1, ex1, DT, packed=True, stiffness=C)
    with pytest.raises(ValueError, match="even class count"):
        MergedLaneRunner(p1, dataclasses.replace(ex1, m=ex1.m - 1), DT,
                         packed=True)
    with pytest.raises(ValueError, match="P1"):
        MergedLaneRunner(p2, ex2, DT, packed=True)
