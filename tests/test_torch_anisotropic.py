"""The port's anisotropic (Voigt stiffness) path on the CPU against the JAX
package, f64, numpy-seeded inputs handed to both packages.

1. The numpy helpers of ``ops/anisotropic.py`` equal the JAX package's
   exactly; ``vti_stiffness_torch`` equals ``vti_stiffness`` and carries
   gradients.
2. ``make_aniso_stress_op`` vs the JAX closure (rtol 1e-12), the isotropic
   limit vs ``apply_stress_op``, and the SH plane wave travelling at
   sqrt(C66/rho) on the port's einsum path.
3. ``build_fused_data(stiffness=)``: ``geo``/``off`` equal the JAX arrays;
   ``LaneMajorRunner.cmat`` and the merged runner's placed ``geo`` equal
   the JAX runners'.
4. The plain versions of the kernels with a per-element NON-SYMMETRIC
   random ``C`` (an index transposition or a C[c, k] / C[k, c] swap hides
   behind a symmetric one): ``stress_merged_ref`` vs JAX ``stress_merged``
   (interpret mode; plain, axpy + damp, inject) and ``stress_op_lm_ref`` /
   ``stress_op_lm_sel_ref`` vs JAX ``stress_op_lm`` / ``stress_op_lm_sel``
   (``block=8, interpret=True``), 3D P2 and 2D P2.  Tolerance: rtol 1e-10,
   atol 1e-12 x the output's largest magnitude (f64 roundoff of
   differently ordered sums).
5. The slice as a whole: ``MergedLaneRunner``, ``LaneMajorRunner`` (LF4 and
   LF2) and ``UnstructuredLaneRunner`` (``fused_select`` True and False)
   with a per-element VTI ``C`` (epsilon varies per element, so a
   permutation error shows) over 3 steps vs the JAX runners
   (``interpret=True, block=8``) AND vs the port's einsum
   ``run(stress_op=make_aniso_stress_op(C))``: rtol 1e-9, atol 1e-11, the
   JAX package's own bar (tests/test_anisotropic.py).
6. ``iso_stiffness`` through each runner reproduces the isotropic runner to
   roundoff.
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
from seigen_tpu.ops import anisotropic as jan
from seigen_tpu.ops import pallas_kernels as jpk
from seigen_tpu.ops.fused_kernels import build_fused_data as jfused
from seigen_tpu.ops.merged_kernels import stress_merged as jstress_merged
from seigen_tpu.ops.structured_exchange import detect_structured as jdetect
from seigen_tpu.ops.unstructured_exchange import \
    derive_face_pairing as jpairing
from seigen_tpu.ops.unstructured_exchange import make_panel_gather as jpg
from seigen_tpu.solver.lane_major import LaneMajorRunner as JaxLane
from seigen_tpu.solver.lane_merged import MergedLaneRunner as JaxMerged
from seigen_tpu.solver.lane_unstructured import \
    UnstructuredLaneRunner as JaxLaneU
from seigen_tpu_torch.ops import anisotropic as tan
from seigen_tpu_torch.ops import lane_kernels as lk
from seigen_tpu_torch.ops.fused_kernels import build_fused_data as tfused
from seigen_tpu_torch.ops.merged_kernels import stress_merged_ref
from seigen_tpu_torch.ops.structured_exchange import \
    detect_structured as tdetect
from seigen_tpu_torch.ops.unstructured_exchange import \
    derive_face_pairing as tpairing
from seigen_tpu_torch.ops.unstructured_exchange import \
    make_panel_gather as tpg
from seigen_tpu_torch.solver.lane_major import LaneMajorRunner
from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner
from seigen_tpu_torch.solver.lane_unstructured import UnstructuredLaneRunner


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


MAT = (1.3, 2.0, 1.1)  # rho, vp, vs
DT, C3 = 0.013, 0.013**3 / 24.0


def _close(got, ref, rtol=1e-10, atol_rel=1e-12):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_rel * np.abs(ref).max())


def _scramble(topo, seed):
    perm = np.random.default_rng(seed).permutation(topo.num_cells)
    return dataclasses.replace(topo, cells=topo.cells[perm], structure=None)


def _pair(dim, scrambled=False, bc=False, n=None):
    """(dm, p) of each package on the same P2 mesh, f64: rect_mesh(4, 4)
    or box_mesh(3, 3, 3) (``n`` overrides the cells per side)."""
    out = []
    for mesh, ops, sol, kw in (
            (jmesh, jops, jsol, dict(dtype=jnp.float64)),
            (tmesh, tops, tsol, dict(dtype=torch.float64, device="cpu"))):
        topo = (mesh.rect_mesh(n or 4, n or 4) if dim == 2
                else mesh.box_mesh(n or 3, n or 3, n or 3))
        if scrambled:
            topo = _scramble(topo, 5)
        bc_fn = sol.absorbing_bc_fn(((0.0, 1.0),) * dim,
                                    free_sides=[(dim - 1, "hi")]) if bc \
            else None
        dm = mesh.build_discrete(topo, 2, bc_fn=bc_fn)
        out.append((dm, ops.build_params(dm, ops.Material(*MAT), **kw)))
    return out


def _random_C(E, n_sig, seed):
    """Per-element non-symmetric random matrices."""
    return np.random.default_rng(seed).standard_normal((E, n_sig, n_sig))


def _vti_C(E, seed):
    """Per-element VTI stiffness: epsilon, delta, gamma vary by element."""
    rng = np.random.default_rng(seed)
    return jan.vti_stiffness(2.0, 1.1, 1.3, epsilon=rng.uniform(0.05, 0.25, E),
                             delta=rng.uniform(0.0, 0.1, E),
                             gamma=rng.uniform(0.0, 0.2, E))


# --- 1. helpers -----------------------------------------------------------


def test_numpy_helpers_equal_jax():
    th = 0.7
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    vti = (2.0, 1.0, 1.3)
    thomsen = dict(epsilon=0.2, delta=0.1, gamma=0.3)
    for dim in (2, 3):
        np.testing.assert_array_equal(tan.iso_stiffness(2.0, 1.0, dim),
                                      jan.iso_stiffness(2.0, 1.0, dim))
        assert tan._voigt_strain_pair(dim) == jan._voigt_strain_pair(dim)
    C = jan.vti_stiffness(*vti, **thomsen)
    np.testing.assert_array_equal(tan.vti_stiffness(*vti, **thomsen), C)
    per_elem = np.linspace(0.0, 0.3, 5)
    np.testing.assert_array_equal(
        tan.vti_stiffness(2.0, 1.0, 1.3, epsilon=per_elem),
        jan.vti_stiffness(2.0, 1.0, 1.3, epsilon=per_elem))
    np.testing.assert_array_equal(tan.hti_stiffness(*vti, **thomsen),
                                  jan.hti_stiffness(*vti, **thomsen))
    np.testing.assert_array_equal(tan.rotate_stiffness(C, R),
                                  jan.rotate_stiffness(C, R))
    for n in ([1, 0, 0], [0, 0, 1], [0.3, -0.7, 0.2]):
        np.testing.assert_array_equal(tan.christoffel_speeds(C, 1.3, n),
                                      jan.christoffel_speeds(C, 1.3, n))
    assert tan.max_wavespeed(C, 1.3) == jan.max_wavespeed(C, 1.3)


def test_vti_stiffness_torch_equals_numpy_and_differentiates():
    rng = np.random.default_rng(0)
    E = 7
    vp, vs, rho = (rng.uniform(1.5, 2.5, E), rng.uniform(0.8, 1.2, E),
                   rng.uniform(1.0, 1.5, E))
    eps, dl, gm = (rng.uniform(0.0, 0.3, E), rng.uniform(0.0, 0.1, E),
                   rng.uniform(0.0, 0.3, E))
    ref = jan.vti_stiffness(vp, vs, rho, eps, dl, gm)
    t = [torch.tensor(a, requires_grad=True) for a in (vp, vs, rho, eps, dl,
                                                       gm)]
    C = tan.vti_stiffness_torch(*t)
    np.testing.assert_allclose(C.detach().numpy(), ref, rtol=1e-14)
    np.testing.assert_allclose(
        C.detach().numpy(),
        np.asarray(jan.vti_stiffness_jnp(vp, vs, rho, eps, dl, gm)),
        rtol=1e-14)
    C.sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               and (x.grad != 0).any() for x in t)
    # scalars follow the dtype of the array arguments and broadcast
    one = tan.vti_stiffness_torch(torch.tensor(2.0, dtype=torch.float64),
                                  1.0, 1.0, 0.15, 0.05, 0.1)
    assert one.shape == (6, 6) and one.dtype == torch.float64
    np.testing.assert_allclose(
        one.numpy(), jan.vti_stiffness(2.0, 1.0, 1.0, 0.15, 0.05, 0.1),
        rtol=1e-14)
    assert tan.vti_stiffness_torch(2.0, 1.0, 1.0).dtype == torch.float32


# --- 2. the einsum oracle -------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_aniso_stress_op_matches_jax_and_isotropic_limit(dim):
    (dmj, pj), (dmt, pt) = _pair(dim, bc=True)
    E, n_p, n_sig = dmj.num_elements, dmj.re.n_p, pj.n_sig
    C = _random_C(E, n_sig, dim)
    u = np.random.default_rng(1).standard_normal((E, n_p, dim))
    ref = jan.make_aniso_stress_op(jnp.asarray(C))(pj, jnp.asarray(u))
    got = tan.make_aniso_stress_op(torch.as_tensor(C))(pt, torch.as_tensor(u))
    _close(got, ref, rtol=1e-12, atol_rel=1e-14)
    # the isotropic C reproduces the hand-written isotropic operator
    mat = tops.Material(*MAT)
    Ci = np.broadcast_to(tan.iso_stiffness(float(mat.lam), float(mat.mu),
                                           dim), (E, n_sig, n_sig)).copy()
    iso = tan.make_aniso_stress_op(torch.as_tensor(Ci))(pt,
                                                        torch.as_tensor(u))
    np.testing.assert_allclose(
        iso.numpy(), tops.apply_stress_op(pt, torch.as_tensor(u)).numpy(),
        rtol=1e-13, atol=1e-13)


def test_vti_sh_wave_speed_on_the_einsum_path():
    """An SH plane wave (x-propagating, y-polarized) in a VTI medium is
    back in phase after the period of sqrt(C66/rho), not after the
    isotropic one (the case of tests/test_anisotropic.py at P2)."""
    vp, vs, rho, gam = 2.0, 1.0, 1.0, 0.3
    C_np = tan.vti_stiffness(vp, vs, rho, gamma=gam)
    c_sh = np.sqrt(C_np[5, 5] / rho)
    dm = tmesh.build_discrete(tmesh.box_mesh(8, 2, 2, periodic=(0, 1, 2)), 2)
    p = tops.build_params(dm, tops.Material(rho=rho, vp=vp, vs=vs),
                          dtype=torch.float64, device="cpu")
    E, n_p = dm.num_elements, dm.re.n_p
    stress_op = tan.make_aniso_stress_op(
        torch.as_tensor(np.broadcast_to(C_np, (E, 6, 6)).copy()))
    k = 2 * np.pi
    dt = tsol.cfl_dt(dm.h.min(), tan.max_wavespeed(C_np, rho), 2, 0.4)
    x = np.asarray(dm.coords)[:, :, 0]

    def run_T(T):
        n_steps = int(np.ceil(T / dt))
        dtp = T / n_steps
        u = np.zeros((E, n_p, 3))
        u[:, :, 1] = np.cos(k * x)
        s = np.zeros((E, n_p, 6))
        s[:, :, 5] = -rho * c_sh * np.cos(k * (x - c_sh * 0.5 * dtp))
        fin, _ = tsol.run(p, tsol.State(u=torch.as_tensor(u),
                                        s=torch.as_tensor(s)),
                          dtp, n_steps, order=4, stress_op=stress_op)
        u1, u0 = fin.u[:, :, 1].numpy(), np.cos(k * x)
        return np.sqrt(((u1 - u0) ** 2).mean()) / np.sqrt((u0**2).mean())

    e_good = run_T(2 * np.pi / (k * c_sh))
    e_iso = run_T(2 * np.pi / (k * vs))
    assert e_good < 0.02, e_good
    expected_phase_err = 2 * abs(np.sin(np.pi * (c_sh / vs - 1.0)))
    assert e_iso > 0.5 * expected_phase_err, (e_iso, expected_phase_err)


# --- 3. operator data -----------------------------------------------------


def _geo_equal(b, a):
    """The C section exactly; the geometry rows, which the two packages
    assemble from their own mesh arrays, to f64 roundoff."""
    o_C = b.off[6]
    got, ref = b.geo.numpy(), np.asarray(a.geo)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[o_C:], ref[o_C:])
    np.testing.assert_allclose(got[:o_C], ref[:o_C], rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("dim", [2, 3])
def test_fused_data_with_stiffness_equals_jax(dim):
    (dmj, pj), (dmt, pt) = _pair(dim, bc=True)
    E = dmj.num_elements
    C = _random_C(E, pj.n_sig, 10 + dim)
    a, b = jfused(pj, stiffness=C), tfused(pt, stiffness=C)
    assert b.off == tuple(a.off) and b.off[6] == b.off[5] + 8
    _geo_equal(b, a)
    # rows n_sig..7 of every section are zero padding
    sec = b.geo[b.off[6]:].reshape(pt.n_sig, 8, E)
    assert (sec[:, pt.n_sig:] == 0).all()
    # one matrix broadcasts over the elements, numpy or tensor
    one = tfused(pt, stiffness=torch.as_tensor(C[0]))
    _geo_equal(one, jfused(pj, stiffness=C[0]))
    assert tfused(pt).off[6] == -1


# --- 4. the kernels' plain versions --------------------------------------


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def merged_case(request):
    dim = request.param
    (dmj, pj), (dmt, pt) = _pair(dim, bc=True, n=8 if dim == 2 else 3)
    E = dmj.num_elements
    C = _random_C(E, pj.n_sig, 20 + dim)
    sides = [(a, s) for a in range(dim) for s in ("lo", "hi")][:-1]
    damp = jsol.sponge_mask(dmj, sides, width=0.3)
    tr = MergedLaneRunner(pt, tdetect(dmt), DT, damp=damp, stiffness=C)
    # the JAX lane block equals the lanes per class (16 in 2D, 27 in 3D), so
    # both packages use the same unpadded lane layout
    jr = JaxMerged(pj, jdetect(dmj), DT, block=tr.plan.NC, interpret=True,
                   damp=jnp.asarray(damp), stiffness=C)
    assert tr.plan.Ls == jr.plan.Ls and tr.plan.rtf == jr.plan.rtf
    d, plan = tr.d, tr.plan
    rng = np.random.default_rng(11)

    def field(Cn, used, rows, k=1):
        a = rng.standard_normal((k, Cn, rows, plan.Ls))
        a[:, :, used:] = 0.0  # dead node / pad trace rows are zero
        return a.reshape(k, Cn * rows, plan.Ls)

    data = {"u": field(d.dim, d.n_p, d.npp)[0],
            "sig": field(d.n_sig, d.n_p, d.npp, 2),
            "trs": field(d.nf, d.dim * d.n_fp, plan.rtf)[0],
            "Ss": field(d.n_sig, d.n_p, d.npp, 2)}
    return jr, tr, data, C


def test_merged_runner_geo_with_stiffness_equals_jax(merged_case):
    """The class-major placement of the C rows: stiffness goes in in the
    original element order and is permuted once, with the other geo
    columns."""
    jr, tr, _, C = merged_case
    _geo_equal(tr.d, jr.d)
    o_C, n_sig = tr.d.off[6], tr.d.n_sig
    sec = tr.d.geo[o_C:].reshape(n_sig, 8, -1)[:, :n_sig].numpy()
    np.testing.assert_array_equal(sec.transpose(2, 0, 1),
                                  C[tr._old_of_new])


@pytest.mark.parametrize("variant", ["plain", "axpy_damp", "inject1",
                                     "inject2"])
def test_stress_merged_ref_with_C_matches_jax(merged_case, variant):
    jr, tr, data, _ = merged_case
    Ls = tr.plan.Ls
    rs = (0.7, -1.3)
    jkw, tkw = {}, {}
    if variant == "axpy_damp":
        y = data["sig"]
        jkw = dict(axpy=(jnp.asarray(y[0]), jnp.asarray(y[1])), dt=DT, c3=C3)
        tkw = dict(axpy=(torch.as_tensor(y[0]), torch.as_tensor(y[1])),
                   dt=DT, c3=C3)
    elif variant.startswith("inject"):
        g = int(variant[-1])
        S = data["Ss"]
        jkw = dict(inject=[(jnp.asarray(S[i]),
                            jnp.full((8, Ls), rs[i], jnp.float64))
                           for i in range(g)])
        tkw = dict(inject=[(torch.as_tensor(S[i]), rs[i]) for i in range(g)])
    arrays = {k: jkw.pop(k) for k in ("axpy", "inject") if k in jkw}

    def jfn(u, t, kw):
        return jstress_merged(jr.plan, jr.d, u, t, jr.mask, interpret=True,
                              **kw, **jkw)

    # jitted (one compile, not one per op) where the outputs are bitwise
    # the eager ones; in 3D plain and inject XLA's fusion reorders a sum
    # (1e-14 apart), so those run eagerly
    if jr.d.dim == 2 or variant == "axpy_damp":
        jfn = jax.jit(jfn)
    j_out, j_tr = jfn(jnp.asarray(data["u"]), jnp.asarray(data["trs"]),
                      arrays)
    t_out, t_tr = stress_merged_ref(tr.plan, tr.d, torch.as_tensor(data["u"]),
                                    torch.as_tensor(data["trs"]), tr.mask,
                                    **tkw)
    _close(t_out, j_out)
    _close(t_tr, j_tr)


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def lane_case(request):
    dim = request.param
    (_, pj), (_, pt) = _pair(dim, scrambled=True, n=4 if dim == 2 else 2)
    dj, dt = jpk.build_pallas_data(pj), lk.build_lane_data(pt)
    E = dj.E
    assert E % 8 == 0
    prj = jpairing(np.asarray(pj.nbr), pj.n_p, pj.fnodes)
    prt = tpairing(pt.nbr.numpy(), pt.n_p, pt.fnodes)
    pgj = jpg(prj, dj.npp, dj.ftpp, dim, E, E, pj.fnodes)
    pgt = tpg(prt, dt.npp, dt.ftpp, dim, E, pt.fnodes, device="cpu")
    rng = np.random.default_rng(dim)
    x = {"u": rng.standard_normal((dim * dj.npp, E)),
         "tr_u": rng.standard_normal((dim * dj.ftpp, E)),
         "panels": rng.standard_normal((dt.nf * pgj[3][5], E))}
    cmat = lk.build_cmat(_random_C(E, dj.n_sig, 30 + dim), dt)
    return dj, dt, pgj, pgt, x, cmat


def test_stress_op_lm_ref_with_cmat_matches_jax(lane_case):
    dj, dt, _, _, x, cmat = lane_case
    ref = jax.jit(lambda u, t, c: jpk.stress_op_lm(
        dj, u, t, block=8, interpret=True, cmat=c))(
        jnp.asarray(x["u"]), jnp.asarray(x["tr_u"]),
        jnp.asarray(cmat.numpy()))
    args = (dt, torch.as_tensor(x["u"]), torch.as_tensor(x["tr_u"]))
    got = lk.stress_op_lm_ref(*args, cmat=cmat)
    _close(got, ref)
    # on CPU tensors the public operator is its plain version; and cmat
    # does change the result
    np.testing.assert_array_equal(lk.stress_op_lm(*args, cmat=cmat).numpy(),
                                  got.numpy())
    assert not np.allclose(lk.stress_op_lm(*args).numpy(), got.numpy())


def test_stress_op_lm_sel_ref_with_cmat_matches_jax(lane_case):
    dj, dt, pgj, pgt, x, cmat = lane_case
    (_, cj, _, cfg_j), (_, ct, _, cfg_t) = pgj, pgt
    ref = jax.jit(lambda u, pn, c: jpk.stress_op_lm_sel(
        dj, u, pn, cj, cfg_j, block=8, interpret=True, cmat=c))(
        jnp.asarray(x["u"]), jnp.asarray(x["panels"]),
        jnp.asarray(cmat.numpy()))
    args = (dt, torch.as_tensor(x["u"]), torch.as_tensor(x["panels"]), ct,
            cfg_t)
    got = lk.stress_op_lm_sel_ref(*args, cmat=cmat)
    _close(got, ref)
    np.testing.assert_array_equal(
        lk.stress_op_lm_sel(*args, cmat=cmat).numpy(), got.numpy())


def test_build_cmat_layout(lane_case):
    _, dt, _, _, _, _ = lane_case
    E, n_sig = dt.E, dt.n_sig
    C = _random_C(E, n_sig, 3)
    perm = np.random.default_rng(4).permutation(E)
    cm = lk.build_cmat(C, dt, perm).numpy().reshape(n_sig, 8, E)
    assert (cm[:, n_sig:] == 0).all()
    np.testing.assert_array_equal(cm[:, :n_sig].transpose(2, 0, 1), C[perm])
    np.testing.assert_array_equal(
        lk.build_cmat(C[0], dt).numpy(),
        lk.build_cmat(np.broadcast_to(C[0], C.shape), dt).numpy())


# --- 5./6. the runners ----------------------------------------------------

RUNNERS = ["merged", "lane-lf4", "lane-lf2", "lane_u-sel", "lane_u-assembled"]


def _runner_pair(name, stiffness, iso_port_only=False):
    """(JAX runner or None, port runner, port params, E, n_p, dt, order)."""
    scr = name.startswith("lane_u")
    (dmj, pj), (dmt, pt) = _pair(3, scrambled=scr, bc=True)
    E, n_p = dmj.num_elements, dmj.re.n_p
    C = stiffness(E)
    dt = jsol.cfl_dt(float(dmj.h.min()), 2.6, 2, 0.4)
    order = 2 if name == "lane-lf2" else 4
    sides = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
    damp = jsol.sponge_mask(dmj, sides, width=0.3)
    jr = None
    if name == "merged":
        if not iso_port_only:
            jr = JaxMerged(pj, jdetect(dmj), dt, block=27, interpret=True,
                           damp=jnp.asarray(damp), stiffness=C)
        make = lambda **kw: MergedLaneRunner(  # noqa: E731
            pt, tdetect(dmt), dt, damp=damp, **kw)
    elif name.startswith("lane-"):
        if not iso_port_only:
            jr = JaxLane(pj, jdetect(dmj), dt, order=order, block=8,
                         interpret=True, damp=jnp.asarray(damp), stiffness=C)
        make = lambda **kw: LaneMajorRunner(  # noqa: E731
            pt, tdetect(dmt), dt, order=order, damp=damp, **kw)
    else:
        sel = name.endswith("sel")
        cent = np.asarray(dmj.coords).mean(axis=1)
        if not iso_port_only:
            jr = JaxLaneU(pj, dt, order=4, block=8, interpret=True,
                          damp=jnp.asarray(damp), stiffness=C,
                          centroids=cent, fused_select=sel)
        make = lambda **kw: UnstructuredLaneRunner(  # noqa: E731
            pt, dt, order=4, damp=damp, centroids=cent, fused_select=sel,
            **kw)
    return jr, make, pt, C, E, n_p, dt, order, damp


@pytest.mark.parametrize("name", RUNNERS)
def test_runner_with_stiffness_matches_jax_and_einsum(name):
    jr, make, pt, C, E, n_p, dt, order, damp = _runner_pair(
        name, lambda E: _vti_C(E, 7))
    tr = make(stiffness=C)
    assert tr.impl == "reference"
    rng = np.random.default_rng(8)
    u0, s0 = rng.standard_normal((E, n_p, 3)), rng.standard_normal(
        (E, n_p, 6))
    fin_j, _ = jr.run(jsol.State(u=jnp.asarray(u0), s=jnp.asarray(s0)), 3)
    st = tsol.State(u=torch.as_tensor(u0), s=torch.as_tensor(s0))
    fin_t, _ = tr.run(st, 3)
    fin_e, _ = tsol.run(pt, st, dt, 3, order=order,
                        damp=torch.as_tensor(damp),
                        stress_op=tan.make_aniso_stress_op(
                            torch.as_tensor(C)))
    for ref in (fin_j, fin_e):
        np.testing.assert_allclose(fin_t.u.numpy(), np.asarray(ref.u),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(fin_t.s.numpy(), np.asarray(ref.s),
                                   rtol=1e-9, atol=1e-11)
    if name.startswith("lane"):
        np.testing.assert_array_equal(tr.cmat.numpy(),
                                      np.asarray(jr.cmat)[:, :E])


@pytest.mark.parametrize("name", RUNNERS)
def test_iso_stiffness_reproduces_isotropic_runner(name):
    mat = tops.Material(*MAT)
    Ci = tan.iso_stiffness(float(mat.lam), float(mat.mu), 3)
    _, make, pt, C, E, n_p, dt, order, _ = _runner_pair(
        name, lambda E: Ci, iso_port_only=True)
    rng = np.random.default_rng(9)
    st = tsol.State(u=torch.as_tensor(rng.standard_normal((E, n_p, 3))),
                    s=torch.as_tensor(rng.standard_normal((E, n_p, 6))))
    fin_i, _ = make().run(st, 3)
    fin_a, _ = make(stiffness=C).run(st, 3)
    np.testing.assert_allclose(fin_a.u.numpy(), fin_i.u.numpy(), rtol=1e-11,
                               atol=1e-12)
    np.testing.assert_allclose(fin_a.s.numpy(), fin_i.s.numpy(), rtol=1e-11,
                               atol=1e-12)
