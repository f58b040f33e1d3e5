"""The port's v1 lane-major operators and LaneMajorRunner (CPU, plain
versions) against the JAX package.

1. ``build_lane_data`` row for row, and the five plain operators
   (``vel_op_lm_ref``, ``vel_op_lm_trac_ref``, ``vel_op_lm_trac_sel_ref``,
   ``stress_op_lm_ref``, ``stress_op_lm_sel_ref``) against the JAX entry
   functions run as tests/test_pallas.py runs them (``block=8,
   interpret=True``), in 2D and 3D, f64, numpy-seeded inputs, E a multiple
   of 8: rtol 1e-10.
2. ``make_exchange_lm`` against the JAX roll exchange, exactly.
3. ``LaneMajorRunner(impl="reference")`` against the JAX
   ``LaneMajorRunner(interpret=True, block=8)`` at f64, LF2 and LF4, in
   the cases of tests/test_lane_major.py: periodic 2D/3D P2 plane waves,
   and a 2D P2 case with a source, a sponge and receivers (with the
   pressure column); states and seismograms at rtol 1e-10.
4. ``impl="kernel"`` refuses CPU tensors; a wrong-shaped ``cmat`` or
   stiffness raises.
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
from seigen_tpu.ops import pallas_kernels as jpk
from seigen_tpu.ops.structured_exchange import detect_structured as jdetect
from seigen_tpu.ops.unstructured_exchange import \
    derive_face_pairing as jpairing
from seigen_tpu.ops.unstructured_exchange import make_panel_gather as jpg
from seigen_tpu.solver.lane_major import LaneMajorRunner as JaxRunner
from seigen_tpu.solver.lane_major import make_exchange_lm as jexchange
from seigen_tpu.solver.lane_major import to_lm as jto_lm
from seigen_tpu_torch.ops import lane_kernels as lk
from seigen_tpu_torch.ops.structured_exchange import \
    detect_structured as tdetect
from seigen_tpu_torch.ops.unstructured_exchange import \
    derive_face_pairing as tpairing
from seigen_tpu_torch.ops.unstructured_exchange import \
    make_panel_gather as tpg
from seigen_tpu_torch.solver.lane_major import LaneMajorRunner
from seigen_tpu_torch.solver.lane_major import make_exchange_lm


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
MAT = (1.2, 2.0, 1.1)  # rho, vp, vs
LANE_FIELDS = ("lift", "drr", "ginv", "nrm", "fsc", "beta", "delta", "irho",
               "lam", "mu")


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=1e-12 * np.abs(ref).max())


def _scramble(topo, seed):
    perm = np.random.default_rng(seed).permutation(topo.num_cells)
    return dataclasses.replace(topo, cells=topo.cells[perm], structure=None)


def _pair(dim, scrambled=False, periodic=False):
    """(dm, p) of each package on the same small mesh, f64: rect_mesh(4, 4)
    (E = 32) or box_mesh(2, 2, 2) (E = 48), P2."""
    out = []
    for mesh, ops, kw in ((jmesh, jops, dict(dtype=jnp.float64)),
                          (tmesh, tops, dict(dtype=torch.float64,
                                             device="cpu"))):
        per = dict(periodic=tuple(range(dim))) if periodic else {}
        topo = (mesh.rect_mesh(4, 4, **per) if dim == 2
                else mesh.box_mesh(2, 2, 2, **per))
        if scrambled:
            topo = _scramble(topo, 5)
        dm = mesh.build_discrete(topo, 2)
        out.append((dm, ops.build_params(dm, ops.Material(*MAT), **kw)))
    return out


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def op_case(request):
    """JAX and port operator data, panel plans and numpy-seeded inputs."""
    dim = request.param
    (_, pj), (_, pt) = _pair(dim, scrambled=True)
    dj, dt = jpk.build_pallas_data(pj), lk.build_lane_data(pt)
    E = dj.E
    assert E % 8 == 0
    prj = jpairing(np.asarray(pj.nbr), pj.n_p, pj.fnodes)
    prt = tpairing(pt.nbr.numpy(), pt.n_p, pt.fnodes)
    V = jops.voigt_map(dim)
    pg = {"u": (jpg(prj, dj.npp, dj.ftpp, dim, E, E, pj.fnodes),
                tpg(prt, dt.npp, dt.ftpp, dim, E, pt.fnodes, device="cpu")),
          "t": (jpg(prj, dj.npp, dj.ftpp, dim, E, E, pj.fnodes,
                    nrm_lm=dj.nrm, voigt=V, n_sig=dj.n_sig),
                tpg(prt, dt.npp, dt.ftpp, dim, E, pt.fnodes, nrm_lm=dt.nrm,
                    voigt=V, n_sig=dt.n_sig))}
    rng = np.random.default_rng(dim)
    rows_pad = pg["u"][0][3][5]
    x = {"sig": rng.standard_normal((dj.n_sig * dj.npp, E)),
         "u": rng.standard_normal((dim * dj.npp, E)),
         "tr_sig": rng.standard_normal((dj.n_sig * dj.ftpp, E)),
         "tr_u": rng.standard_normal((dim * dj.ftpp, E)),
         "panels": rng.standard_normal((dt.nf * rows_pad, E))}
    return dj, dt, pg, x


def test_lane_data_matches_jax(op_case):
    dj, dt, _, _ = op_case
    for k in LANE_FIELDS:
        np.testing.assert_allclose(getattr(dt, k).numpy(),
                                   np.asarray(getattr(dj, k)), rtol=1e-14,
                                   atol=1e-14, err_msg=k)
    assert (dt.dim, dt.n_p, dt.npp, dt.ftp, dt.ftpp, dt.n_sig, dt.E) == (
        dj.dim, dj.n_p, dj.npp, dj.ftp, dj.ftpp, dj.n_sig, dj.E)


@pytest.mark.parametrize("name", ["nrm", "fsc", "delta", "beta"])
def test_lane_data_face_rows_are_constant_over_each_face(op_case, name):
    """The tile kernels read each face's normals, Fscale and delta (K5) or
    beta (K4) at its first face-node row f*n_fp: that is exact because the
    face-node-expanded rows repeat one value over the face's n_fp rows."""
    _, dt, _, _ = op_case
    nf, nfp, ftp, ftpp, E = dt.nf, dt.n_fp, dt.ftp, dt.ftpp, dt.E
    comps = dt.dim if name == "nrm" else 1
    rows = getattr(dt, name).reshape(comps, ftpp, E)[:, :ftp]
    faces = rows.reshape(comps, nf, nfp, E)
    assert torch.equal(faces, faces[:, :, :1].expand_as(faces))
    if name == "nrm":  # and the normals do differ between a lane's faces
        assert not torch.equal(faces[:, 0], faces[:, 1])


def test_panel_plans_match_jax(op_case):
    _, _, pg, _ = op_case
    for side in ("u", "t"):
        (_, cj, sj, cfg_j), (_, ct, st, cfg_t) = pg[side]
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert cfg_t == cfg_j
        if side == "t":
            np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


OPS = ["vel_op_lm", "vel_op_lm_trac", "vel_op_lm_trac_sel", "stress_op_lm",
       "stress_op_lm_sel"]


@pytest.mark.parametrize("name", OPS)
def test_plain_op_matches_jax(op_case, name):
    dj, dt, pg, x = op_case
    (_, cu, _, cfg_u), (_, cu_t, _, cfg_ut) = pg["u"]
    (_, ct, st, cfg_t), (_, ct_t, st_t, cfg_tt) = pg["t"]
    args = {  # (JAX args, port args) after the operator data
        "vel_op_lm": (("sig", "tr_sig"), ()),
        "vel_op_lm_trac": (("sig", "tr_u"), ()),
        "vel_op_lm_trac_sel": (("sig", "panels"), ((ct, st, cfg_t),
                                                   (ct_t, st_t, cfg_tt))),
        "stress_op_lm": (("u", "tr_u"), ()),
        "stress_op_lm_sel": (("u", "panels"), ((cu, cfg_u),
                                               (cu_t, cfg_ut))),
    }[name]
    plan_j, plan_t = args[1] or ((), ())
    ref = getattr(jpk, name)(dj, *(jnp.asarray(x[k]) for k in args[0]),
                             *plan_j, block=8, interpret=True)
    targs = (*(torch.as_tensor(x[k]) for k in args[0]), *plan_t)
    got = getattr(lk, name + "_ref")(dt, *targs)
    _close(got, ref)
    # on CPU tensors the public operator is its plain version
    assert lk.lane_op(name, "reference") is getattr(lk, name + "_ref")
    np.testing.assert_array_equal(getattr(lk, name)(dt, *targs).numpy(),
                                  got.numpy())


def test_anisotropic_and_cuda_only_paths_refuse(op_case):
    _, dt, _, x = op_case
    u, tr = torch.as_tensor(x["u"]), torch.as_tensor(x["tr_u"])
    for bad in (torch.zeros(1), torch.zeros((dt.n_sig * 8, dt.E + 1)),
                torch.zeros((dt.n_sig * 8, dt.E), dtype=torch.float32)):
        with pytest.raises(ValueError, match="cmat"):
            lk.stress_op_lm(dt, u, tr, cmat=bad)
    with pytest.raises(ValueError, match="CUDA"):
        lk.LANE_STRESS(dt, u.float(), tr.float(), lk.STRESS_TR)


@pytest.mark.parametrize("dim,C,periodic", [(2, 2, False), (2, 3, True),
                                            (3, 3, True), (3, 6, False)])
def test_structured_exchange_matches_jax(dim, C, periodic):
    (dmj, pj), (dmt, pt) = _pair(dim, periodic=periodic)
    dj, dt = jpk.build_pallas_data(pj), lk.build_lane_data(pt)
    E = dj.E
    field = np.random.default_rng(C).standard_normal((C * dj.npp, E))
    ref = jexchange(jdetect(dmj), dj, C, E, E)(jnp.asarray(field))
    got = make_exchange_lm(tdetect(dmt), dt, C, E)(torch.as_tensor(field))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _plane_case(pkg, dim):
    """Periodic P2 mesh, params and S plane wave of
    tests/test_lane_major.py."""
    mesh, ops, sol, dtype, dev = pkg
    mat = ops.Material(1.0, 2.0, 1.0)
    if dim == 2:
        dm = mesh.build_discrete(mesh.rect_mesh(6, 6, periodic=(0, 1)), 2)
        pw = sol.PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0]),
                           mode="S")
    else:
        dm = mesh.build_discrete(mesh.box_mesh(2, 2, 2, periodic=(0, 1, 2)),
                                 2)
        pw = sol.PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 0.0, 0.0]),
                           mode="S", polarization=np.array([0.0, 1.0, 0.0]))
    return dm, ops.build_params(dm, mat, dtype=dtype, **dev), pw


JAX = (jmesh, jops, jsol, jnp.float64, {})
PORT = (tmesh, tops, tsol, torch.float64, {"device": "cpu"})


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_periodic_runner_matches_jax(dim, order):
    dmj, pj, pw = _plane_case(JAX, dim)
    dmt, pt, _ = _plane_case(PORT, dim)
    dt = jsol.cfl_dt(dmj.h.min(), 2.0, 2, 0.4)
    u0 = np.asarray(jsol.interpolate(dmj, pw.u, 0.0))
    s0 = np.asarray(jsol.interpolate(dmj, pw.sigma, 0.5 * dt))
    jr = JaxRunner(pj, jdetect(dmj), dt, order=order, block=8,
                   interpret=True)
    fin_j, _ = jr.run(jsol.State(u=jnp.asarray(u0), s=jnp.asarray(s0)), 5)
    tr = LaneMajorRunner(pt, tdetect(dmt), dt, order=order)
    assert tr.impl == "reference"
    fin_t, seis = tr.run(tsol.State(u=torch.as_tensor(u0),
                                    s=torch.as_tensor(s0)), 5)
    assert seis is None
    _close(fin_t.u, fin_j.u)
    _close(fin_t.s, fin_j.s)


def _source_case(pkg):
    """2D P2 case with a source, a sponge and receivers
    (tests/test_lane_major.py:test_lane_major_sources_receivers_damp)."""
    mesh, ops, sol, dtype, dev = pkg
    dm = mesh.build_discrete(
        mesh.rect_mesh(8, 8), 2,
        bc_fn=sol.absorbing_bc_fn(((0.0, 1.0), (0.0, 1.0)),
                                  free_sides=[(1, "hi")]))
    p = ops.build_params(dm, ops.Material(1.0, 2.0, 1.0), dtype=dtype, **dev)
    src = sol.build_sources(
        dm, [sol.PointSource(position=(0.5, 0.7), f0=8.0, radius=0.1)],
        dtype=dtype, **dev)
    rcv = sol.build_receivers(dm, sol.line((0.2, 0.9), (0.8, 0.9), 4),
                              dtype=dtype, **dev)
    damp = sol.sponge_mask(dm, [(0, "lo"), (0, "hi"), (1, "lo")], width=0.2)
    return dm, p, src, rcv, damp, sol.cfl_dt(dm.h.min(), 2.0, 2, 0.4)


@pytest.mark.parametrize("order", [2, 4])
def test_source_sponge_receivers_match_jax(order):
    dmj, pj, src_j, rcv_j, damp, dt = _source_case(JAX)
    dmt, pt, src_t, rcv_t, _, _ = _source_case(PORT)
    E, n_p = dmj.num_elements, dmj.re.n_p
    rng = np.random.default_rng(order)
    u0, s0 = rng.standard_normal((E, n_p, 2)), rng.standard_normal(
        (E, n_p, 3))
    jr = JaxRunner(pj, jdetect(dmj), dt, order=order, src=src_j,
                   damp=jnp.asarray(damp), receivers=rcv_j,
                   record_pressure=True, block=8, interpret=True)
    fin_j, seis_j = jr.run(jsol.State(u=jnp.asarray(u0), s=jnp.asarray(s0)),
                           4, step0=3)
    tr = LaneMajorRunner(pt, tdetect(dmt), dt, order=order, src=src_t,
                         damp=damp, receivers=rcv_t, record_pressure=True,
                         impl="reference")
    fin_t, seis_t = tr.run(tsol.State(u=torch.as_tensor(u0),
                                      s=torch.as_tensor(s0)), 4, step0=3)
    assert seis_t.shape == (4, 4, 3)  # (steps, receivers, dim + pressure)
    _close(fin_t.u, fin_j.u)
    _close(fin_t.s, fin_j.s)
    _close(seis_t, seis_j)
    # lane-major round trip
    np.testing.assert_array_equal(
        tr.from_lm_state(*tr.to_lm_state(fin_t)).u.numpy(), fin_t.u.numpy())
    np.testing.assert_array_equal(
        tr.to_lm_state(fin_t)[0].numpy(),
        np.asarray(jto_lm(jnp.asarray(fin_t.u.numpy()[jr._old_of_new]),
                          jr.d.npp, E)))


def test_runner_refuses_kernel_on_cpu_and_stiffness():
    _, (dmt, pt) = _pair(2)
    ex = tdetect(dmt)
    with pytest.raises(ValueError, match="CUDA"):
        LaneMajorRunner(pt, ex, 0.01, impl="kernel")
    with pytest.raises(ValueError):  # not an (n_sig, n_sig) stiffness
        LaneMajorRunner(pt, ex, 0.01, stiffness=np.eye(4))
    with pytest.raises(ValueError, match="order"):
        LaneMajorRunner(pt, ex, 0.01, order=3)
