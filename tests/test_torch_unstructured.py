"""The port's unstructured lane path (CPU, plain versions) against the JAX
package.

1. ``derive_face_pairing``, ``orientation_groups``, ``morton_order``,
   ``recover_structure`` and ``read_msh`` (on .msh files written here, v2.2
   with physical groups and v4.1): the same arrays, exactly.
2. ``make_unstructured_exchange_lm``, ``make_unstructured_traction_exchange``
   and ``make_panel_gather``'s panels against the JAX ones, exactly.
3. ``UnstructuredLaneRunner(impl="reference")`` against the JAX
   ``UnstructuredLaneRunner(interpret=True, block=8)`` at f64 on scrambled
   meshes with a source, a sponge and receivers, ``fused_select`` True and
   False, in the cases of tests/test_unstructured.py (and one LF2 case):
   states and seismograms at rtol 1e-10.
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
from seigen_tpu.mesh.gmsh_io import read_msh as jread
from seigen_tpu.mesh.recover import recover_structure as jrecover
from seigen_tpu.ops import pallas_kernels as jpk
from seigen_tpu.ops import unstructured_exchange as jux
from seigen_tpu.parallel.partition import morton_order as jmorton
from seigen_tpu.solver.lane_major import to_lm as jto_lm
from seigen_tpu.solver.lane_unstructured import \
    UnstructuredLaneRunner as JaxRunner
from seigen_tpu_torch.mesh.gmsh_io import read_msh as tread
from seigen_tpu_torch.mesh.recover import recover_structure as trecover
from seigen_tpu_torch.ops import unstructured_exchange as tux
from seigen_tpu_torch.ops.lane_kernels import build_lane_data
from seigen_tpu_torch.ops.structured_exchange import detect_structured
from seigen_tpu_torch.parallel.partition import morton_order as tmorton
from seigen_tpu_torch.solver.lane_major import to_lm
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


RTOL = 1e-10
MAT = (1.0, 2.0, 1.0)  # rho, vp, vs


def _scramble(topo, seed):
    perm = np.random.default_rng(seed).permutation(topo.num_cells)
    return dataclasses.replace(topo, cells=topo.cells[perm], structure=None)


def _pair(topo_fn, degree, seed):
    """(dm, p) of each package on the same scrambled mesh, f64."""
    out = []
    for mesh, ops, kw in ((jmesh, jops, dict(dtype=jnp.float64)),
                          (tmesh, tops, dict(dtype=torch.float64,
                                             device="cpu"))):
        dm = mesh.build_discrete(_scramble(topo_fn(mesh), seed), degree)
        out.append((dm, ops.build_params(dm, ops.Material(*MAT), **kw)))
    return out


def _eq(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 3), (3, 2)])
def test_face_pairing_and_morton_match_jax(dim, degree):
    def topo(mesh):
        return mesh.rect_mesh(5, 4) if dim == 2 else mesh.box_mesh(3, 3, 3)

    (dmj, pj), (dmt, pt) = _pair(topo, degree, seed=0)
    prj = jux.derive_face_pairing(np.asarray(pj.nbr), pj.n_p, pj.fnodes)
    prt = tux.derive_face_pairing(pt.nbr.numpy(), pt.n_p, pt.fnodes)
    for k in ("e2", "f2", "k2"):
        _eq(getattr(prt, k), getattr(prj, k))
    # the pairing is an involution on faces
    E = prt.e2.shape[0]
    np.testing.assert_array_equal(
        prt.e2[prt.e2, prt.f2], np.broadcast_to(np.arange(E)[:, None],
                                                prt.e2.shape))
    for a, b in zip(tux.orientation_groups(prt), jux.orientation_groups(prj)):
        _eq(a, b)
    assert tux.orientation_groups(prt)[1].shape[0] <= (3 if dim == 2 else 7)
    cent = dmt.coords.mean(axis=1)
    order = tmorton(cent)
    _eq(order, jmorton(np.asarray(dmj.coords).mean(axis=1)))
    new_of_old = np.empty(E, dtype=np.int64)
    new_of_old[order] = np.arange(E)
    pp_t = tux.permute_pairing(prt, order, new_of_old)
    pp_j = jux.permute_pairing(prj, order, new_of_old)
    for k in ("e2", "f2", "k2"):
        _eq(getattr(pp_t, k), getattr(pp_j, k))


def test_recover_structure_matches_jax():
    for make in (lambda m: m.rect_mesh(8, 6), lambda m: m.box_mesh(3, 3, 3),
                 lambda m: m.rect_mesh(10, 4, lx=2.0)):
        rec_t = trecover(_scramble(make(tmesh), 2))
        rec_j = jrecover(_scramble(make(jmesh), 2))
        assert rec_t.structure == rec_j.structure != None  # noqa: E711
        _eq(rec_t.cells, rec_j.cells)
        assert detect_structured(tmesh.build_discrete(rec_t, 1)) is not None
    # negative control: perturbed interior vertices -> no recovery
    topo = tmesh.rect_mesh(6, 6)
    v = topo.vertices.copy()
    inner = ((v[:, 0] > 0.01) & (v[:, 0] < 0.99)
             & (v[:, 1] > 0.01) & (v[:, 1] < 0.99))
    v[inner] += 0.02 * np.random.default_rng(1).standard_normal(
        v[inner].shape)
    pert = dataclasses.replace(topo, vertices=v, structure=None)
    assert trecover(pert) is pert


def _boundary_edges(topo):
    """(nedges, 2) vertex-id pairs of the boundary edges of a 2D mesh."""
    e = np.sort(topo.cells[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2),
                axis=1)
    uniq, count = np.unique(e, axis=0, return_counts=True)
    return uniq[count == 1]


def _write_msh(path, topo, groups, version):
    """ASCII Gmsh file of a 2D mesh: triangles plus physical line groups
    (name, tag, edges); version "2.2" or "4.1"."""
    nv, nc = len(topo.vertices), len(topo.cells)
    lines = ["$MeshFormat", f"{version} 0 8", "$EndMeshFormat",
             "$PhysicalNames", str(len(groups))]
    lines += [f'1 {tag} "{name}"' for name, tag, _ in groups]
    lines.append("$EndPhysicalNames")
    xyz = [f"{x} {y} 0.0" for x, y in topo.vertices]
    if version == "2.2":
        lines += ["$Nodes", str(nv)]
        lines += [f"{k + 1} {c}" for k, c in enumerate(xyz)]
        lines += ["$EndNodes", "$Elements",
                  str(nc + sum(len(e) for *_, e in groups))]
        eid = 1
        for _, tag, edges in groups:
            for a, b in edges:
                lines.append(f"{eid} 1 2 {tag} 0 {a + 1} {b + 1}")
                eid += 1
        for c in topo.cells:
            lines.append(f"{eid} 2 2 0 0 " + " ".join(str(v + 1) for v in c))
            eid += 1
        lines.append("$EndElements")
    else:
        # one curve entity per physical group, one surface entity
        lines += ["$Entities", f"0 {len(groups)} 1 0"]
        lines += [f"{i + 1} 0 0 0 1 1 0 1 {tag} 0"
                  for i, (_, tag, _) in enumerate(groups)]
        lines += ["1 0 0 0 1 1 0 0 0", "$EndEntities",
                  "$Nodes", f"1 {nv} 1 {nv}", f"2 1 0 {nv}"]
        lines += [str(k + 1) for k in range(nv)] + xyz
        lines += ["$EndNodes", "$Elements",
                  f"{len(groups) + 1} {nc + sum(len(e) for *_, e in groups)}"
                  f" 1 {nc + sum(len(e) for *_, e in groups)}"]
        eid = 1
        for i, (_, _, edges) in enumerate(groups):
            lines.append(f"1 {i + 1} 1 {len(edges)}")
            for a, b in edges:
                lines.append(f"{eid} {a + 1} {b + 1}")
                eid += 1
        lines.append(f"2 1 2 {nc}")
        for c in topo.cells:
            lines.append(f"{eid} " + " ".join(str(v + 1) for v in c))
            eid += 1
        lines.append("$EndElements")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("version", ["2.2", "4.1"])
def test_read_msh_matches_jax(tmp_path, version):
    topo = _scramble(tmesh.rect_mesh(4, 3), 3)
    edges = _boundary_edges(topo)
    top = np.all(np.abs(topo.vertices[edges][:, :, 1] - 1.0) < 1e-12, axis=1)
    path = tmp_path / "m.msh"
    _write_msh(path, topo, [("surface", 11, edges[top]),
                            ("absorbing", 12, edges[~top])], version)
    got, ref = tread(str(path)), jread(str(path))
    _eq(got.vertices, ref.vertices)
    _eq(got.cells, ref.cells)
    assert got.extents == ref.extents and got.periodic == ref.periodic
    assert set(got.facet_groups) == set(ref.facet_groups) == {
        "surface", "absorbing"}
    for k in got.facet_groups:
        _eq(got.facet_groups[k], ref.facet_groups[k])
    assert len(got.facet_groups["surface"]) == int(top.sum())
    dm = tmesh.build_discrete(got, 1, bc_groups={
        "surface": tmesh.BC_FREE, "absorbing": tmesh.BC_ABSORB})
    assert (dm.bc == tmesh.BC_ABSORB).sum() == int((~top).sum())


@pytest.fixture(scope="module", params=[(2, 2), (3, 3)],
                ids=["2d-P2", "3d-P3"])
def exchange_case(request):
    """JAX/port pairings and data of one scrambled mesh (E not a multiple
    of 8 in 2D, so the JAX arrays carry pad lanes)."""
    dim, degree = request.param

    def topo(mesh):
        return mesh.rect_mesh(6, 5) if dim == 2 else mesh.box_mesh(2, 3, 2)

    (_, pj), (_, pt) = _pair(topo, degree, seed=3)
    dj, dt = jpk.build_pallas_data(pj), build_lane_data(pt)
    prj = jux.derive_face_pairing(np.asarray(pj.nbr), pj.n_p, pj.fnodes)
    prt = tux.derive_face_pairing(pt.nbr.numpy(), pt.n_p, pt.fnodes)
    E = dt.E
    return dict(dim=dim, pj=pj, pt=pt, dj=dj, dt=dt, prj=prj, prt=prt, E=E,
                E_pad=E + (-E) % 8, rng=np.random.default_rng(dim))


@pytest.mark.parametrize("C", ["dim", "n_sig"])
def test_exchange_matches_jax(exchange_case, C):
    c = exchange_case
    dj, dt, E = c["dj"], c["dt"], c["E"]
    C = dt.dim if C == "dim" else dt.n_sig
    field = c["rng"].standard_normal((E, dt.n_p, C))
    ex_j = jux.make_unstructured_exchange_lm(c["prj"], dj.npp, dj.ftpp, C, E,
                                             c["E_pad"], c["pj"].fnodes)
    ex_t = tux.make_unstructured_exchange_lm(c["prt"], dt.ftpp, C, E,
                                             c["pt"].fnodes, device="cpu")
    ref = np.asarray(ex_j(jto_lm(jnp.asarray(field), dj.npp, c["E_pad"])))
    got = ex_t(to_lm(torch.as_tensor(field), dt.npp))
    _eq(got, ref[:, :E])


def test_traction_exchange_and_panels_match_jax(exchange_case):
    c = exchange_case
    dj, dt, E, E_pad, dim = c["dj"], c["dt"], c["E"], c["E_pad"], c["dim"]
    V = jops.voigt_map(dim)
    sig = c["rng"].standard_normal((E, dt.n_p, dt.n_sig))
    u = c["rng"].standard_normal((E, dt.n_p, dim))
    sig_j = jto_lm(jnp.asarray(sig), dj.npp, E_pad)
    u_j = jto_lm(jnp.asarray(u), dj.npp, E_pad)
    sig_t = to_lm(torch.as_tensor(sig), dt.npp)
    u_t = to_lm(torch.as_tensor(u), dt.npp)
    nrm_j = jnp.pad(dj.nrm, ((0, 0), (0, E_pad - E)))
    ref = jux.make_unstructured_traction_exchange(
        c["prj"], dj.npp, dj.ftpp, dim, dj.n_sig, E, E_pad, c["pj"].fnodes,
        nrm_j, V)(sig_j)
    got = tux.make_unstructured_traction_exchange(
        c["prt"], dt.npp, dt.ftpp, dim, dt.n_sig, E, c["pt"].fnodes, dt.nrm,
        V)(sig_t)
    _eq(got, np.asarray(ref)[:, :E])
    for x_j, x_t, kw_j, kw_t in (
            (u_j, u_t, {}, dict(device="cpu")),
            (sig_j, sig_t, dict(nrm_lm=nrm_j, voigt=V, n_sig=dj.n_sig),
             dict(nrm_lm=dt.nrm, voigt=V, n_sig=dt.n_sig))):
        fn_j, combo_j, sign_j, cfg_j = jux.make_panel_gather(
            c["prj"], dj.npp, dj.ftpp, dim, E, E_pad, c["pj"].fnodes, **kw_j)
        fn_t, combo_t, sign_t, cfg_t = tux.make_panel_gather(
            c["prt"], dt.npp, dt.ftpp, dim, E, c["pt"].fnodes, **kw_t)
        assert cfg_t == cfg_j
        _eq(combo_t, np.asarray(combo_j)[:, :E])
        if sign_t is not None:
            _eq(sign_t, np.asarray(sign_j)[:, :E])
        _eq(fn_t(x_t), np.asarray(fn_j(x_j))[:, :E])


def _runner_case(pkg, dim, degree):
    """Scrambled mesh, params, blob source, sponge and receivers of
    tests/test_unstructured.py:test_unstructured_runner_matches_general."""
    mesh, ops, sol, dtype, dev = pkg
    topo = mesh.rect_mesh(8, 6) if dim == 2 else mesh.box_mesh(3, 2, 2)
    dm = mesh.build_discrete(_scramble(topo, 11), degree)
    mat = ops.Material(*MAT)
    p = ops.build_params(dm, mat, dtype=dtype, **dev)
    h = float(dm.h.min())
    src = sol.build_sources(
        dm, [sol.PointSource(position=(0.4,) * dim, f0=2.0, radius=2 * h)],
        dtype=dtype, mat=mat, **dev)
    rcv = sol.build_receivers(dm, sol.line((0.2,) * dim, (0.8,) * dim, 3),
                              dtype=dtype, **dev)
    damp = sol.sponge_mask(dm, [(0, "lo")], width=0.3)
    return dm, p, src, rcv, damp, h


@pytest.mark.parametrize("dim,degree,fused_select,order",
                         [(2, 2, True, 4), (3, 1, True, 4), (2, 2, False, 4),
                          (2, 2, True, 2)])
def test_runner_matches_jax(dim, degree, fused_select, order):
    dmj, pj, src_j, rcv_j, damp, h = _runner_case(
        (jmesh, jops, jsol, jnp.float64, {}), dim, degree)
    dmt, pt, src_t, rcv_t, _, _ = _runner_case(
        (tmesh, tops, tsol, torch.float64, {"device": "cpu"}), dim, degree)
    dt = jsol.cfl_dt(h, 2.0, degree, 0.4)
    E, n_p = dmj.num_elements, dmj.re.n_p
    rng = np.random.default_rng(dim + degree)
    u0 = 0.1 * rng.standard_normal((E, n_p, dim))
    s0 = 0.1 * rng.standard_normal((E, n_p, pj.n_sig))
    cent = np.asarray(dmj.coords).mean(axis=1)
    jr = JaxRunner(pj, dt, order=order, src=src_j, damp=jnp.asarray(damp),
                   receivers=rcv_j, centroids=cent, block=8, interpret=True,
                   fused_select=fused_select)
    out_j, seis_j = jr.run(jsol.State(u=jnp.asarray(u0), s=jnp.asarray(s0)),
                           12)
    tr = UnstructuredLaneRunner(pt, dt, order=order, src=src_t, damp=damp,
                                receivers=rcv_t, centroids=cent,
                                fused_select=fused_select)
    assert tr.impl == "reference"
    _eq(tr._old_of_new, jr._old_of_new)
    out_t, seis_t = tr.run(tsol.State(u=torch.as_tensor(u0),
                                      s=torch.as_tensor(s0)), 12)
    for got, ref in ((out_t.u, out_j.u), (out_t.s, out_j.s),
                     (seis_t, seis_j)):
        ref = np.asarray(ref)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_allclose(got, ref, rtol=RTOL,
                                   atol=1e-12 * np.abs(ref).max())
