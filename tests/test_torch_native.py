"""The port's native mesh-setup library (``seigen_tpu_torch/mesh/native``)
against its NumPy oracles and the JAX package's copy of it, on the CPU.

The port compiles the JAX package's source with the JAX package's flags,
so its geometric factors equal JAX's native ones bitwise; against the
NumPy (LAPACK) geometry they agree to rounding (rtol 1e-12, atol 1e-14,
the bounds of tests/test_native.py).  The integer outputs (pairing,
Morton order, halo needs, plans) are exactly equal on every path.  The
NumPy path is forced as tests/test_native.py forces it: by replacing
``native.available`` for the call.
"""

import shutil

import numpy as np
import pytest
import torch

import seigen_tpu.mesh as jmesh
import seigen_tpu_torch.mesh as tmesh
from seigen_tpu.mesh import native as jnative
from seigen_tpu.parallel.partition import make_plan as jmake_plan
from seigen_tpu.parallel.partition import morton_order as jmorton_order
from seigen_tpu_torch.mesh import native
from seigen_tpu_torch.mesh.discrete import geometric_factors_numpy, \
    pair_rows_numpy
from seigen_tpu_torch.parallel import partition
from seigen_tpu_torch.refelem import ref_elem

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native library")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several pytest workers' intra-op thread pools fight over the cores;
    one thread each keeps the port's CPU tests fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def numpy_path(monkeypatch):
    """Call to switch the port (and with ``jax=True`` the JAX package) to
    its NumPy path for the rest of the test."""
    def off(jax=False):
        monkeypatch.setattr(native, "available", lambda: False)
        if jax:
            monkeypatch.setattr(jnative, "available", lambda: False)
    assert native.available(), native.build_log()
    return off


def _synthetic_keys():
    """Unique rows twice each, plus singletons, shuffled."""
    rng = np.random.default_rng(0)
    base = np.unique(rng.integers(0, 50, size=(300, 4)), axis=0)
    keys = np.concatenate([base, base, rng.integers(60, 99, size=(37, 4))])
    return keys[rng.permutation(len(keys))].astype(np.int64)


@pytest.mark.parametrize("which", ["synthetic", "periodic box"])
def test_pairing_matches_numpy(which, numpy_path):
    if which == "synthetic":
        keys = _synthetic_keys()
        partner, mult = native.pair_face_nodes(keys)
        assert mult == 2
        np.testing.assert_array_equal(partner, pair_rows_numpy(keys))
        return
    topo = tmesh.box_mesh(3, 2, 2, periodic=(0,))
    a = tmesh.build_discrete(topo, 2)
    numpy_path()
    b = tmesh.build_discrete(topo, 2)
    np.testing.assert_array_equal(a.nbr, b.nbr)
    np.testing.assert_array_equal(a.bc, b.bc)


def test_pairing_refuses_non_manifold(numpy_path):
    keys = np.zeros((3, 2), dtype=np.int64)
    for _ in range(2):
        with pytest.raises(ValueError, match="non-manifold"):
            tmesh.discrete._pair_rows(keys)
        numpy_path()


MESHES = {"box_mesh(3, 2, 2)": (lambda m: m.box_mesh(3, 2, 2)),
          "rect_mesh(4, 3)": (lambda m: m.rect_mesh(4, 3)),
          "rect_mesh(10, 5, lx=2, ly=1)":
              (lambda m: m.rect_mesh(10, 5, lx=2.0, ly=1.0))}


@pytest.mark.parametrize("mesh", MESHES)
def test_geometric_factors(mesh):
    """Bitwise JAX's native library; NumPy's to rounding."""
    if not jnative.available():
        pytest.skip("the JAX package's native library did not build")
    topo = MESHES[mesh](tmesh)
    fv = np.asarray(ref_elem(topo.dim, 1).face_vertices)
    got = native.geometric_factors(topo.vertices, topo.cells, fv)
    jax = jnative.geometric_factors(topo.vertices, topo.cells, fv)
    ref = geometric_factors_numpy(topo.vertices, topo.cells, fv)
    for name, g, j, r in zip(("Ginv", "detJ", "normals", "Fscale", "h"),
                             got, jax, ref):
        assert np.array_equal(g, j), name
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-14,
                                   err_msg=name)


@pytest.mark.parametrize("mesh", ["box_mesh(3, 2, 2)", "rect_mesh(4, 3)"])
def test_numpy_paths_match_jax(mesh, numpy_path):
    """Both packages forced to NumPy: the same DiscreteMesh, exactly."""
    numpy_path(jax=True)
    a = tmesh.build_discrete(MESHES[mesh](tmesh), 2)
    b = jmesh.build_discrete(MESHES[mesh](jmesh), 2)
    for name in ("coords", "Ginv", "detJ", "Fscale", "normals", "h", "nbr",
                 "bc"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("dim", [2, 3])
def test_morton_order(dim, numpy_path):
    pts = np.random.default_rng(dim).uniform(size=(3000, dim))
    got = partition.morton_order(pts)
    np.testing.assert_array_equal(got, jmorton_order(pts))
    numpy_path(jax=True)
    np.testing.assert_array_equal(got, partition.morton_order(pts))
    np.testing.assert_array_equal(got, jmorton_order(pts))


def test_halo_needs_match_oracle():
    rng = np.random.default_rng(3)
    P, n = 5, 4000
    gids = rng.integers(0, 900, size=n).astype(np.int64)
    src = rng.integers(0, P, size=n).astype(np.int32)
    dst = rng.integers(0, P, size=n).astype(np.int32)
    keep = src != dst
    got = native.halo_needs(gids[keep], src[keep], dst[keep], P)
    ref = partition.halo_needs_numpy(gids[keep], src[keep], dst[keep], P)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


def test_make_plan_both_paths_match_jax(numpy_path):
    """make_plan on the port's native and NumPy paths, and JAX's default."""
    dm_t = tmesh.build_discrete(tmesh.box_mesh(3, 3, 3), 1)
    dm_j = jmesh.build_discrete(jmesh.box_mesh(3, 3, 3), 1)
    jp = jmake_plan(dm_j, 4)
    got = partition.make_plan(dm_t, 4)
    numpy_path()
    ref = partition.make_plan(dm_t, 4)
    for plan in (got, ref):
        for name in ("send_idx", "nbr_local", "perm"):
            np.testing.assert_array_equal(getattr(plan, name),
                                          getattr(jp, name), err_msg=name)
        assert plan.round_perms == jp.round_perms
        assert (plan.n_rounds, plan.halo_max, plan.block) == (
            jp.n_rounds, jp.halo_max, jp.block)


def test_decode_partners():
    re = ref_elem(3, 2)
    nf, nfp, n_p = re.n_faces, re.n_fp, re.n_p
    N = 7 * nf * nfp
    rng = np.random.default_rng(5)
    partner = np.where(rng.random(N) < 0.3, np.arange(N),
                       rng.integers(0, N, size=N))
    fnodes = np.asarray(re.fnodes).reshape(-1)
    nbr, selfpair = native.decode_partners(partner, nf, nfp, n_p, fnodes)
    e, slot = partner // (nf * nfp), partner % (nf * nfp)
    np.testing.assert_array_equal(nbr, (e * n_p + fnodes[slot])
                                  .astype(np.int32))
    np.testing.assert_array_equal(selfpair, partner == np.arange(N))


def test_second_load_reuses_the_library():
    assert native.available(), native.build_log()
    again = native.HostLibrary()
    assert again.load() is not None
    assert again.build_seconds == 0.0 and again.path == native.LIBRARY.path
    assert "loaded the existing" in again.log


@pytest.mark.parametrize("fault", ["bad flag", "no compiler"])
def test_failed_build_is_reported(fault, monkeypatch):
    """A build that fails leaves the NumPy path and says why."""
    if fault == "bad flag":
        monkeypatch.setattr(native, "CXX_FLAGS",
                            native.CXX_FLAGS + ("-fno-such-flag-at-all",))
    else:
        monkeypatch.setattr(native, "CXX", "no-such-compiler-here")
    lib = native.HostLibrary()
    assert lib.load() is None and lib.path is None
    assert ("exited 1" in lib.log and "no-such-flag" in lib.log
            if fault == "bad flag" else "did not run" in lib.log), lib.log
