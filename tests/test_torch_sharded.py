"""The port's sharded paths (parallel/) on gloo CPU ranks, plain versions.

1. Partition invariance at f64: ``ShardedFusedRunner`` (with a source, a
   sponge and receivers; with a per-element ``stiffness``; packed P1 in 3D
   and 2D), ``ShardedLaneRunner`` LF2 and LF4 and ``ShardedUpwindRunner``
   with and without Q, at 2 ranks, against the port's one-device runners
   (MergedLaneRunner, LaneMajorRunner, UpwindLaneRunner) at rtol 1e-10;
   the one-rank fill modes off / local / skip / ppermute against
   MergedLaneRunner; ``overlap=True`` bitwise equal to ``overlap=False``
   (the default) at one rank, and the split run at two (packed, resumed);
   10 + 10 steps against 20.  One module fixture spawns the two ranks
   once (``comm.spawn``); the children import only the port and write
   their results as .npz.
2. The guards of ``fill_mode``, ``n_shards | G0`` and the rank count.
3. The host plan against the JAX package's: ``ShardedFusedRunner``
   (plain and packed) and ``ShardedUpwindRunner`` are only built (JAX's
   ``interpret=True`` runners on conftest's virtual devices, one lane a
   block), never run: the slab permutation, the packed pairs, the halo
   row groups, the (8, Ls) boundary mask and the per-class boundary split
   are equal.
"""

import numpy as np
import pytest
import torch

from seigen_tpu_torch.ops.merged_kernels import boundary_lanes, split_lanes
from seigen_tpu_torch.ops.structured_exchange import detect_structured
from seigen_tpu_torch.parallel import ShardedFusedRunner, ShardedLaneRunner
from seigen_tpu_torch.parallel.comm import Comm, spawn
from seigen_tpu_torch.parallel.dryrun import run_case, run_cases, tiny_case, \
    vti_stiffness


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tiny CPU operators gain nothing from intra-op threads, and
    several pytest workers' thread pools fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_STEPS = 10
# name: (ranks, dim, degree, runner, options); one-rank cases run on one
# of the two ranks while the other works on the next
CASES = {
    "fused": (2, 3, 2, "fused", {"steps": 20}),
    "fill_off": (1, 3, 2, "fused", {"fill_mode": "off"}),
    "fused_vti": (2, 3, 2, "fused", {"vti": True}),
    "fill_local": (1, 3, 2, "fused", {"fill_mode": "local"}),
    "packed3": (2, 3, 1, "fused", {"packed": True, "overlap": True}),
    "fill_skip": (1, 3, 2, "fused", {"fill_mode": "skip"}),
    "packed2": (2, 2, 1, "fused", {"packed": True, "overlap": True}),
    "fill_ppermute": (1, 3, 2, "fused", {"fill_mode": "ppermute"}),
    "resume": (2, 3, 2, "fused", {"steps": 20, "chunks": 2,
                                  "overlap": True}),
    "overlap": (1, 3, 2, "fused", {"fill_mode": "ppermute",
                                   "overlap": True}),
    "lane2": (2, 3, 2, "lane", {"order": 2}),
    "lane4": (2, 3, 2, "lane", {"order": 4}),
    "upwind": (2, 3, 2, "upwind", {}),
    "upwind_q": (2, 3, 2, "upwind", {"visco": True}),
}
# the one-device runs the cases are held to (fill modes: one run)
REFERENCES = ("fused", "fused_vti", "packed3", "packed2", "lane2", "lane4",
              "upwind", "upwind_q", "fill_off")


def _reference(name):
    _, dim, deg, kind, kw = CASES[name]
    kw = {k: v for k, v in kw.items()
          if k not in ("fill_mode", "overlap", "chunks", "steps")}
    case = _case(dim, deg)
    if kw.pop("vti", False):
        kw["stiffness"] = vti_stiffness(case[1].Ginv.shape[0])
    st, seis, _ = run_case(kind, case, 0, None,
                           CASES[name][4].get("steps", N_STEPS), **kw)
    return st.u.numpy(), st.s.numpy(), seis


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(every case's result, the one-device references): one spawn of two
    gloo ranks, the references computed here meanwhile."""
    out = tmp_path_factory.mktemp("sharded")
    refs = spawn(run_cases, 2, device="cpu", backend="gloo",
                 args=(str(out), CASES, N_STEPS),
                 meanwhile=lambda: {n: _reference(n) for n in REFERENCES})
    return {name: np.load(out / f"{name}.npz") for name in CASES}, refs


_CASES = {}


def _case(dim, deg):
    if (dim, deg) not in _CASES:
        _CASES[dim, deg] = tiny_case(dim, deg)
    return _CASES[dim, deg]


def _close(got, ref, rtol=1e-10):
    for g, r in zip((got["u"], got["s"], got["seis"]), ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=rtol,
                                   atol=rtol * np.abs(r).max())


@pytest.mark.parametrize("name", [
    "fused", "fused_vti", "packed3", "packed2", "lane2", "lane4", "upwind",
    "upwind_q"])
def test_two_ranks_match_one_device(sharded, name):
    got, refs = sharded
    _close(got[name], refs[name])


@pytest.mark.parametrize("mode", ["off", "local", "skip", "ppermute"])
def test_one_rank_fill_modes(sharded, mode):
    got, refs = sharded
    _close(got["fill_" + mode], refs["fill_off"])


def test_overlap_is_bitwise(sharded):
    """The interior/boundary split gives the unsplit run's bits; it is
    off by default."""
    a, b = sharded[0]["fill_ppermute"], sharded[0]["overlap"]
    for k in ("u", "s", "seis"):
        np.testing.assert_array_equal(a[k], b[k])
    args = _fused_args()
    assert ShardedFusedRunner(*args, 1, fill_mode="ppermute")._split is None
    r = ShardedFusedRunner(*args, 1, fill_mode="ppermute", overlap=True)
    assert r._split == (9, 27)  # 1 slab of 4 planes of 9 supercells


def test_resume_matches_one_run(sharded):
    """10 + 10 steps (the second from step0 = 10, with the split) against
    20 (without)."""
    got = sharded[0]
    _close(got["resume"], [got["fused"][k] for k in ("u", "s", "seis")],
           rtol=1e-12)


def _fused_args():
    dm, p, _, _, _, dt, _ = _case(3, 2)
    return p, detect_structured(dm), dt


def test_guards():
    p, ex, dt = _fused_args()
    two = Comm(rank=0, world=2)
    for mode in ("off", "local", "skip"):
        with pytest.raises(ValueError, match="exact only"):
            ShardedFusedRunner(p, ex, dt, 2, fill_mode=mode, comm=two)
    with pytest.raises(ValueError, match="unknown fill_mode"):
        ShardedFusedRunner(p, ex, dt, 1, fill_mode="halo")
    with pytest.raises(ValueError, match=r"n_shards \| G0"):
        ShardedFusedRunner(p, ex, dt, 3, comm=Comm(world=3))
    with pytest.raises(ValueError, match=r"n_shards \| G0"):
        ShardedLaneRunner(p, ex, dt, 3, comm=Comm(world=3))
    with pytest.raises(ValueError, match="ranks"):
        ShardedFusedRunner(p, ex, dt, 2)  # one rank here
    with pytest.raises(ValueError, match="LF4"):
        ShardedFusedRunner(p, ex, dt, 1, order=2)


# --- the host plan against the JAX package's -------------------------------


def _jax_runner(kind, n_shards, degree, **kw):
    import jax
    import jax.numpy as jnp

    import seigen_tpu.mesh as jmesh
    import seigen_tpu.ops as jops
    from seigen_tpu.ops.structured_exchange import detect_structured as jdet

    import seigen_tpu.solver as jsol
    dm_j = jmesh.build_discrete(
        jmesh.box_mesh(4, 3, 3), degree, bc_fn=jsol.absorbing_bc_fn(
            ((0.0, 1.0),) * 3, free_sides=[(2, "hi")]))
    p_j = jops.build_params(dm_j, jops.Material(1.0, 2.0, 1.0),
                            dtype=jnp.float64)
    args = (p_j, jdet(dm_j))
    devs = jax.devices()[:n_shards]
    if kind == "upwind":
        from seigen_tpu.ops.upwind import build_upwind_data
        from seigen_tpu.parallel.upwind_sharded import ShardedUpwindRunner
        w = build_upwind_data(dm_j, jops.Material(1.0, 2.0, 1.0),
                              dtype=jnp.float64)
        return ShardedUpwindRunner(*args, w, 0.01, n_shards, block=1,
                                   interpret=True, devices=devs, **kw)
    from seigen_tpu.parallel.fused_sharded import ShardedFusedRunner as JR
    return JR(*args, 0.01, n_shards, block=1, interpret=True, devices=devs,
              **kw)


def _port_runners(kind, n_shards, degree, **kw):
    dm, p, *_ = _case(3, degree)
    ex = detect_structured(dm)
    out = []
    for r in range(n_shards):
        comm = Comm(rank=r, world=n_shards)
        if kind == "upwind":
            from seigen_tpu_torch.ops import Material
            from seigen_tpu_torch.ops.upwind import build_upwind_data
            from seigen_tpu_torch.parallel import ShardedUpwindRunner
            w = build_upwind_data(dm, Material(1.0, 2.0, 1.0),
                                  dtype=torch.float64, device="cpu")
            out.append(ShardedUpwindRunner(p, ex, w, 0.01, n_shards,
                                           comm=comm, **kw))
        else:
            out.append(ShardedFusedRunner(p, ex, 0.01, n_shards, comm=comm,
                                          **kw))
    return out


@pytest.mark.parametrize("kind,n_shards,degree,kw", [
    ("fused", 1, 2, {"fill_mode": "ppermute"}),
    ("fused", 2, 2, {}),
    ("fused", 2, 1, {"packed": True}),
    ("upwind", 2, 2, {}),
], ids=["fused-1-halo", "fused-2", "packed-2", "upwind-2"])
def test_host_plan_matches_jax(kind, n_shards, degree, kw):
    from seigen_tpu.ops.merged_kernels import boundary_blocks

    jr = _jax_runner(kind, n_shards, degree, **kw)
    rs = _port_runners(kind, n_shards, degree, **kw)
    r0 = rs[0]
    np.testing.assert_array_equal(r0._g_old_of_new, jr._old_of_new)
    np.testing.assert_array_equal(r0._g_new_of_old, jr._new_of_old)
    assert len(r0._gpairs) == len(jr._pairs_old)
    for a, b in zip(r0._gpairs, jr._pairs_old):
        np.testing.assert_array_equal(a.numpy(), b)
    assert r0._halo_g == jr._halo_g
    mask = np.concatenate([r.mask.numpy() for r in rs], axis=1)
    np.testing.assert_array_equal(mask, np.asarray(jr.mask))
    assert boundary_lanes(r0.plan) == boundary_blocks(jr.plan)
    assert (r0.plan.NCt, r0.plan.h0) == (jr.plan.NCt, jr.plan.h0)
    if kind == "fused" and n_shards == 1:
        assert split_lanes(r0.plan) == (9, 27)
