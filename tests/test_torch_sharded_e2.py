"""The port's Slice E2 sharded paths on gloo CPU ranks, plain versions, f64.

1. The host plans against the JAX package's: ``make_plan`` at P = 2, 3, 4
   on a scrambled 3D mesh and a 2D mesh (every array exactly equal), and
   ``ShardedUnstructuredRunner``'s element order, published columns,
   select codes and signs, and the producer columns its takes address,
   against JAX's runner (built with ``interpret=True`` and ``block=1`` on
   conftest's virtual devices, never run).
2. Partition invariance against the port's one-device paths: the general
   einsum path (``run_distributed``) at 3 ranks against ``timestep.run``
   (rtol 1e-10); at 2 ranks ``ShardedUnstructuredRunner`` with and without
   a per-element stiffness against ``UnstructuredLaneRunner`` (1e-10), the
   lane, merged, packed-P1 and lane_u domain-decomposed gradients (value,
   the vp/vs/rho gradient, the illumination, the synthetics) and the
   shot-parallel ``vg_factory_sharded`` against ``LaneDiffFwi`` (1e-9),
   and ``shard_shots`` + ``run_shots`` against ``run_shots`` (1e-10).
   One module fixture spawns the two ranks and, meanwhile, the three
   (``comm.spawn``); the children import only the port and write .npz.
3. The port's general path at 2 ranks against JAX's ``run_distributed``
   on 2 virtual devices (a 2D P1 case, f64).
4. The guards and the one-rank collectives.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from seigen_tpu_torch.ops.elastic import apply_stress_op, apply_vel_op
from seigen_tpu_torch.ops.structured_exchange import detect_structured
from seigen_tpu_torch.parallel import ShardedLaneDiffFwi, \
    ShardedUnstructuredRunner, make_plan, make_sharded_run
from seigen_tpu_torch.parallel.comm import Comm, spawn
from seigen_tpu_torch.parallel.dryrun import E2_PATHS, e2_close, \
    grad_case, run_e2, run_e2_cases, tiny_case
from seigen_tpu_torch.solver.lane_diff import LaneDiffFwi
from seigen_tpu_torch.solver.shots import shard_shots


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tiny CPU operators gain nothing from intra-op threads, and
    several pytest workers' thread pools fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TWO_RANKS = [n for n in E2_PATHS if n != "general"] + ["general_2d"]
GRAD = ("dd_lane", "dd_merged", "dd_packed", "dd_lane_u", "shot_dp_grad")


@pytest.fixture(scope="module")
def e2(tmp_path_factory):
    """({path: result} of the sharded runs, {path: one-device result}):
    one spawn of two gloo ranks; meanwhile one of three (the general
    path) and the references here."""
    two, three = (tmp_path_factory.mktemp(f"e2_{k}") for k in (2, 3))

    def meanwhile():
        spawn(run_e2_cases, 3, device="cpu", backend="gloo",
              args=(str(three), ["general"]))
        return {n: run_e2(n, None)[0] for n in TWO_RANKS + ["general"]}

    refs = spawn(run_e2_cases, 2, device="cpu", backend="gloo",
                 args=(str(two), TWO_RANKS), meanwhile=meanwhile)
    got = {n: dict(np.load(two / f"{n}.npz")) for n in TWO_RANKS}
    got["general"] = dict(np.load(three / "general.npz"))
    return got, refs


@pytest.mark.parametrize("name", ["general"] + TWO_RANKS)
def test_ranks_match_one_device(e2, name):
    got, refs = e2
    e2_close(got[name], refs[name], rtol=1e-9 if name in GRAD else 1e-10)
    if name in GRAD:
        assert np.abs(refs[name]["vp"]).max() > 0 and refs[name]["v"] > 0


# --- the host plans against the JAX package's -------------------------------


def _jax_dm(dim, degree, scramble):
    """JAX's DiscreteMesh of tiny_case's mesh (each package on its default
    path: both native, or both NumPy where no g++ is found)."""
    import seigen_tpu.mesh as jmesh
    import seigen_tpu.solver as jsol

    topo = (jmesh.box_mesh(4, 3, 3) if dim == 3 else jmesh.rect_mesh(8, 4))
    if scramble:
        perm = np.random.default_rng(0).permutation(topo.num_cells)
        topo = dataclasses.replace(topo, cells=topo.cells[perm],
                                   structure=None)
    return jmesh.build_discrete(topo, degree, bc_fn=jsol.absorbing_bc_fn(
        ((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")]))


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("dim", [3, 2])
def test_make_plan_matches_jax(dim, P):
    import seigen_tpu.parallel as jpar
    import seigen_tpu_torch.parallel as tpar
    from seigen_tpu.parallel.partition import make_plan as jax_plan

    # every public name of the JAX package's parallel/ (shard_params,
    # shard_state, shard_sources, shard_receivers, unshard_field, ...)
    assert all(n in tpar.__all__ and hasattr(tpar, n) for n in jpar.__all__)
    jp = jax_plan(_jax_dm(dim, 2, dim == 3), P)
    tp = make_plan(tiny_case(dim, 2, scramble=(dim == 3))[0], P)
    for f in dataclasses.fields(jp):
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tp.n_rounds >= (2 if P > 2 else 1)


def _addressed(take, E_r, E_loc, nb, gather_cols, r):
    """Global (Morton-order) producer element of every take of rank r
    into [E_r local lanes | P panels of nb columns]."""
    t = np.asarray(take)
    o, k = np.divmod(np.maximum(t - E_r, 0), max(nb, 1))
    return np.where(t < E_r, r * E_loc + t,
                    o * E_loc + gather_cols[o, np.minimum(k, nb - 1)])


@pytest.mark.parametrize("P", [2, 5])  # 216 elements: 5 leaves 40 last
def test_unstructured_host_plan_matches_jax(P):
    import jax
    import jax.numpy as jnp

    import seigen_tpu.ops as jops
    from seigen_tpu.parallel.unstructured_sharded import \
        ShardedUnstructuredRunner as JR

    dm_j = _jax_dm(3, 2, True)
    p_j = jops.build_params(dm_j, jops.Material(1.0, 2.0, 1.0),
                            dtype=jnp.float64)
    cent = np.asarray(dm_j.coords.mean(axis=1))
    jr = JR(p_j, 0.01, P, centroids=cent, block=1, interpret=True,
            devices=jax.devices()[:P])
    dm, p, *_ = tiny_case(3, 2, scramble=True)
    rs = [ShardedUnstructuredRunner(p, 0.01, P, centroids=dm.coords.mean(
        axis=1), comm=Comm(rank=r, world=P)) for r in range(P)]
    np.testing.assert_array_equal(rs[0]._g_old_of_new, jr._old_of_new)
    E_loc, nb = jr.E_loc, jr.nb
    assert (rs[0].E_loc, rs[0].nb) == (E_loc, nb)
    gcols = np.asarray(jr._gather)
    np.testing.assert_array_equal(rs[0]._gather_cols, gcols)
    for r, tr in enumerate(rs):
        E_r = tr.d.E
        np.testing.assert_array_equal(tr._combo.numpy(),
                                      np.asarray(jr._combo[r])[:, :E_r])
        np.testing.assert_array_equal(tr._sign.numpy(),
                                      np.asarray(jr._sign[r])[:, :E_r])
        np.testing.assert_array_equal(
            _addressed(tr._take.numpy(), E_r, E_loc, nb, gcols, r),
            _addressed(np.asarray(jr._take[r])[:, :E_r], E_loc, E_loc, nb,
                       gcols, r))
        # JAX's combo union also holds its self-paired pad elements'
        # (identity) codes; the port has no pad elements
        cfg = tr._pg_u[3]
        assert cfg[:6] + cfg[7:] == jr._selcfg[:6] + jr._selcfg[7:]
        assert all(set(a) <= set(b) for a, b in zip(cfg[6], jr._selcfg[6]))
        assert (cfg[6] == jr._selcfg[6]) == (jr.E_pad == jr.E)


# --- the whole slice against JAX --------------------------------------------


def test_general_path_matches_jax(e2):
    """The port's 2-rank run of the general path (tiny 2D P1 case, f64)
    against JAX's run_distributed on 2 virtual devices."""
    import jax
    import jax.numpy as jnp

    import seigen_tpu.ops as jops
    import seigen_tpu.solver as jsol
    from seigen_tpu.parallel import run_distributed

    dm_j = _jax_dm(2, 1, False)
    E, n_p = dm_j.num_elements, dm_j.re.n_p
    rng = np.random.default_rng(7)
    mat = jops.Material(1.0 + 0.2 * rng.random(E), 2.0, 1.0)
    st = jsol.State(u=jnp.asarray(rng.standard_normal((E, n_p, 2))),
                    s=jnp.asarray(rng.standard_normal((E, n_p, 3))))
    src = jsol.build_sources(dm_j, [jsol.PointSource(
        position=(0.5, 0.6), f0=4.0, radius=0.25)], dtype=jnp.float64)
    rcv = jsol.build_receivers(dm_j, jsol.line((0.2, 0.9), (0.8, 0.9), 3),
                               dtype=jnp.float64)
    damp = jsol.sponge_mask(dm_j, [(0, "lo"), (0, "hi"), (1, "lo")],
                            width=0.3)
    dt = jsol.cfl_dt(dm_j.h.min(), 2.0, 1, 0.4)
    fin, seis, _ = run_distributed(
        dm_j, mat, st, dt, 6, n_devices=2, sources=src, damp=damp,
        receivers=rcv, dtype=jnp.float64, devices=jax.devices()[:2])
    got = e2[0]["general_2d"]
    for k, ref in (("u", fin.u), ("s", fin.s), ("seis", seis)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got[k], ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max())


# --- guards and the one-rank collectives ------------------------------------


def test_guards():
    dm, p, damp, rcv, shots, dt, _ = grad_case(3, 1)
    with pytest.raises(ValueError, match="empty"):  # 24 blocks of 9: 216
        ShardedUnstructuredRunner(p, dt, 25, comm=Comm(rank=24, world=25),
                                  centroids=dm.coords.mean(axis=1))
    with pytest.raises(ValueError, match="ranks"):
        ShardedUnstructuredRunner(p, dt, 2)  # one rank here
    plan = make_plan(dm, 2)
    with pytest.raises(ValueError, match="plan of 2"):
        make_sharded_run(plan, p, dt, 1, comm=Comm())
    with pytest.raises(ValueError, match="ranks"):
        ShardedLaneDiffFwi(p, dm, None, dt, 2, shots, rcv, None, 2)
    three = Comm(rank=0, world=3)
    with pytest.raises(ValueError, match="not divisible"):
        shard_shots(shots, three)
    ldf = LaneDiffFwi(p, dm, None, dt, 2, shots, rcv, np.zeros(1),
                      engine="lane_u")
    with pytest.raises(ValueError, match="not divisible"):
        ldf.vg_factory_sharded(three)
    dd = ShardedLaneDiffFwi(p, dm, detect_structured(dm), dt, 2, shots,
                            rcv, None, 1)
    for fn in (dd.source_vg_factory, dd.moment_vg_factory,
               dd.vg_factory_sharded):
        with pytest.raises(NotImplementedError):
            fn()


def test_one_rank_collectives_and_pool():
    """A one-rank Comm never touches torch.distributed; ``pool=`` is
    keyword-only and, given the field itself, changes nothing."""
    c = Comm()
    x = torch.arange(6.0).reshape(2, 3)
    assert c.all_reduce_sum(x) is x
    assert torch.equal(c.permute(x, ((0, 0),)), x)
    assert torch.equal(c.permute(x, ()), torch.zeros_like(x))
    with pytest.raises(ValueError, match="twice"):
        Comm(rank=0, world=3).permute(x, ((0, 1), (0, 2)))
    _, p, _, _, _, _, st = tiny_case(2, 1)
    for op, f in ((apply_vel_op, st.s), (apply_stress_op, st.u)):
        assert inspect.signature(op).parameters["pool"].kind == \
            inspect.Parameter.KEYWORD_ONLY
        ref = op(p, f)
        assert torch.equal(op(p, f, pool=f.reshape(-1, f.shape[-1])), ref)
