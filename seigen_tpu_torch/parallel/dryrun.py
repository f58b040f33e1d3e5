"""Multi-rank dry run of the sharded paths on CPU processes.

``dryrun_multichip(n)`` is the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: it spawns ``n`` gloo ranks on the
CPU and runs every sharded path of the port on a tiny mesh — the merged
LF4 runner, its packed P1 layout, the lane-major LF4 runner, upwind RK4
with viscoelastic Q, the general einsum path, the Morton-block
unstructured runner (also with a VTI stiffness), the lane, merged,
packed-P1 and unstructured domain-decomposed FWI gradients, shot data
parallelism and its FWI gradient — each against its one-device runner
(partition invariance, f64; gradients rtol 1e-9), printing one ``OK``
line a path.  ``run_e2`` runs one of the E2 paths (or its one-device
reference) for the tests.

``run_cases`` runs named cases of the same paths on a spawned ring and
writes each result (u, s, seismograms) to ``<out_dir>/<name>.npz`` from
rank 0; ``tiny_case`` builds their inputs.  A case of one rank runs on
one of the ranks with a ring of its own, so the other ranks work
meanwhile.

    python -m seigen_tpu_torch.parallel.dryrun [n]
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from .. import mesh, ops, solver
from ..ops.structured_exchange import detect_structured
from ..ops.upwind import build_upwind_data
from ..ops.viscoelastic import build_visco
from . import comm as _comm


def tiny_case(dim: int = 3, degree: int = 2, n0: int = 4, seed: int = 7,
              dtype=torch.float64, device="cpu", scramble: bool = False):
    """A small bounded structured case: box_mesh(n0, 3, 3) (3D) or
    rect_mesh(2*n0, 4) (2D), a free top, a sponge on the other sides, one
    blob source, 3 receivers on a line, a random density per element and a
    random state from ``seed``; ``scramble``: its cells permuted by
    default_rng(0) and the structure dropped (an unstructured mesh).
    Returns (dm, p, damp, receivers, sources, dt, state)."""
    rng = np.random.default_rng(seed)
    if dim == 3:
        topo, free = mesh.box_mesh(n0, 3, 3), (2, "hi")
        sides = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
        pos, a, b = (0.5, 0.5, 0.7), (0.2, 0.5, 0.9), (0.8, 0.5, 0.9)
    else:
        topo, free = mesh.rect_mesh(2 * n0, 4), (1, "hi")
        sides = [(0, "lo"), (0, "hi"), (1, "lo")]
        pos, a, b = (0.5, 0.6), (0.2, 0.9), (0.8, 0.9)
    if scramble:
        perm = np.random.default_rng(0).permutation(topo.num_cells)
        topo = dataclasses.replace(topo, cells=topo.cells[perm],
                                   structure=None)
    dm = mesh.build_discrete(topo, degree, bc_fn=solver.absorbing_bc_fn(
        ((0.0, 1.0),) * dim, free_sides=[free]))
    E = dm.num_elements
    mat = ops.Material(1.0 + 0.2 * rng.random(E), 2.0, 1.0)
    p = ops.build_params(dm, mat, dtype=dtype, device=device)
    damp = solver.sponge_mask(dm, sides, width=0.3)
    rcv = solver.build_receivers(dm, solver.line(a, b, 3), dtype=dtype,
                                 device=device)
    src = solver.build_sources(
        dm, [solver.PointSource(position=pos, f0=4.0, radius=0.25)],
        dtype=dtype, device=device)
    dt = solver.cfl_dt(dm.h.min(), 2.0, degree, 0.4)
    n_sig = 6 if dim == 3 else 3
    st = solver.State(
        u=torch.as_tensor(rng.standard_normal((E, p.n_p, dim)),
                          device=device).to(dtype),
        s=torch.as_tensor(rng.standard_normal((E, p.n_p, n_sig)),
                          device=device).to(dtype))
    return dm, p, damp, rcv, src, dt, st


def vti_stiffness(E, seed=5):
    """A random per-element, non-symmetric (E, 6, 6) stiffness near 3 I:
    a test of the general Hooke law whose index transpositions show."""
    rng = np.random.default_rng(seed)
    return 0.1 * rng.standard_normal((E, 6, 6)) + 3.0 * np.eye(6)


def make_runner(kind: str, case, n_shards: int, comm, **kw):
    """The sharded runner of ``kind`` ("fused", "lane" or "upwind"; kw:
    its options, ``visco=True`` a Q 30/20 fit) on a tiny_case, or with
    n_shards 0 its one-device runner."""
    from ..solver.lane_major import LaneMajorRunner
    from ..solver.lane_merged import MergedLaneRunner
    from ..solver.lane_upwind import UpwindLaneRunner
    from .fused_sharded import ShardedFusedRunner
    from .lane_sharded import ShardedLaneRunner
    from .upwind_sharded import ShardedUpwindRunner

    dm, p, damp, rcv, src, dt, _ = case
    ex = detect_structured(dm)
    common = dict(src=src, damp=damp, receivers=rcv)
    sh = dict(comm=comm) if n_shards else {}
    args = (p, ex, dt) + ((n_shards,) if n_shards else ())
    if kind == "fused":
        if n_shards:
            return ShardedFusedRunner(*args, **common, **sh, **kw)
        return MergedLaneRunner(*args, **common, **{
            k: v for k, v in kw.items() if k in ("packed", "stiffness")})
    if kind == "lane":
        cls = ShardedLaneRunner if n_shards else LaneMajorRunner
        return cls(*args, **common, **sh, **kw)
    kw = dict(kw)
    E = p.Ginv.shape[0]
    visco = (build_visco(p, np.full(E, 30.0), np.full(E, 20.0), 1.0, 10.0)
             if kw.pop("visco", False) else None)
    w = build_upwind_data(dm, ops.Material(1.0, 2.0, 1.0), dtype=p.dtype,
                          device=p.device)
    args = (p, ex, w, dt) + ((n_shards,) if n_shards else ())
    cls = ShardedUpwindRunner if n_shards else UpwindLaneRunner
    return cls(*args, **common, **sh, visco=visco, **kw)


def run_case(kind, case, n_shards, comm, n_steps, chunks=1, **kw):
    """(State, seismograms, runner) of ``n_steps`` in ``chunks`` equal
    chunks."""
    r = make_runner(kind, case, n_shards, comm, **kw)
    st, seis, k0 = case[-1], [], 0
    for c in range(chunks):
        k = n_steps // chunks
        st, s = r.run(st, k, step0=k0)
        k0 += k
        seis.append(s)
    return st, np.concatenate(seis), r


def run_cases(comm, out_dir: str, cases: dict, n_steps: int):
    """Run ``cases`` {name: (ranks, dim, degree, kind, options)} on this
    ring: a case of comm.world ranks on all of them, a case of one rank on
    rank (its index mod world).  Options as make_runner's, and "steps"
    (default n_steps), "chunks" (run's calls), "vti" (vti_stiffness).
    Rank 0 of each case writes <out_dir>/<name>.npz (u, s, seis)."""
    built = {}
    for i, (name, (ranks, dim, deg, kind, kw)) in enumerate(cases.items()):
        if ranks == comm.world:
            c = comm
        elif ranks == 1 and i % comm.world == comm.rank:
            c = _comm.Comm(device=comm.device)
        else:
            continue
        key = (dim, deg)
        if key not in built:
            built[key] = tiny_case(dim, deg)
        kw = dict(kw)
        chunks, steps = kw.pop("chunks", 1), kw.pop("steps", n_steps)
        if kw.pop("vti", False):
            kw["stiffness"] = vti_stiffness(built[key][1].Ginv.shape[0])
        st, seis, _ = run_case(kind, built[key], ranks, c, steps, chunks,
                               **kw)
        if c.rank == 0:
            np.savez(os.path.join(out_dir, name + ".npz"), u=st.u.numpy(),
                     s=st.s.numpy(), seis=seis)


def run_fused(comm, out_path: str, p, ex, dt, state, n_steps: int, kw):
    """ShardedFusedRunner(p, ex, dt, comm.world, **kw) on this ring, run
    n_steps from ``state``; rank 0 writes out_path (u, s, seis)."""
    from .fused_sharded import ShardedFusedRunner

    r = ShardedFusedRunner(p, ex, dt, comm.world, comm=comm, **kw)
    st, seis = r.run(state, n_steps)
    if comm.rank == 0:
        np.savez(out_path, u=st.u.numpy(), s=st.s.numpy(), seis=seis)


# --- Slice E2: the general path, Morton blocks, the sharded gradients ---

E2_PATHS = ("general", "lane_u", "lane_u_vti", "dd_lane", "dd_merged",
            "dd_packed", "dd_lane_u", "shot_dp", "shot_dp_grad")


def grad_case(dim: int = 3, degree: int = 1, n0: int = 4, n_shots: int = 2,
              scramble: bool = False):
    """tiny_case's mesh, sponge and receivers with ``n_shots`` blob shots
    on the receiver line, t0 = 0 (a few steps then give a misfit and a
    gradient), and a smooth 5% model perturbation theta.  Returns (dm, p,
    damp, receivers, stacked shots, dt, theta)."""
    from ..solver.adjoint import theta_of_params
    from ..solver.shots import stack_shots

    dm, p, damp, rcv, _, dt, _ = tiny_case(dim, degree, n0,
                                           scramble=scramble)
    y = (0.5, 0.9) if dim == 3 else (0.9,)
    shots = stack_shots([solver.build_sources(dm, [solver.PointSource(
        position=(float(x),) + y, f0=4.0, t0=0.0, amplitude=10.0,
        radius=0.25)], dtype=p.dtype, device=p.device)
        for x in np.linspace(0.3, 0.7, n_shots)])
    k = torch.arange(p.Ginv.shape[0], dtype=p.dtype)
    theta = {f: v * (1.0 + 0.05 * torch.sin(k + i))
             for i, (f, v) in enumerate(theta_of_params(p).items())}
    return (dm, p, torch.as_tensor(damp, dtype=p.dtype), rcv, shots, dt,
            theta)


def _dd_engine(name, case, n_steps, comm):
    """The gradient engine of DD path ``name`` on ``comm``'s ranks, or
    with comm None the one-device LaneDiffFwi it is held to."""
    from ..solver.lane_diff import LaneDiffFwi
    from .lane_diff_sharded import ShardedLaneDiffFwi
    from .merged_diff_sharded import ShardedMergedDiffFwi
    from .unstructured_diff_sharded import ShardedUnstructuredDiffFwi

    dm, p, damp, rcv, shots, dt, _ = case
    ex = detect_structured(dm)
    engine = {"dd_lane": "lane", "dd_merged": "merged",
              "dd_packed": "merged", "dd_lane_u": "lane_u"}[name]
    kw = dict(damp=damp, segment=3 if name == "dd_lane" else None)
    if name == "dd_packed":
        kw["packed"] = True
    if comm is None:
        return LaneDiffFwi(p, dm, ex, dt, n_steps, shots, rcv, None,
                           engine=engine, **kw)
    if engine == "lane_u":
        return ShardedUnstructuredDiffFwi(p, dm, dt, n_steps, shots, rcv,
                                          None, comm.world, comm=comm, **kw)
    cls = ShardedLaneDiffFwi if engine == "lane" else ShardedMergedDiffFwi
    return cls(p, dm, ex, dt, n_steps, shots, rcv, None, comm.world,
               comm=comm, **kw)


def run_e2(name: str, comm, n0: int = 4, n_steps: int = 6,
           device="cpu"):
    """E2 path ``name`` (one of E2_PATHS, or "general_2d": the general
    path on the 2D P1 tiny case) on ``comm``'s ranks, or with
    comm None the one-device run it is held to; returns ({array name:
    numpy}, a line describing the sharded run).  ``device``: of the
    general paths (the others run the CPU's plain versions)."""
    from ..solver.lane_diff import LaneDiffFwi
    from ..solver.lane_unstructured import UnstructuredLaneRunner
    from ..solver.shots import run_shots, shard_shots
    from ..solver.timestep import run
    from .dist_ops import run_distributed
    from .unstructured_sharded import ShardedUnstructuredRunner

    P = 1 if comm is None else comm.world
    if name in ("general", "general_2d"):  # 3D P2; 2D P1
        dim = 3 if name == "general" else 2
        dm, p, damp, rcv, src, dt, st = tiny_case(dim, dim - 1, n0,
                                                  device=device)
        if comm is None:
            fin, seis = run(p, st, dt, n_steps, src=src, receivers=rcv,
                            damp=torch.as_tensor(damp, device=device))
            seis = seis.cpu()
            info = ""
        else:
            mat = ops.Material.from_lame(*(x.cpu().numpy() for x in (
                1.0 / p.inv_rho, p.lam, p.mu)))
            fin, seis, plan = run_distributed(
                dm, mat, st, dt, n_steps, comm=comm, sources=src,
                damp=damp, receivers=rcv, dtype=p.dtype)
            info = (f"{plan.n_rounds} halo rounds, block={plan.block} "
                    "elements/rank")
        return {"u": fin.u.cpu().numpy(), "s": fin.s.cpu().numpy(),
                "seis": np.asarray(seis)}, info
    if name in ("lane_u", "lane_u_vti"):
        dm, p, damp, rcv, src, dt, st = tiny_case(3, 2, n0, scramble=True)
        kw = dict(centroids=dm.coords.mean(axis=1), src=src, damp=damp,
                  receivers=rcv)
        if name == "lane_u_vti":
            kw["stiffness"] = vti_stiffness(dm.num_elements)
        r = (UnstructuredLaneRunner(p, dt, **kw) if comm is None else
             ShardedUnstructuredRunner(p, dt, P, comm=comm, **kw))
        fin, seis = r.run(st, n_steps)
        info = ("" if comm is None else
                f"E_loc={r.E_loc} elements/rank, halo panel "
                f"{r._rows_pad}x{r.nb} lanes")
        return {"u": fin.u.numpy(), "s": fin.s.numpy(), "seis": seis}, info
    if name.startswith("dd_"):
        deg = 2 if name == "dd_lane" else 1
        case = grad_case(3, deg, n0, scramble=(name == "dd_lane_u"))
        ldf = _dd_engine(name, case, n_steps, comm)
        ldf.observed = ldf.synth({})
        v, g = ldf.vg_factory(None)(case[-1])
        out = {"v": np.asarray(v), "synth": ldf.synth(case[-1]),
               "illum": ldf.illumination(),
               **{k: x.numpy() for k, x in g.items()}}
        r = ldf.runner
        gmax = float(np.abs(out["vp"]).max())
        info = (f"{len(r._old_of_new)} elements on rank {r.comm.rank}, "
                f"|g| = {gmax:.3e}" if comm is not None else "")
        return out, info
    # shot data parallelism over n0 shots (the dry run: one a rank)
    case = grad_case(3, 1, n0, n_shots=n0)
    dm, p, damp, rcv, shots, dt, theta = case
    if name == "shot_dp":
        st = tiny_case(3, 1, n0)[-1]
        local = shots if comm is None else shard_shots(shots, comm)
        _, seis = run_shots(p, st, dt, n_steps, local, receivers=rcv,
                            damp=damp)
        if comm is not None:
            seis = torch.cat(comm.all_gather(seis))
        return {"seis": seis.numpy()}, (
            f"{shots.elems.shape[0]} shots, "
            f"{shots.elems.shape[0] // P} per rank")
    ldf = LaneDiffFwi(p, dm, detect_structured(dm), dt, n_steps, shots, rcv,
                      None, damp=damp)
    ldf.observed = ldf.synth({})
    vg = (ldf.vg_factory(None) if comm is None
          else ldf.vg_factory_sharded(comm)(None))
    v, g = vg(theta)
    return ({"v": np.asarray(v), **{k: x.numpy() for k, x in g.items()}},
            f"grad summed over {P} ranks, |g| = "
            f"{float(g['vp'].abs().max()):.3e}")


def e2_close(got: dict, ref: dict, rtol: float = 1e-10) -> float:
    """The largest |got - ref| over every array, relative to the
    reference array's largest magnitude; raises past ``rtol``."""
    worst = 0.0
    for k, r in ref.items():
        g = got[k]
        scale = max(float(np.abs(r).max()), 1e-300)
        err = float(np.abs(g - r).max()) / scale
        if not (np.isfinite(g).all() and err <= rtol):
            raise AssertionError(f"{k}: rel. error {err:.3e} > {rtol}")
        worst = max(worst, err)
    return worst


def run_e2_cases(comm, out_dir: str, names, n0: int = 4,
                 n_steps: int = 6):
    """Run the E2 paths ``names`` on this ring; rank 0 writes each result
    to <out_dir>/<name>.npz."""
    for name in names:
        out, _ = run_e2(name, comm, n0, n_steps)
        if comm.rank == 0:
            np.savez(os.path.join(out_dir, name + ".npz"), **out)


E2_LABELS = {
    "general": "general", "lane_u": "unstructured-sharded",
    "lane_u_vti": "unstructured-sharded VTI",
    "dd_lane": "lane DD FWI-gradient",
    "dd_merged": "merged DD FWI-gradient",
    "dd_packed": "packed-P1 DD FWI-gradient",
    "dd_lane_u": "unstructured DD FWI-gradient", "shot_dp": "shot-DP",
    "shot_dp_grad": "shot-DP FWI-gradient"}


def _dryrun_worker(comm, n_steps):
    n = comm.world
    for label, dim, deg, kind, kw in (
            ("fused-sharded", 3, 2, "fused", {}),
            ("packed-P1 fused-sharded", 3, 1, "fused", {"packed": True}),
            ("lane-sharded", 3, 2, "lane", {}),
            ("upwind-RK4+visco sharded", 3, 2, "upwind", {"visco": True})):
        case = tiny_case(dim, deg, n0=n)
        st, seis, r = run_case(kind, case, n, comm, n_steps, **kw)
        if comm.rank:
            continue
        ref, rseis, _ = run_case(kind, case, 0, None, n_steps, **kw)
        err = max(float((st.u - ref.u).abs().max()),
                  float((st.s - ref.s).abs().max()),
                  float(np.abs(seis - rseis).max()))
        scale = float(ref.u.abs().max())
        ok = np.isfinite(st.u.numpy()).all() and err <= 1e-10 * scale
        print(f"dryrun_multichip({n}): {label} path "
              f"{'OK' if ok else 'FAILED'} — slab={r.G0loc} "
              f"supercells/rank, E_loc={len(r._old_of_new)}, "
              f"max |diff| vs one device {err:.3e}", flush=True)
        if not ok:
            raise SystemExit(f"{label}: partition invariance broken")
    for name in E2_PATHS:
        got, info = run_e2(name, comm, n0=n, n_steps=n_steps)
        if comm.rank:
            continue
        ref, _ = run_e2(name, None, n0=n, n_steps=n_steps)
        rtol = 1e-9 if name.startswith(("dd_", "shot_dp_")) else 1e-10
        try:
            err = e2_close(got, ref, rtol)
        except AssertionError as e:
            raise SystemExit(f"{E2_LABELS[name]}: partition invariance "
                             f"broken ({e})")
        print(f"dryrun_multichip({n}): {E2_LABELS[name]} path OK — {info}, "
              f"max rel. diff vs one device {err:.3e}", flush=True)


def dryrun_multichip(n: int, n_steps: int = 3) -> None:
    """Spawn n gloo CPU ranks and run every sharded path on box_mesh(n, 3,
    3) (one supercell plane a rank; the unstructured ones on its scrambled
    copy) against its one-device runner; one OK line a path, SystemExit on
    a mismatch."""
    _comm.spawn(_dryrun_worker, n, device="cpu", backend="gloo",
                args=(n_steps,))


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
