"""Multi-rank dry run of the sharded paths on CPU processes.

``dryrun_multichip(n)`` is the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: it spawns ``n`` gloo ranks on the
CPU and runs every sharded path of the port on a tiny mesh — the merged
LF4 runner, its packed P1 layout, the lane-major LF4 runner and upwind
RK4 with viscoelastic Q — each against its one-device runner (partition
invariance, f64), printing one ``OK`` line a path.

``run_cases`` runs named cases of the same paths on a spawned ring and
writes each result (u, s, seismograms) to ``<out_dir>/<name>.npz`` from
rank 0; ``tiny_case`` builds their inputs.  A case of one rank runs on
one of the ranks with a ring of its own, so the other ranks work
meanwhile.

    python -m seigen_tpu_torch.parallel.dryrun [n]
"""

from __future__ import annotations

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
              dtype=torch.float64, device="cpu"):
    """A small bounded structured case: box_mesh(n0, 3, 3) (3D) or
    rect_mesh(2*n0, 4) (2D), a free top, a sponge on the other sides, one
    blob source, 3 receivers on a line, a random density per element and a
    random state from ``seed``.  Returns (dm, p, damp, receivers, sources,
    dt, state)."""
    rng = np.random.default_rng(seed)
    if dim == 3:
        topo, free = mesh.box_mesh(n0, 3, 3), (2, "hi")
        sides = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
        pos, a, b = (0.5, 0.5, 0.7), (0.2, 0.5, 0.9), (0.8, 0.5, 0.9)
    else:
        topo, free = mesh.rect_mesh(2 * n0, 4), (1, "hi")
        sides = [(0, "lo"), (0, "hi"), (1, "lo")]
        pos, a, b = (0.5, 0.6), (0.2, 0.9), (0.8, 0.9)
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


def dryrun_multichip(n: int, n_steps: int = 3) -> None:
    """Spawn n gloo CPU ranks and run every sharded path on box_mesh(n, 3,
    3) (one supercell plane a rank) against its one-device runner; one OK
    line a path, SystemExit on a mismatch."""
    _comm.spawn(_dryrun_worker, n, device="cpu", backend="gloo",
                args=(n_steps,))


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
