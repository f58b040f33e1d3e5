"""Explosive-source production run.

Port of ``scripts/explosive_source.py`` with the same flags and defaults:
a 2D or 3D domain, a Ricker explosive point source, a free surface on top,
absorbing faces (characteristic + Cerjan sponge, or ``--pml`` C-PML)
elsewhere, a receiver line, an optional layered/salt model, VTK snapshots,
a seismogram npz, checkpoint/resume and a JSON run report.

    python -m seigen_tpu_torch.cli.explosive_source --dim 3 --n 24 --degree 3
    python -m seigen_tpu_torch.cli.explosive_source --dim 2 --n 16 --cpu \\
        --impl einsum --f64 --out seis.npz

Operator backends (``--impl``): ``auto`` is, on the card, ``merged``
(structured meshes, LF4), ``lane`` (structured, LF2) or ``lane_u``
(unstructured), and with ``--cpu`` ``einsum``; ``merged``
(MergedLaneRunner, K1/K2), ``fused`` (FusedLaneRunner, K8/K9/K10),
``lane`` (LaneMajorRunner, K4/K5), ``lane_u`` (UnstructuredLaneRunner, K4/K5
SEL), ``pallas`` (the element-major wrappers of K4 SIG / K5 TR on the
einsum time step, neighbour traces gathered) and ``einsum``.  The runners
take their CUDA kernels on the card and their plain versions on the CPU.
``--scheme upwind-rk4`` runs UpwindLaneRunner (structured meshes, K3) or
UnstructuredUpwindRunner (K6/K7; also forced by ``--impl lane_u``), or with
``--impl einsum`` the einsum RK4; ``--qp/--qs`` add viscoelastic memory
variables, which ride the checkpoints.

``--shards N`` runs the sharded LF paths on N ranks that the CLI spawns
itself (NCCL, one card a rank; gloo with ``--cpu``), as the JAX script
picks them: ``--dist-impl auto`` takes ShardedFusedRunner (LF4, packed P1
where it applies, ``--vti``), else ShardedLaneRunner (LF2/LF4), both on a
structured mesh with N | G0, else ShardedUnstructuredRunner (Morton
blocks, K4/K5 SEL, any conforming mesh), else the general einsum path
(parallel/dist_ops.py); ``fused``, ``lane``, ``lane_u`` and ``general``
ask for one of them.  Rank 0 writes the seismograms, checkpoints, VTK and
report.  ``--shards`` refuses ``--pml`` (no sharded path) and
``--scheme upwind-rk4`` (the JAX script runs leapfrog there).

    python -m seigen_tpu_torch.cli.explosive_source --dim 3 --n 24 \
        --degree 3 --shards 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..mesh import box_mesh, build_discrete, rect_mesh
from ..mesh.discrete import BC_ABSORB, BC_FREE, DiscreteMesh
from ..ops import Material, build_params, n_sig_for
from ..ops.structured_exchange import detect_structured
from ..solver import PointSource, State, absorbing_bc_fn, build_receivers, \
    build_sources, cfl_dt, line, run, sponge_mask
from ..solver.models import Layer, add_ellipsoid_body, layered_model
from ..solver.receivers import sample
from ..solver.timestep import numpy_dtype
from ..utils import PVDWriter, RegionTimer, load_checkpoint, \
    save_checkpoint, write_run_report
from . import pick_device, run_dtype

IMPLS = ("auto", "einsum", "pallas", "lane", "fused", "merged", "lane_u")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=2, choices=[2, 3])
    ap.add_argument("--n", type=int, default=32,
                    help="elements per unit axis")
    ap.add_argument("--degree", type=int, default=2,
                    choices=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--order", type=int, default=4, choices=[2, 4])
    ap.add_argument("--T", type=float, default=1.0)
    ap.add_argument("--cfl", type=float, default=0.4)
    ap.add_argument("--f0", type=float, default=None,
                    help="Ricker peak frequency (default: resolution-scaled)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="Gmsh .msh file (overrides --dim/--n; source/"
                         "receivers placed extent-relative)")
    ap.add_argument("--bc-free", type=str, default=None,
                    help="comma-separated Gmsh physical group names mapped "
                         "to free-surface BCs")
    ap.add_argument("--bc-absorb", type=str, default=None,
                    help="comma-separated Gmsh physical group names mapped "
                         "to absorbing BCs")
    ap.add_argument("--layered", action="store_true",
                    help="layered + salt-body heterogeneous model")
    ap.add_argument("--receivers", type=int, default=16)
    ap.add_argument("--shards", type=int, default=0,
                    help="mesh-sharded run on this many ranks (one card "
                         "each; gloo CPU processes with --cpu)")
    ap.add_argument("--dist-impl",
                    choices=["auto", "fused", "lane", "lane_u", "general"],
                    default="auto",
                    help="sharded backend: fused (slab-sharded merged "
                         "kernels), lane (slab-sharded lane kernels), "
                         "lane_u (Morton blocks, all-gathered trace "
                         "panels), general (einsum, permute halos); auto "
                         "picks fused > lane > lane_u > general")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain operator versions)")
    ap.add_argument("--vtk", type=str, default=None,
                    help="write PVD/VTU snapshots to this .pvd path")
    ap.add_argument("--vtk-every", type=int, default=50)
    ap.add_argument("--out", type=str, default=None,
                    help="seismogram npz output path")
    ap.add_argument("--report", type=str, default=None,
                    help="JSON run report path")
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--vti", type=str, default=None,
                    help="'epsilon,delta,gamma' Thomsen parameters: a VTI "
                         "medium (3D, scheme lf; the merged/fused/lane/"
                         "lane_u kernels' general Hooke law, or einsum)")
    ap.add_argument("--qp", type=float, default=None,
                    help="P/bulk quality factor Q_kappa (viscoelastic "
                         "attenuation; requires --scheme upwind-rk4)")
    ap.add_argument("--qs", type=float, default=None,
                    help="S/shear quality factor Q_mu (viscoelastic "
                         "attenuation; requires --scheme upwind-rk4)")
    ap.add_argument("--pml", type=float, default=None,
                    help="C-PML width (domain units) on the absorbing "
                         "sides, replacing the Cerjan sponge (RK4; "
                         "CpmlLaneRunner on structured meshes with --impl "
                         "merged, the einsum run_cpml with --impl einsum)")
    ap.add_argument("--scheme", choices=["lf", "upwind-rk4"], default="lf",
                    help="'lf': staggered leapfrog + central flux; "
                         "'upwind-rk4': Godunov flux + RK4")
    ap.add_argument("--impl", choices=IMPLS, default="auto",
                    help="operator backend (see the module docstring)")
    return ap


@dataclass
class Case:
    """What the setup builds: mesh, material, operator data, source,
    receivers, sponge, time step and the initial state."""

    dm: DiscreteMesh
    mat: Material
    p: object
    src: object
    rcv: object
    damp: torch.Tensor
    absorb: list
    aniso_C: np.ndarray | None
    vp_max: float
    f0: float
    dt: float
    n_steps: int
    st: State
    step0: int
    extras: dict
    rec_a: tuple
    rec_b: tuple


def setup(args, dev: torch.device, dtype: torch.dtype) -> Case:
    dim = args.dim
    if args.mesh:
        from ..mesh.gmsh_io import read_msh
        from ..mesh.recover import recover_structure

        topo = recover_structure(read_msh(args.mesh))
        if topo.structure is not None:
            print(f"recovered structure: grid={topo.structure[0]} "
                  f"m={topo.structure[1]}")
        dim = topo.dim
        extents = topo.extents
    else:
        extents = ((0.0, 2.0), (0.0, 1.0)) if dim == 2 else (
            (0.0, 1.0), (0.0, 1.0), (0.0, 1.0))
        topo = (rect_mesh(2 * args.n, args.n, lx=2.0, ly=1.0) if dim == 2
                else box_mesh(args.n, args.n, args.n))
    if dim == 2:
        free = [(1, "hi")]
        absorb = [(0, "lo"), (0, "hi"), (1, "lo")]
    else:
        free = [(2, "hi")]
        absorb = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]

    def frac(fr):  # extent-relative positions (imported meshes too)
        return tuple(lo + f * (hi - lo) for f, (lo, hi) in zip(fr, extents))

    if dim == 2:
        src_pos = frac((0.5, 0.8))
        rec_a, rec_b = frac((0.1, 0.95)), frac((0.9, 0.95))
    else:
        src_pos = frac((0.5, 0.5, 0.8))
        rec_a, rec_b = frac((0.1, 0.5, 0.95)), frac((0.9, 0.5, 0.95))
    bc_groups = None
    if args.bc_free or args.bc_absorb:
        bc_groups = {}
        for name in (args.bc_free or "").split(","):
            if name:
                bc_groups[name] = BC_FREE
        for name in (args.bc_absorb or "").split(","):
            if name:
                bc_groups[name] = BC_ABSORB
    dm = build_discrete(topo, args.degree,
                        bc_fn=absorbing_bc_fn(extents, free),
                        bc_groups=bc_groups)

    if args.layered:
        depth_hi = extents[-1][1]
        layers = [
            Layer(bottom=0.6 * depth_hi, top=depth_hi * 1.01,
                  rho=1.0, vp=1.5, vs=0.8),
            Layer(bottom=0.3 * depth_hi, top=0.6 * depth_hi,
                  rho=1.2, vp=2.5, vs=1.4),
            Layer(bottom=-0.01, top=0.3 * depth_hi,
                  rho=1.5, vp=3.5, vs=2.0),
        ]
        mat = layered_model(dm, layers)
        center = (1.0, 0.45) if dim == 2 else (0.5, 0.5, 0.45)
        radii = (0.3, 0.15) if dim == 2 else (0.2, 0.2, 0.12)
        mat = add_ellipsoid_body(dm, mat, center, radii,
                                 rho=2.1, vp=4.5, vs=2.6)
    else:
        mat = Material(rho=1.0, vp=2.0, vs=1.0)

    aniso_C = None
    vp_max = float(np.asarray(mat.vp).max())
    if args.vti:
        if dim != 3:
            raise SystemExit("--vti needs a 3D run")
        if args.scheme != "lf":
            raise SystemExit("--vti supports --scheme lf")
        from ..ops.anisotropic import vti_stiffness

        eps_, del_, gam_ = (float(x) for x in args.vti.split(","))
        C = vti_stiffness(np.asarray(mat.vp), np.asarray(mat.vs),
                          np.asarray(mat.rho), eps_, del_, gam_)
        aniso_C = np.broadcast_to(C, (dm.num_elements, 6, 6))
        # CFL bound: phase speeds <= sqrt(||C||_F / rho)
        fro = np.sqrt((aniso_C**2).sum(axis=(1, 2))).max()
        vp_max = max(vp_max,
                     float(np.sqrt(fro / np.asarray(mat.rho).min())))
        print(f"VTI: epsilon={eps_} delta={del_} gamma={gam_} "
              f"(vmax bound {vp_max:.2f})")
    h = float(dm.h.min())
    f0 = args.f0 if args.f0 else 0.2 * vp_max / h / (args.degree + 1)
    kw = dict(dtype=dtype, device=dev)
    p = build_params(dm, mat, **kw)
    src = build_sources(
        dm, [PointSource(position=src_pos, f0=f0, radius=2 * h)], mat=mat,
        **kw)
    rcv = build_receivers(dm, line(rec_a, rec_b, args.receivers), **kw)
    damp = torch.as_tensor(sponge_mask(dm, absorb, width=0.15),
                           device=dev).to(dtype)
    dt = cfl_dt(h, vp_max, args.degree, args.cfl)
    n_steps = int(np.ceil(args.T / dt))
    E, n_p = dm.num_elements, dm.re.n_p

    extras = {}
    if args.resume:
        st, step0, meta = load_checkpoint(args.resume, dtype=dtype,
                                          device=dev)
        extras = meta.get("_extras", {})
    else:
        st, step0 = State(
            u=torch.zeros((E, n_p, dim), **kw),
            s=torch.zeros((E, n_p, n_sig_for(dim)), **kw)), 0
    return Case(dm=dm, mat=mat, p=p, src=src, rcv=rcv, damp=damp,
                absorb=absorb, aniso_C=aniso_C, vp_max=vp_max, f0=f0,
                dt=dt, n_steps=n_steps, st=st, step0=step0, extras=extras,
                rec_a=rec_a, rec_b=rec_b)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _vtk_fields(st, dim: int) -> dict:
    """The snapshot's fields on the host: velocity and the pressure
    -tr(sigma)/dim."""
    return {"u": _host(st.u), "p": _host(-st.s[..., :dim].mean(dim=-1))}


def _structured(dm, impl: str):
    ex = detect_structured(dm)
    if ex is None:
        raise SystemExit(f"--impl {impl} needs a structured mesh "
                         "(use lane_u)")
    return ex


def run_pml(args, c: Case, timer: RegionTimer, cpu: bool):
    """The C-PML branch: CpmlLaneRunner (``--impl merged``, and ``auto``
    on the card when the mesh is structured) or the einsum run_cpml.
    Returns (final State, seismogram chunks)."""
    if (args.scheme != "lf" or args.vti or args.qp is not None
            or args.qs is not None):
        raise SystemExit("--pml is isotropic and elastic (no --vti/--qp/"
                         "--qs; its stepper is its own RK4, not --scheme)")
    if args.checkpoint or args.resume:
        raise SystemExit("--pml does not support checkpoint/resume yet")
    if args.impl not in ("auto", "einsum", "merged"):
        raise SystemExit("--pml rides the einsum or merged path "
                         "(--impl auto|einsum|merged)")
    dim = c.dm.dim
    ex = None
    if args.impl == "merged":
        ex = _structured(c.dm, "merged")
    elif args.impl == "auto" and not cpu:
        ex = detect_structured(c.dm)
    seis = []
    if ex is not None:
        from ..solver.lane_cpml import CpmlLaneRunner

        lr = CpmlLaneRunner(c.p, c.dm, ex, c.dt, c.absorb, args.pml,
                            c.vp_max, f0=c.f0, src=c.src, receivers=c.rcv)
        print(f"impl: cpml-lane (width={args.pml}, RK4 merged split ops, "
              f"{len(c.absorb)} sides)")
        with timer.region("run", sync=c.st.u):
            st, ys = lr.run(c.st, c.n_steps)
        if ys is not None:
            seis.append(ys)
        if args.vtk:
            PVDWriter(args.vtk, c.dm).write(c.n_steps * c.dt,
                                            _vtk_fields(st, dim))
        return st, seis

    from ..solver import cpml_init, cpml_profiles, make_cpml_rhs
    from ..solver.pml import run_cpml

    dprof, aprof = cpml_profiles(c.dm, c.absorb, args.pml, c.vp_max,
                                 f0=c.f0)
    rhs = make_cpml_rhs(c.p, dprof, aprof, src=c.src)
    cst = cpml_init(c.p, c.st.u, c.st.s)
    print(f"impl: cpml (width={args.pml}, RK4 einsum, {len(c.absorb)} "
          "sides)")
    pvd = PVDWriter(args.vtk, c.dm) if args.vtk else None
    chunk = min(args.vtk_every if pvd else c.n_steps, c.n_steps)
    with timer.region("run", sync=c.st.u):
        n = 0
        while n < c.n_steps:
            k = min(chunk, c.n_steps - n)
            cst, ys = run_cpml(c.p, cst, c.dt, k, rhs, receivers=c.rcv,
                               step0=n)
            if ys is not None:
                seis.append(_host(ys))
            n += k
            if pvd and (n % args.vtk_every == 0 or n == c.n_steps):
                pvd.write(n * c.dt, _vtk_fields(cst, dim))
    return State(u=cst.u, s=cst.s), seis


def make_advance(args, c: Case, cpu: bool):
    """The time loop's ``advance(state, xi, n0, k) -> (state, xi,
    seismograms numpy or None)`` for the scheme and ``--impl``, and the
    viscoelastic data (None for an elastic run)."""
    p, dm = c.p, c.dm
    runner_kw = dict(src=c.src, damp=c.damp, receivers=c.rcv)
    impl = args.impl
    if impl == "auto" and cpu:
        impl = "einsum"
    if c.aniso_C is not None and impl == "pallas":
        raise SystemExit("--vti rides --impl merged/fused/lane/lane_u/"
                         "einsum")
    runner = visco = None
    if args.scheme == "lf":
        if args.qp is not None or args.qs is not None:
            raise SystemExit("--qp/--qs need --scheme upwind-rk4")
        ex = None
        if impl == "auto":  # on the card
            ex = detect_structured(dm)
            impl = ("lane_u" if ex is None
                    else "merged" if args.order == 4 else "lane")
        elif impl in ("merged", "fused", "lane"):
            ex = _structured(dm, impl)
        stiff = dict(stiffness=c.aniso_C)
        if impl == "lane_u":
            from ..solver.lane_unstructured import UnstructuredLaneRunner

            runner = UnstructuredLaneRunner(
                p, c.dt, order=args.order,
                centroids=np.asarray(dm.coords.mean(axis=1)),
                **runner_kw, **stiff)
        elif impl == "merged":
            if args.order != 4:
                raise SystemExit("--impl merged is LF4 only (--order 4)")
            from ..solver.lane_merged import MergedLaneRunner

            # packed="auto": P1 isotropic meshes take the two-elements-
            # per-lane layout
            runner = MergedLaneRunner(p, ex, c.dt,
                                      packed="auto", **runner_kw, **stiff)
        elif impl == "fused":
            from ..solver.lane_fused import FusedLaneRunner

            runner = FusedLaneRunner(p, ex, c.dt,
                                     order=args.order, **runner_kw, **stiff)
        elif impl == "lane":
            from ..solver.lane_major import LaneMajorRunner

            runner = LaneMajorRunner(p, ex, c.dt,
                                     order=args.order, **runner_kw, **stiff)
        if runner is not None:
            print(f"impl: {impl}")
    else:
        from ..ops import build_upwind_data

        wdata = build_upwind_data(dm, c.mat, dtype=p.dtype, device=p.device)
        if args.qp is not None or args.qs is not None:
            from ..ops.viscoelastic import build_visco

            visco = build_visco(p, args.qp or np.inf, args.qs or np.inf,
                                0.25 * c.f0, 2.5 * c.f0)
            print(f"viscoelastic: Qp={args.qp} Qs={args.qs} "
                  f"band=[{0.25 * c.f0:.2f},{2.5 * c.f0:.2f}] Hz")
        if impl != "einsum":
            # an explicit --impl lane_u drives the unstructured Godunov
            # runner even on structured meshes; otherwise structure wins
            ex = None if impl == "lane_u" else detect_structured(dm)
            if ex is not None:
                from ..solver.lane_upwind import UpwindLaneRunner

                runner = UpwindLaneRunner(p, ex, wdata, c.dt, visco=visco,
                                          **runner_kw)
                print("impl: upwind_lane (merged exchange-in-kernel RK4)")
            else:
                from ..solver.lane_upwind_u import UnstructuredUpwindRunner

                runner = UnstructuredUpwindRunner(
                    p, wdata, c.dt, visco=visco,
                    centroids=np.asarray(dm.coords.mean(axis=1)),
                    **runner_kw)
                print("impl: upwind_lane_u (lane-take Godunov RK4)")
        else:
            print("impl: einsum (upwind oracle)")

    if runner is not None and visco is not None:
        def advance(st, xi, n0, k):
            return runner.run_xi(st, xi, k, step0=n0)
    elif runner is not None:
        def advance(st, xi, n0, k):
            fin, ys = runner.run(st, k, step0=n0)
            return fin, None, ys
    elif args.scheme == "upwind-rk4":
        from ..solver.rk4 import make_rk4_step, make_rk4_step_visco

        npdt = numpy_dtype(p.dtype)
        dt_ = npdt(c.dt)
        if visco is not None:
            step = make_rk4_step_visco(p, wdata, visco, c.dt, src=c.src,
                                       damp=c.damp)
        else:
            rk4 = make_rk4_step(p, wdata, c.dt, src=c.src, damp=c.damp)

            def step(st, xi, t):
                return rk4(st, t), None

        def advance(st, xi, n0, k):
            ys = []
            for n in range(n0, n0 + k):
                st, xi = step(st, xi, npdt(n) * dt_)
                if c.rcv is not None:
                    ys.append(sample(c.rcv, st.u))
            return st, xi, (_host(torch.stack(ys)) if ys else None)
    else:
        ops = {}
        if impl == "pallas":
            from ..ops.lane_kernels import make_pallas_ops

            ops = dict(zip(("vel_op", "stress_op"), make_pallas_ops(p)))
        elif c.aniso_C is not None:
            from ..ops.anisotropic import make_aniso_stress_op

            ops["stress_op"] = make_aniso_stress_op(torch.as_tensor(
                np.ascontiguousarray(c.aniso_C), device=p.device
            ).to(p.dtype))
        print(f"impl: {impl}")

        def advance(st, xi, n0, k):
            fin, ys = run(p, st, c.dt, k, order=args.order, src=c.src,
                          damp=c.damp, receivers=c.rcv, step0=n0, **ops)
            return fin, None, (None if ys is None else _host(ys))
    return advance, visco


def refuse_shards(args):
    """Exit non-zero for a ``--shards`` run that has no sharded path (the
    C-PML), or whose JAX dispatch would run other physics than asked."""
    if args.pml is not None:
        raise SystemExit("--pml has no sharded path")
    if args.scheme != "lf":
        raise SystemExit(
            f"--shards with --scheme {args.scheme}: the JAX script sends "
            "this to the general sharded path, whose step is leapfrog, not "
            "the RK4 that was asked for; refused (ROADMAP.md Queue 3)")
    if args.dist_impl == "general" and args.vti is not None:
        raise SystemExit("--dist-impl general is isotropic: --vti rides "
                         "--dist-impl auto|fused|lane|lane_u")


def make_sharded_advance(args, c: Case, comm):
    """``advance`` of a ``--shards`` run on this rank (the chunk's global
    State and seismograms on every rank), as the JAX script picks its
    sharded path: ``auto`` tries fused, then lane, then lane_u, then the
    general einsum path; ``lane_u`` takes a per-element ``--vti``
    stiffness into K5 SEL."""
    from ..parallel import ShardedFusedRunner, ShardedLaneRunner, \
        ShardedUnstructuredRunner
    from ..parallel.dist_ops import run_distributed

    ex = detect_structured(c.dm)
    eligible = ex is not None and ex.grid[0] % args.shards == 0
    kw = dict(src=c.src, damp=c.damp, receivers=c.rcv, comm=comm)
    runner = None
    if args.dist_impl in ("auto", "lane", "fused"):
        if eligible and args.dist_impl in ("auto", "fused") and \
                args.order == 4:
            try:
                runner = ShardedFusedRunner(c.p, ex, c.dt, args.shards,
                                            stiffness=c.aniso_C,
                                            packed="auto", **kw)
                name = "fused (slab"
            except ValueError:
                if args.dist_impl == "fused":
                    raise
        if runner is None and c.aniso_C is not None:
            raise SystemExit(
                "--vti with --shards needs the fused DD pipeline "
                f"(mesh grid={None if ex is None else ex.grid}, "
                f"shards={args.shards})")
        if runner is None and eligible and args.dist_impl in ("auto",
                                                              "lane"):
            runner = ShardedLaneRunner(c.p, ex, c.dt, args.shards,
                                       order=args.order, **kw)
            name = "lane (slab"
        if runner is None and args.dist_impl in ("lane", "fused"):
            raise SystemExit(
                f"--dist-impl {args.dist_impl} needs a structured mesh "
                "with shards | G0 "
                f"(got grid={None if ex is None else ex.grid})")
    if runner is None and args.dist_impl in ("auto", "lane_u"):
        runner = ShardedUnstructuredRunner(
            c.p, c.dt, args.shards, order=args.order,
            centroids=np.asarray(c.dm.coords.mean(axis=1)),
            stiffness=c.aniso_C, **kw)
        name = "lane_u (Morton blocks"
    if runner is None:
        name = "general (permute"
    if comm.rank == 0:
        print(f"sharded path: {name} x{args.shards}, "
              f"{comm.backend or 'one rank'})")
    if runner is not None:
        def advance(st, xi, n0, k):
            fin, ys = runner.run(st, k, step0=n0)
            return fin, None, ys

        return advance, None
    plan = None

    def advance(st, xi, n0, k):
        nonlocal plan
        fin, ys, plan = run_distributed(
            c.dm, c.mat, st, c.dt, k, comm=comm, order=args.order,
            sources=c.src, damp=c.damp, receivers=c.rcv, dtype=c.p.dtype,
            step0=n0, plan=plan)
        return fin, None, ys

    return advance, None


def time_loop(args, c: Case, timer: RegionTimer, cpu: bool, comm=None):
    """Steps step0..n_steps in chunks of ``--vtk-every`` /
    ``--checkpoint-every``: snapshots and checkpoints between chunks, the
    seismograms brought to the host once a chunk.  Returns (final State,
    seismogram chunks).  ``comm``: a rank of a ``--shards`` run (every rank
    steps the same chunks; rank 0 writes)."""
    dm, dim = c.dm, c.dm.dim
    advance, visco = (make_advance(args, c, cpu) if comm is None
                      else make_sharded_advance(args, c, comm))
    write = comm is None or comm.rank == 0
    pvd = PVDWriter(args.vtk, dm) if args.vtk and write else None
    chunk = min(args.checkpoint_every if args.checkpoint else c.n_steps,
                args.vtk_every if args.vtk else c.n_steps, c.n_steps)
    st, xi = c.st, None
    if visco is not None:
        xi = c.extras.get("xi")
        if xi is None:
            xi = torch.zeros(tuple(st.s.shape) + (visco.L,),
                             dtype=st.s.dtype, device=st.s.device)
    seis = []
    with timer.region("run", sync=st.u):
        n = c.step0
        while n < c.n_steps:
            k = min(chunk, c.n_steps - n)
            st, xi, ys = advance(st, xi, n, k)
            if ys is not None:
                seis.append(ys)
            n += k
            if pvd and (n % args.vtk_every == 0 or n == c.n_steps):
                pvd.write(n * c.dt, _vtk_fields(st, dim))
            if write and args.checkpoint and (
                    n % args.checkpoint_every == 0 or n == c.n_steps):
                save_checkpoint(args.checkpoint, st, n,
                                {"dt": c.dt, "T": args.T},
                                extras=None if xi is None else {"xi": xi})
    return st, seis


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.shards:
        refuse_shards(args)
        pick_device(args.cpu)
        from ..parallel.comm import init, spawn

        if args.shards == 1:
            return _rank_main(init(0, 1, None, "", "cpu" if args.cpu
                                   else "cuda"), args)
        try:
            spawn(_rank_entry, args.shards,
                  device="cpu" if args.cpu else "cuda",
                  backend="gloo" if args.cpu else "nccl", args=(args,))
        except Exception as e:  # a rank failed: its error is printed
            print(f"sharded run failed: {e}", file=sys.stderr)
            return 1
        return 0
    return _rank_main(None, args)


def _rank_entry(comm, args):
    rc = _rank_main(comm, args)
    if rc:
        raise SystemExit(rc)


def _rank_main(comm, args) -> int:
    """The run itself; with ``comm`` one rank of a ``--shards`` run (a
    rank whose wavefield is not finite exits 1)."""
    dev = pick_device(args.cpu) if comm is None else comm.device
    rank0 = comm is None or comm.rank == 0
    timer = RegionTimer()
    with timer.region("setup"):
        c = setup(args, dev, run_dtype(args.f64))
    dm = c.dm
    E, n_p, dim = dm.num_elements, dm.re.n_p, dm.dim
    dof = E * n_p * (dim + n_sig_for(dim))
    if rank0:
        print(f"E={E} dof={dof} dt={c.dt:.3e} steps={c.n_steps} "
              f"f0={c.f0:.1f}")
    if args.pml is not None:
        st, seis_chunks = run_pml(args, c, timer, args.cpu)
    else:
        st, seis_chunks = time_loop(args, c, timer, args.cpu, comm=comm)
    if not rank0:
        umax = float(st.u.abs().max())
        if not np.isfinite(umax):
            raise SystemExit(1)
        return 0

    seis = np.concatenate(seis_chunks, axis=0) if seis_chunks else None
    if args.out and seis is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        np.savez_compressed(args.out, seismograms=seis, dt=c.dt,
                            receivers=line(c.rec_a, c.rec_b, args.receivers))
        print(f"seismograms -> {args.out}")
    if args.report:
        write_run_report(
            args.report, vars(args), timer.report(),
            {"E": E, "n_steps": c.n_steps, "dt": c.dt, "f0": c.f0,
             "dof": dof, "step0": c.step0, "device": str(dev),
             "device_name": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")})
    umax = float(st.u.abs().max())
    print(f"done: steps={c.n_steps} max|u|={umax:.3e} "
          f"timings={json.dumps(timer.report())}")
    if not np.isfinite(umax):
        print("the wavefield is not finite", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
