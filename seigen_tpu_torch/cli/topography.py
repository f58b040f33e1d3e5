"""Surface-topography demo: an explosive source under a curved free
surface.

Port of ``scripts/topography.py`` over ops/curvilinear.py: a 2D domain
whose free surface carries a smooth topography profile, a Ricker source at
depth and a receiver line riding the curved surface.  The flat rect mesh
is deformed by a z-only map that is the identity below ``z0`` and blends
(smoothstep) into the profile at the surface, so the source projection,
the sponge and the absorbing faces stay exact in flat coordinates while
the free-surface faces are curved.  ``--vtk`` writes the mapped element
vertices, so the snapshots show the curved domain.

    python -m seigen_tpu_torch.cli.topography --nx 48 --nz 24 --degree 3 \\
        --T 0.8 --amp 0.08 --vtk out/topo.pvd --out topo_seis.npz
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..mesh import build_discrete, rect_mesh
from ..ops import Material, build_params
from ..ops.curvilinear import build_curvi, curved_coords, make_curvi_ops
from ..solver import PointSource, State, absorbing_bc_fn, cfl_dt, run
from ..solver.damping import sponge_mask
from ..solver.receivers import build_receivers, line
from ..solver.source import build_sources
from ..utils import PVDWriter, RegionTimer
from . import pick_device, run_dtype


def smoothstep(s):
    s = np.clip(s, 0.0, 1.0)
    return s * s * (3.0 - 2.0 * s)


def topo_map(profile, z0: float, lz: float):
    """z-only diffeomorphism: identity for z <= z0, the full profile at
    z = lz."""
    def f(x):
        out = np.array(x, dtype=np.float64, copy=True)
        blend = smoothstep((x[:, 1] - z0) / (lz - z0))
        out[:, 1] = x[:, 1] + blend * profile(x[:, 0])
        return out

    return f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--nz", type=int, default=24)
    ap.add_argument("--lx", type=float, default=2.0)
    ap.add_argument("--lz", type=float, default=1.0)
    ap.add_argument("--degree", type=int, default=3,
                    choices=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--T", type=float, default=0.8)
    ap.add_argument("--amp", type=float, default=0.08,
                    help="topography amplitude (fraction of lz)")
    ap.add_argument("--profile", choices=["sin", "hill"], default="hill",
                    help="surface shape: sinusoid or central Gaussian hill")
    ap.add_argument("--z0", type=float, default=None,
                    help="depth above which the curvature blends in "
                    "(default 0.55*lz)")
    ap.add_argument("--f0", type=float, default=None)
    ap.add_argument("--cfl", type=float, default=0.3,
                    help="CFL number (the bound uses the mapped minimum "
                    "edge)")
    ap.add_argument("--receivers", type=int, default=32)
    ap.add_argument("--vtk", type=str, default=None)
    ap.add_argument("--vtk-every", type=int, default=50)
    ap.add_argument("--out", type=str, default=None,
                    help="seismogram npz path")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = pick_device(args.cpu)
    dtype = run_dtype(args.f64)
    kw = dict(dtype=dtype, device=dev)

    lx, lz = args.lx, args.lz
    z0 = args.z0 if args.z0 is not None else 0.55 * lz
    mat = Material(rho=1.8, vp=2.5, vs=1.3)
    tm = RegionTimer()
    with tm.region("setup"):
        dm = build_discrete(
            rect_mesh(args.nx, args.nz, lx=lx, ly=lz), args.degree,
            bc_fn=absorbing_bc_fn(((0.0, lx), (0.0, lz)),
                                  free_sides=[(1, "hi")]))
        if args.profile == "sin":
            def prof(x):
                return args.amp * lz * np.sin(2 * np.pi * x / lx)
        else:
            def prof(x):
                return args.amp * lz * np.exp(
                    -((x - 0.5 * lx) ** 2) / (2 * (0.15 * lx) ** 2))
        phi = topo_map(prof, z0, lz)
        cp = build_curvi(dm, curved_coords(dm, phi), **kw)
        vop, sop = make_curvi_ops(cp)
        p = build_params(dm, mat, **kw)

        # CFL from the MAPPED minimum edge length (curved elements shrink)
        cverts = phi(dm.topology.vertices[dm.topology.cells].reshape(-1, 2)
                     ).reshape(-1, 3, 2)
        edges = [np.linalg.norm(cverts[:, a] - cverts[:, b], axis=1)
                 for a, b in ((0, 1), (1, 2), (2, 0))]
        h_min = float(np.minimum(np.minimum(*edges[:2]), edges[2]).min())

        h = float(dm.h.max())
        f0 = args.f0 if args.f0 else 0.2 * mat.vp / h / (args.degree + 1)
        src_z = 0.4 * lz
        if not src_z < z0:
            raise SystemExit("the source must sit in the identity region "
                             f"(z {src_z} < z0 {z0})")
        src = build_sources(
            dm, [PointSource(position=(0.5 * lx, src_z), f0=f0,
                             radius=2 * h)], **kw)
        damp = torch.as_tensor(
            sponge_mask(dm, [(0, "lo"), (0, "hi"), (1, "lo")],
                        width=0.15 * lz), device=dev).to(dtype)

        # receivers ride the curved surface (parameter z just below lz)
        rpts = line((0.06 * lx, 0.999 * lz), (0.94 * lx, 0.999 * lz),
                    args.receivers)
        rcv = build_receivers(dm, rpts, **kw)
        rcv_phys = phi(rpts)

        dt = cfl_dt(h_min, float(mat.vp), args.degree, args.cfl)
        n_steps = int(np.ceil(args.T / dt))
        dt = args.T / n_steps
        E, n_p = dm.num_elements, dm.re.n_p
        st = State(u=torch.zeros((E, n_p, 2), **kw),
                   s=torch.zeros((E, n_p, 3), **kw))

    print(f"E={E} dof={E * n_p * 5} dt={dt:.3e} steps={n_steps} "
          f"f0={f0:.1f} amp={args.amp}")
    pvd = PVDWriter(args.vtk, dm, verts=cverts) if args.vtk else None
    with tm.region("run", sync=st.u):
        seis_chunks = []
        chunk = min(args.vtk_every if pvd else n_steps, n_steps)
        n = 0
        while n < n_steps:
            k = min(chunk, n_steps - n)
            st, ys = run(p, st, dt, k, order=4, src=src, damp=damp,
                         receivers=rcv, record_pressure=True, vel_op=vop,
                         stress_op=sop, step0=n)
            seis_chunks.append(ys.cpu().numpy())
            n += k
            if pvd:
                pvd.write(n * dt, {"u": st.u.cpu().numpy()})
        seis = np.concatenate(seis_chunks, axis=0)

    max_u = float(st.u.abs().max())
    print(f"done: steps={n_steps} max|u|={max_u:.3e} "
          f"timings={json.dumps(tm.report())}")
    if args.out:
        np.savez(args.out, seis=seis, dt=dt, receivers=rpts,
                 receivers_phys=rcv_phys, f0=f0, amp=args.amp,
                 profile=args.profile)
        print(f"seismograms -> {args.out}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"E": E, "n_steps": n_steps, "dt": dt, "f0": f0,
                       "max_u": max_u, "amp": args.amp,
                       "timings": tm.report(), "device": str(dev)}, f,
                      indent=1)
    if not np.isfinite(max_u):
        print("the solution blew up", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
