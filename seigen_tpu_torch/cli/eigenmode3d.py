"""3D eigenmode convergence sweep (P1-P4, h-refinement, order check).

Port of ``scripts/eigenmode3d.py``: an S plane wave on the periodic unit
cube for each degree and mesh size, through the einsum LF time step or
the einsum Godunov RK4 (``--scheme upwind-rk4``); exits non-zero if a
degree's observed order is below ``--min-order``.

    python -m seigen_tpu_torch.cli.eigenmode3d --degrees 1,2,3,4 \\
        --sizes 2,4 --f64 --cpu
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..mesh import box_mesh, build_discrete
from ..ops import Material
from ..solver import PlaneWave, convergence_order
from . import pick_device, run_dtype
from .eigenmode2d import eigenmode_error


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--degrees", type=str, default="1,2,3,4")
    ap.add_argument("--sizes", type=str, default="2,4",
                    help="N per axis (6*N^3 tets)")
    ap.add_argument("--order", type=int, default=4, choices=[2, 4])
    ap.add_argument("--scheme", choices=["lf", "upwind-rk4"], default="lf",
                    help="'lf': central flux + leapfrog; 'upwind-rk4': "
                         "Godunov flux + RK4 (q+1 orders at odd degrees)")
    ap.add_argument("--cfl", type=float, default=0.4)
    ap.add_argument("--periods", type=float, default=0.5)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--min-order", type=float, default=None,
                    help="fail if a degree's observed order is below this")
    args = ap.parse_args(argv)
    dev = pick_device(args.cpu)
    dtype = run_dtype(args.f64)

    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    pw = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0, 0.0]),
                   mode="S", polarization=np.array([0.0, 0.0, 1.0]))
    T = args.periods * pw.period
    sweep, low = {}, []
    for degree in [int(d) for d in args.degrees.split(",")]:
        rows = []
        for N in [int(s) for s in args.sizes.split(",")]:
            dm = build_discrete(box_mesh(N, N, N, periodic=(0, 1, 2)),
                                degree)
            n_steps, err = eigenmode_error(dm, mat, pw, T, degree, args.cfl,
                                           args.scheme, args.order, dtype,
                                           dev)
            rows.append({"N": N, "h": 1.0 / N, "steps": n_steps,
                         "l2_error_u": err})
            print(f"P{degree} N={N:3d} steps={n_steps:5d} L2(u)={err:.6e}")
        order = (convergence_order([r["h"] for r in rows],
                                   [r["l2_error_u"] for r in rows])
                 if len(rows) >= 2 else None)
        if order is not None:
            print(f"P{degree}: observed order {order:.2f}")
            if args.min_order is not None and order < args.min_order:
                low.append(f"P{degree} {order:.2f}")
        sweep[f"P{degree}"] = {"rows": rows, "observed_order": order}

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": vars(args), "sweep": sweep,
                       "device": str(dev)}, f, indent=2)
    if low:
        print(f"FAIL: order below {args.min_order}: {', '.join(low)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
