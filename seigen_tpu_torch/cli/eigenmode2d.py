"""2D eigenmode convergence study.

Port of ``scripts/eigenmode2d.py``: an analytic plane-wave eigenmode on a
periodic unit square for an h-refinement series at one degree, through
the einsum LF time step (``timestep.run``) or the einsum Godunov RK4
(``run_rk4``); prints the L2 errors and the observed convergence order and
exits non-zero if ``--min-order`` is not reached.

    python -m seigen_tpu_torch.cli.eigenmode2d --degree 2 --sizes 4,8,16 \\
        --f64 --min-order 2.8
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..mesh import build_discrete, rect_mesh
from ..ops import Material, build_params
from ..solver import PlaneWave, State, cfl_dt, convergence_order, \
    interpolate, l2_error, run
from . import pick_device, run_dtype


def eigenmode_error(dm, mat, pw, T, degree, cfl, scheme, order, dtype,
                    dev):
    """(steps, L2(u) at T) of the plane wave ``pw`` on the periodic mesh
    ``dm``: LF (order 2 or 4, sigma interpolated at dt/2) or, with
    ``scheme="upwind-rk4"``, RK4 from co-located data."""
    p = build_params(dm, mat, dtype=dtype, device=dev)
    dt = cfl_dt(dm.h.min(), float(np.asarray(mat.vp)), degree, cfl)
    n_steps = int(np.ceil(T / dt))
    dt = T / n_steps

    def field(fn, t):
        return torch.as_tensor(interpolate(dm, fn, t), device=dev).to(dtype)

    if scheme == "upwind-rk4":
        from ..ops import build_upwind_data
        from ..solver.rk4 import run_rk4

        st = State(u=field(pw.u, 0.0), s=field(pw.sigma, 0.0))
        fin, _ = run_rk4(p, build_upwind_data(dm, mat, dtype=dtype,
                                              device=dev), st, dt, n_steps)
    else:
        st = State(u=field(pw.u, 0.0), s=field(pw.sigma, 0.5 * dt))
        fin, _ = run(p, st, dt, n_steps, order=order)
    return n_steps, l2_error(dm, fin.u, pw.u, n_steps * dt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--degree", type=int, default=2,
                    choices=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--sizes", type=str, default="4,8,16",
                    help="comma-separated mesh sizes N (NxN quads x2 tris)")
    ap.add_argument("--order", type=int, default=4, choices=[2, 4],
                    help="leapfrog temporal order (LF2/LF4)")
    ap.add_argument("--cfl", type=float, default=0.4)
    ap.add_argument("--periods", type=float, default=1.0,
                    help="simulation length in eigenmode periods")
    ap.add_argument("--mode", choices=["S", "P"], default="S")
    ap.add_argument("--scheme", choices=["lf", "upwind-rk4"], default="lf",
                    help="'upwind-rk4' restores q+1 orders at odd degrees")
    ap.add_argument("--f64", action="store_true", help="float64")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--json", type=str, default=None,
                    help="write results JSON here")
    ap.add_argument("--min-order", type=float, default=None,
                    help="fail if the observed order is below this")
    args = ap.parse_args(argv)
    dev = pick_device(args.cpu)
    dtype = run_dtype(args.f64)

    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    pw = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0]),
                   mode=args.mode)
    T = args.periods * pw.period
    sizes = [int(s) for s in args.sizes.split(",")]
    results = []
    for N in sizes:
        dm = build_discrete(rect_mesh(N, N, periodic=(0, 1)), args.degree)
        n_steps, err = eigenmode_error(dm, mat, pw, T, args.degree,
                                       args.cfl, args.scheme, args.order,
                                       dtype, dev)
        results.append({"N": N, "h": 1.0 / N, "steps": n_steps,
                        "l2_error_u": err})
        print(f"N={N:4d}  steps={n_steps:5d}  L2(u) = {err:.6e}")

    order = None
    if len(sizes) >= 2:
        order = convergence_order([r["h"] for r in results],
                                  [r["l2_error_u"] for r in results])
        print(f"observed spatial order: {order:.2f} (degree {args.degree})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": vars(args), "results": results,
                       "observed_order": order, "device": str(dev)}, f,
                      indent=2)
    if args.min_order is not None and order is not None \
            and order < args.min_order:
        print(f"FAIL: order {order:.2f} < {args.min_order}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
