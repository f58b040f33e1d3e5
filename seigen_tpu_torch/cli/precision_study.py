"""The precision gate: a long 2D P3 eigenmode through the kernels in f32.

The JAX package's study (``scripts/precision_study.py``) sweeps the TPU
kernels' in-kernel matrix-product precision schemes.  The port's kernels
have one precision, FP32 FMA, so there is nothing to sweep: the study runs
the same case twice — 2D P3 ``rect_mesh(16, 16)`` periodic, an S plane
wave, two periods (about 1120 steps) —

- through FusedLaneRunner with the kernels (K8, K9, K10) in float32, and
- through its plain version (``impl="reference"``) in float64,

and writes both L2 errors against the analytic solution to
``results/torch_precision_study.json``.  It fails unless the kernel run's
error is at most 1.1 x the float64 run's and below 1e-4.  With ``--cpu``
the first run is the plain version in float32 (the kernels run only on
the card).

    python -m seigen_tpu_torch.cli.precision_study [--N 16 --degree 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..mesh import build_discrete, rect_mesh
from ..ops import Material, build_params
from ..ops.structured_exchange import detect_structured
from ..solver import PlaneWave, State, cfl_dt, interpolate, l2_error
from ..solver.lane_fused import FusedLaneRunner
from . import pick_device

MAX_RATIO = 1.1  # kernel f32 error / f64 error, at most
MAX_ERR = 1e-4


def eigen_error(dm, N, degree, periods, dtype, dev, impl) -> dict:
    """L2(u) of the S plane wave after ``periods`` periods through
    FusedLaneRunner(impl) in ``dtype`` on ``dev``."""
    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    p = build_params(dm, mat, dtype=dtype, device=dev)
    pw = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    T = periods * pw.period
    dt = cfl_dt(dm.h.min(), 2.0, degree, 0.4)
    n_steps = int(np.ceil(T / dt))
    dt = T / n_steps
    st = State(*(torch.as_tensor(interpolate(dm, f, t), device=dev).to(dtype)
                 for f, t in ((pw.u, 0.0), (pw.sigma, 0.5 * dt))))
    r = FusedLaneRunner(p, detect_structured(dm), dt, order=4, impl=impl)
    out, _ = r.run(st, n_steps)
    return {"err": l2_error(dm, out.u, pw.u, n_steps * dt),
            "steps": n_steps, "dtype": str(dtype).replace("torch.", ""),
            "impl": impl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--N", type=int, default=16)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--periods", type=float, default=2.0)
    ap.add_argument("--out", type=str,
                    default="results/torch_precision_study.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions only)")
    args = ap.parse_args(argv)
    dev = pick_device(args.cpu)
    dm = build_discrete(rect_mesh(args.N, args.N, periodic=(0, 1)),
                        args.degree)
    kernel = "reference" if args.cpu else "kernel"
    runs = {"f32": eigen_error(dm, args.N, args.degree, args.periods,
                               torch.float32, dev, kernel),
            "f64": eigen_error(dm, args.N, args.degree, args.periods,
                               torch.float64, dev, "reference")}
    ratio = runs["f32"]["err"] / runs["f64"]["err"]
    ok = ratio <= MAX_RATIO and runs["f32"]["err"] < MAX_ERR
    out = {"N": args.N, "degree": args.degree, "periods": args.periods,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "runs": runs, "ratio": ratio, "max_ratio": MAX_RATIO,
           "max_err": MAX_ERR, "pass": ok}
    for name, r in runs.items():
        print(f"{name} ({r['impl']}): L2(u) {r['err']:.6e} after "
              f"{r['steps']} steps")
    print(f"ratio {ratio:.4f} (bar {MAX_RATIO}); "
          f"{'PASS' if ok else 'FAIL'}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
