"""Parameter sweep of the throughput bench over degree and mesh size.

Port of ``seigen_tpu/bench/sweep.py``: for each (degree, n) it builds the
bench's 3D case (``throughput.setup_case``) and measures one lane runner
(``throughput.measure``), timing the regions ``setup`` and ``run`` with a
RegionTimer, and prints one JSON row with the card's name as
``"backend"``.  ``impl="auto"`` picks the runner from the case — the
scrambled (unstructured) case: ``lane_u``; LF4: ``merged``; LF2: ``lane``
— and a runner that fails raises: no other impl is tried in its place.

    python -m seigen_tpu_torch.bench.sweep --degrees 1,2,3 --sizes 8,16 \\
        --steps 20 --out results/torch_sweep.json

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..utils.profiling import RegionTimer
from .throughput import IMPLS, measure, setup_case


def auto_impl(order: int, scramble: bool) -> str:
    """The runner of ``impl="auto"`` for the case."""
    if scramble:
        return "lane_u"
    return "merged" if order == 4 else "lane"


def run_sweep(degrees, sizes, n_steps=20, order=4, dtype_name="float32",
              out_path=None, impl="auto", scramble=False, vti=False,
              device="cuda"):
    """Measure ``impl`` at every (degree, n); returns the rows (and writes
    them as a JSON list to ``out_path``)."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the sweep measures a CUDA device; none is "
                           "available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    impl_used = auto_impl(order, scramble) if impl == "auto" else impl
    if impl_used not in IMPLS:
        raise ValueError(f"impl must be 'auto' or one of {IMPLS}, "
                         f"not {impl!r}")
    dtype = getattr(torch, dtype_name)
    backend = torch.cuda.get_device_name(torch.device(device))
    rows = []
    for degree in degrees:
        for n in sizes:
            timer = RegionTimer()
            with timer.region("setup"):
                dm, p, src, damp, dt, state0 = setup_case(
                    n=n, degree=degree, dtype=dtype, device=device,
                    scramble=scramble)
            with timer.region("run", sync=state0.u):
                res = measure(p, src, damp, dt, state0, dm, n_steps=n_steps,
                              impl=impl_used, order=order, vti=vti)
            row = {
                "dim": 3,
                "degree": degree,
                "n": n,
                "elements": res.n_elements,
                "dof": res.n_dof,
                "steps": res.n_steps,
                "seconds": res.seconds,
                "steps_per_sec": res.steps_per_sec,
                "dof_updates_per_sec": res.dof_updates_per_sec,
                "timings": timer.report(),
                "backend": backend,
                "dtype": dtype_name,
                "impl": impl_used,
                "order": order,
                "scramble": scramble,
                "vti": vti,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--degrees", type=str, default="1,2,3")
    ap.add_argument("--sizes", type=str, default="8,16")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--order", type=int, default=4, choices=(2, 4))
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--impl", type=str, default="auto",
                    choices=("auto",) + IMPLS)
    ap.add_argument("--scramble", action="store_true",
                    help="permute the cells and drop the structure (the "
                         "stand-in for an unstructured import)")
    ap.add_argument("--vti", action="store_true",
                    help="a per-element VTI stiffness through the runner's "
                         "general Hooke law")
    a = ap.parse_args(argv)
    run_sweep([int(d) for d in a.degrees.split(",")],
              [int(s) for s in a.sizes.split(",")], a.steps, a.order,
              a.dtype, a.out, impl=a.impl, scramble=a.scramble, vti=a.vti)
    return 0


if __name__ == "__main__":
    sys.exit(main())
