"""K1 merged_vel and K2 merged_stress of two source trees, timed in turns.

    python -m seigen_tpu_torch.bench.merged_ab --trees parent=_archive/parent,change=.

Each tree is a checkout of the repository (``git archive <commit> | tar -x
-C _archive/parent`` puts an older one beside this one).  The trees run in
the turns parent, change, change, parent (the first tree named is the
"parent"), one process each: a process imports ``seigen_tpu_torch`` from its
tree, builds that tree's kernels and, on the bench case
(``throughput.setup_case``, n=24 P3 by default), times every variant of K1
and K2 that the LF4 main path launches on numpy-seeded operands in the
runner's layout — K1 plain, axpy, 1 and 2 source groups; K2 plain, axpy,
axpy + damping, 1 and 2 source groups, and with the bench's VTI stiffness
(general Hooke law) plain and axpy + damping — with CUDA events (mean over
``--reps`` launches after 3 warm-up launches); then it runs the throughput
bench (impl "merged", and with ``--vti``).  Each process prints one JSON
line; the driver prints a table of each variant's mean over the turns of
each tree, and the GPU's name and power limit.  Needs a CUDA device.

    python <this file> --worker --root DIR     # one tree, one JSON line
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

VARIANTS = (("vel", "plain"), ("vel", "axpy"), ("vel", "inject1"),
            ("vel", "inject2"), ("stress", "plain"), ("stress", "axpy"),
            ("stress", "axpy_damp"), ("stress", "inject1"),
            ("stress", "inject2"), ("stress_c", "plain"),
            ("stress_c", "axpy_damp"))


def worker(root: str, n: int, degree: int, reps: int, bench_steps: int):
    """Time the variants and run the benches of the tree at ``root``."""
    root = str(Path(root).resolve())
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [root] + [p for p in sys.path if p != here]
    import dataclasses

    import numpy as np
    import torch

    import seigen_tpu_torch
    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.ops import merged_kernels as mk

    if not torch.cuda.is_available():
        raise RuntimeError("merged_ab times a CUDA device; none is available")
    if not str(Path(seigen_tpu_torch.__file__).resolve()).startswith(root):
        raise RuntimeError(f"imported {seigen_tpu_torch.__file__}, not the "
                           f"tree at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    case = throughput.setup_case(n=n, degree=degree, device=dev)
    dm, p, src, damp, dt, _ = case
    runners = {v: throughput.make_runner("merged", dm, p, src, damp, dt,
                                         "kernel", vti=v)
               for v in (False, True)}
    r = runners[False]
    d, plan = r.d, r.plan
    rng = np.random.default_rng(24)

    def field(C):
        a = rng.standard_normal((C, d.npp, plan.Ls)).astype(np.float32)
        a[:, d.n_p:] = 0.0
        return torch.as_tensor(a.reshape(C * d.npp, plan.Ls), device=dev)

    x = {"vel": field(d.n_sig), "stress": field(d.dim),
         "trs": torch.as_tensor(rng.standard_normal(
             (plan.nf * plan.rtf, plan.Ls)).astype(np.float32), device=dev)}
    y = {"vel": [field(d.dim) for _ in range(4)],
         "stress": [field(d.n_sig) for _ in range(4)]}

    def call(op, variant):
        run = runners[op == "stress_c"]
        od = run.d
        base = "vel" if op == "vel" else "stress"
        pair = y[base]
        kw = {}
        if variant.startswith("axpy"):
            kw = dict(axpy=(pair[0], pair[1]), dt=float(dt),
                      c3=float(dt) ** 3 / 24.0)
        elif variant.startswith("inject"):
            kw = dict(inject=[(pair[2 + g], (0.7, -1.3)[g])
                              for g in range(int(variant[-1]))])
        if base == "vel":
            kern = mk.VEL_KERNEL
        else:
            if variant == "axpy":
                od = dataclasses.replace(od, damp=None)
            kw["damp"] = od.damp if variant == "axpy_damp" else None
            kern = mk.STRESS_KERNEL
        args = (run.plan, od, x[base], x["trs"], run.mask)
        return lambda: kern(*args, **kw)

    def time_ms(fn):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    times = {f"{op} {v}": time_ms(call(op, v)) for op, v in VARIANTS}
    bench = {}
    for vti in (False, True):
        rec = throughput.main(n=n, degree=degree, n_steps=bench_steps,
                              case=case, vti=vti)
        bench["merged --vti" if vti else "merged"] = rec["value"]
    name, limit = throughput.gpu_name_and_power_limit(0)
    return {"root": root, "gpu": name, "power_limit": limit,
            "n": n, "degree": degree, "reps": reps, "times_ms": times,
            "bench_dof_updates_per_s": bench}


def drive(trees, n, degree, reps, bench_steps):
    """Run the workers in turns A, B, B, A and print the table."""
    (la, ra), (lb, rb) = trees
    order = ((la, ra), (lb, rb), (lb, rb), (la, ra))
    recs = []
    for label, root in order:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               "--root", root, "--n", str(n), "--degree", str(degree),
               "--reps", str(reps), "--bench-steps", str(bench_steps)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"worker {label} ({root}) failed:\n"
                               f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["label"] = label
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    print(f"GPU: {recs[0]['gpu']}, {recs[0]['power_limit']}; n={n} P{degree}"
          f"; turns {', '.join(lb for lb, _ in order)}")

    def mean(label, get):
        vals = [get(r) for r in recs if r["label"] == label]
        return sum(vals) / len(vals), vals

    print(f"{'variant':<22s} {la + ' ms':>12s} {lb + ' ms':>12s} "
          f"{lb + '/' + la:>10s}   each turn")
    for op, v in VARIANTS:
        k = f"{op} {v}"
        ma, va = mean(la, lambda r: r["times_ms"][k])
        mb, vb = mean(lb, lambda r: r["times_ms"][k])
        print(f"{k:<22s} {ma:12.4f} {mb:12.4f} {mb / ma:10.3f}   "
              f"{' '.join(f'{t:.4f}' for t in va + vb)}")
    for k in recs[0]["bench_dof_updates_per_s"]:
        ma, va = mean(la, lambda r: r["bench_dof_updates_per_s"][k])
        mb, vb = mean(lb, lambda r: r["bench_dof_updates_per_s"][k])
        print(f"bench {k:<16s} {ma:12.4e} {mb:12.4e} {mb / ma:10.3f}   "
              f"{' '.join(f'{t:.4e}' for t in va + vb)}  DOF-updates/s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="parent=_archive/parent,change=.",
                    help="two label=root pairs; the first runs first and "
                    "last")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--root", default=".")
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--bench-steps", type=int, default=100)
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker(a.root, a.n, a.degree, a.reps,
                                a.bench_steps)), flush=True)
        return
    trees = [tuple(t.split("=", 1)) for t in a.trees.split(",")]
    if len(trees) != 2:
        raise SystemExit("--trees takes two label=root pairs")
    drive(trees, a.n, a.degree, a.reps, a.bench_steps)


if __name__ == "__main__":
    main()
