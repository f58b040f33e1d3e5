"""ptxas's register and local-memory report of two source trees, side by side.

    python -m seigen_tpu_torch.bench.ptxas_ab --trees parent=_archive/parent,change=.

Each tree is a checkout of the repository (``git archive <commit> | tar -x
-C _archive/parent`` puts an older one beside this one).  One process per
tree imports that tree's ``seigen_tpu_torch``, builds its five kernel
libraries (one nvcc each, all at once, into the tree's own build directory)
and prints one JSON line: for every kernel entry of every library, ptxas's
registers, stack frame, spill stores and spill loads.  The driver then
prints a line for every entry of either tree — both trees' values and
"moved", "new" or "gone" where they differ — and the counts.  It needs
nvcc, not a GPU.

    python <this file> --worker --root DIR     # one tree, one JSON line
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path


def report_entries(text: str) -> dict:
    """{mangled entry: [registers, stack frame, spill stores, spill loads]}
    of the lines of one ptxas report."""
    out, name, frame = {}, None, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            frame = [int(g) for g in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None and frame is not None:
            out[name] = [int(m.group(1)), *frame]
            name = None
    return out


def entry_key(entry: str) -> str:
    """A mangled entry without its anonymous namespace, whose name carries
    a hash of the source file and so differs between trees."""
    return re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", entry)


def worker(root: str) -> dict:
    """Build the libraries of the tree at ``root``; its ptxas entries."""
    root = str(Path(root).resolve())
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [root] + [p for p in sys.path if p != here]
    import seigen_tpu_torch
    from seigen_tpu_torch.ops import lane_kernels, lane_upwind_kernels, \
        merged_kernels, upwind_kernels
    from seigen_tpu_torch.ops.cuda_build import build_all
    from seigen_tpu_torch.solver import lane_fused

    if not str(Path(seigen_tpu_torch.__file__).resolve()).startswith(root):
        raise RuntimeError(f"imported {seigen_tpu_torch.__file__}, not the "
                           f"tree at {root}")
    libs = {"merged": merged_kernels.LIBRARY, "upwind": upwind_kernels.LIBRARY,
            "lane": lane_kernels.LIBRARY,
            "lane_upwind": lane_upwind_kernels.LIBRARY,
            "exchange": lane_fused.EXCHANGE_LIBRARY}
    build_all(list(libs.values()))
    return {"root": root,
            "entries": {f"{name}:{entry_key(entry)}": v
                        for name, lib in libs.items()
                        for entry, v in report_entries(
                            lib.ptxas_report()).items()}}


def drive(trees) -> dict:
    """Run one worker per tree and print the table; returns the counts."""
    (la, ra), (lb, rb) = trees
    recs = {}
    for label, root in trees:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               "--root", root]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"worker {label} ({root}) failed:\n"
                               f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        recs[label] = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = recs[la]["entries"], recs[lb]["entries"]
    counts = {"same": 0, "moved": 0, "new": 0, "gone": 0}
    print(f"entry: {la} / {lb} (registers, stack B, spill stores B, "
          f"spill loads B)")
    for key in sorted(set(a) | set(b)):
        va, vb = a.get(key), b.get(key)
        what = ("new" if va is None else "gone" if vb is None
                else "same" if va == vb else "moved")
        counts[what] += 1
        print(f"{key}: {va} / {vb}" + ("" if what == "same" else
                                       f"  {what.upper()}"))
    print("ptxas_ab " + json.dumps(counts))
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="parent=_archive/parent,change=.",
                    help="two label=root pairs")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--root", default=".")
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker(a.root)), flush=True)
        return 0
    trees = [tuple(t.split("=", 1)) for t in a.trees.split(",")]
    if len(trees) != 2:
        raise SystemExit("--trees takes two label=root pairs")
    drive(trees)
    return 0


if __name__ == "__main__":
    sys.exit(main())
