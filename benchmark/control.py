"""The control of ``correct``: the reference in the program's place,
computed in TF32 (the nearest precision below the float32 with TF32 off
that the configurations state), judged by the same check as a run.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        --seconds 25

For each seed a run's set-up, warm-up and window go as in a run; then the
control, in the program's place, computes the two chunks the check
follows — the first from the zero state and the window's last from the
state the program handed to it — and the check judges the control's
chunks and the program's against one reference run.  Prints one JSON line
a seed with both sets of numbers beside the cell's limits: a sound set of
limits passes the program and fails the control on at least one number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

from .check import Reference, gaps, verdict
from .harness import drive
from .layout import Layout


def control(name: str, seed: int, seconds: float, layout: Layout,
            device="cuda") -> dict:
    dev = torch.device(device)
    rec, inp, cell, traffic = drive(name, seed, seconds, False, layout,
                                    dev, time.time())
    chunks = rec.pop("chunks_kept")
    ctrl = Reference(inp, traffic["scheme"], dev, tf32=True)
    judge = Reference(inp, traffic["scheme"], dev)
    numbers, program = {}, {}
    for label in ("start", "last"):
        st_in, st_out, seis, k, step0 = chunks[label]
        ref_out = judge.run(st_in.u, st_in.s, k, step0)
        u, s, samples = ctrl.run(st_in.u, st_in.s, k, step0)
        numbers.update(gaps(label, ref_out, SimpleNamespace(u=u, s=s),
                            samples[:, :, 0].cpu().numpy()))
        program.update(gaps(label, ref_out, st_out, seis))
    limits = cell.get("limits", {})
    ok, _, checks = verdict(numbers, limits)
    prog_ok, _, prog_checks = verdict(program, limits)
    return {"workload": name, "seed": seed, "last_step": chunks["last"][4],
            "passes": ok, "checks": checks, "program_passes": prog_ok,
            "program": prog_checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in (int(x) for x in a.seeds.split(",")):
        print(json.dumps(control(a.workload, seed, a.seconds, Layout())),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
