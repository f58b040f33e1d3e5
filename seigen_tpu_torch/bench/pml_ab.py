"""C-PML cost A/B on one GPU: the einsum and the lane C-PML step against
the production sponge step on the same mesh.

Port of ``scripts/pml_ab.py``.  Rows, each the best of 3 CUDA-event timings
of a ``steps``-step run after a warm-up run, in ms a step:

  pml_ms            the einsum C-PML RK4 step (solver/pml.py)
  pml_zero_ms       the same step with zero profiles (the psi machinery
                    still runs: pml_ms - pml_zero_ms prices the profiles)
  merged_sponge_ms  MergedLaneRunner LF4 with a Cerjan sponge of the same
                    width on the same sides (K1/K2)
  lane_pml_ms       CpmlLaneRunner's RK4 step (K1/K2 on direction-masked
                    geometry, 8*dim launches a step)

and for the lane C-PML its DOF-updates/s (E*n_p*(dim+n_sig) per step over
the step's wall), its K1/K2 ms a step (one right-hand side's dim masked K1
and dim K2 launches timed back to back at these shapes, times the 4
stages) and the rest of the step (glue: trace seeding, memory-field
updates, RK4 combinations).  The case: unit square/cube, free top, C-PML
(or sponge) of ``--width`` on the other sides, random float32 fields of
1e-3 from default_rng(3); ``--dim 3 --n 24`` is the bench case's mesh
(bench/throughput.py setup_case, E = 82 944 P3).

    python -m seigen_tpu_torch.bench.pml_ab              # 2D n=64 P3
    python -m seigen_tpu_torch.bench.pml_ab --dim 3 --n 24

prints one JSON line with the GPU's name and power limit, and needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..mesh import build_discrete, rect_mesh
from ..ops import build_params, n_sig_for
from ..ops.structured_exchange import detect_structured
from ..solver.damping import absorbing_bc_fn, sponge_mask
from ..solver.lane_cpml import CpmlLaneRunner
from ..solver.lane_merged import MergedLaneRunner
from ..solver.pml import cpml_init, cpml_profiles, make_cpml_rhs, run_cpml
from ..solver.timestep import State, cfl_dt
from .p1_pack_probe import events_ms
from .throughput import BENCH_MAT, gpu_name_and_power_limit, setup_case

F0 = 9.05  # the profiles' alpha frequency (scripts/pml_ab.py)
VP = 2.0  # BENCH_MAT's P-wave speed


def sides_for(dim: int):
    """The absorbing sides: all but the free top."""
    return [(ax, s) for ax in range(dim) for s in ("lo", "hi")][:-1]


def setup(dim: int, n: int, degree: int, device):
    """(dm, p, dt) of the A/B's case: unit square or cube, free top,
    absorbing elsewhere, BENCH_MAT, float32."""
    if dim == 3:
        dm, p, *_ = setup_case(n=n, degree=degree, device=device)
    else:
        dm = build_discrete(rect_mesh(n, n), degree, bc_fn=absorbing_bc_fn(
            ((0.0, 1.0),) * 2, free_sides=[(1, "hi")]))
        p = build_params(dm, BENCH_MAT, dtype=torch.float32, device=device)
    return dm, p, cfl_dt(float(dm.h.min()), VP, degree, 0.4)


def main(dim: int = 2, n: int = 64, degree: int = 3, n_steps: int = 50,
         width: float = 0.15, device: str = "cuda", case=None) -> dict:
    """Measure the rows (module docstring); returns the JSON record.
    ``case``: a ``setup`` result to reuse."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the C-PML A/B measures a CUDA device; none is "
                           "available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dm, p, dt = case or setup(dim, n, degree, device)
    E, n_p, n_sig = dm.num_elements, dm.re.n_p, n_sig_for(dim)
    sides = sides_for(dim)
    rng = np.random.default_rng(3)
    st0 = State(*(torch.as_tensor(1e-3 * rng.standard_normal((E, n_p, c)),
                                  device=device).float()
                  for c in (dim, n_sig)))
    rows = {}

    def per_step(run_n):  # ms a step of an n_steps run
        return events_ms(lambda: run_n(n_steps), 1) / n_steps

    # the einsum C-PML RK4, with the profiles and with zero profiles
    dprof, aprof = cpml_profiles(dm, sides, width, VP, f0=F0)
    cst = cpml_init(p, st0.u, st0.s)
    for key, (d_, a_) in (("pml_ms", (dprof, aprof)),
                          ("pml_zero_ms", (0 * dprof, 0 * aprof))):
        rhs = make_cpml_rhs(p, d_, a_)
        rows[key] = per_step(lambda n: run_cpml(p, cst, dt, n, rhs))

    # the production sponge step on the same mesh
    ex = detect_structured(dm)
    damp = torch.as_tensor(sponge_mask(dm, sides, width=width),
                           device=device).float()
    rs = MergedLaneRunner(p, ex, dt, damp=damp, impl="kernel")
    ulm, slm = rs.to_lm_state(st0)
    rows["merged_sponge_ms"] = per_step(lambda n: rs.run_lm(ulm, slm, n))
    del rs, ulm, slm

    # the lane C-PML: its step, and its K1/K2 launches alone
    lr = CpmlLaneRunner(p, dm, ex, dt, sides, width, VP, f0=F0,
                        impl="kernel")
    carry = lr.init_carry(st0)
    rows["lane_pml_ms"] = per_step(lambda n: lr.run_lm(carry, n))
    rows["lane_pml_dof_per_s"] = \
        E * n_p * (dim + n_sig) / (rows["lane_pml_ms"] * 1e-3)
    u, s = carry[0], carry[1]
    tr = lr.traction_traces(s)  # a trace array of the kernels' shape

    def rhs_launches():  # one right-hand side's dim K1 + dim K2
        for dk in lr._d_dir:
            lr._vel_op(lr.plan, dk, s, tr, lr.mask)
            lr._stress_op(lr.plan, dk, u, tr, lr.mask)

    rows["lane_pml_kernel_ms"] = 4 * events_ms(rhs_launches, n_steps)
    rows["lane_pml_glue_ms"] = (rows["lane_pml_ms"]
                                - rows["lane_pml_kernel_ms"])

    name, limit = gpu_name_and_power_limit(torch.device(device).index or 0)
    return {"E": E, "dim": dim, "n": n, "degree": degree, "steps": n_steps,
            "width": width, "gpu": name, "power_limit": limit, **rows}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--width", type=float, default=0.15)
    a = ap.parse_args()
    print(json.dumps(main(dim=a.dim, n=a.n, degree=a.degree,
                          n_steps=a.steps, width=a.width)))
