"""Curvilinear cost A/B on one GPU: the isoparametric LF4 step against the
affine einsum LF4 step and the merged lane runner on the same mesh.

Port of ``scripts/curvi_ab.py``.  The curvilinear operators are
per-element matrices (De, Lf vary per element), applied as batched
products over the element axis (ops/curvilinear.py): no shared operand for
a tile kernel, and the JAX package computes them outside any Pallas
kernel too.  Rows, each the best of 3 CUDA-event timings of a
``steps``-step run after a warm-up run, in ms a step:

  curvi_ms    LF4 with the curvilinear operators (timestep.run hooks)
  einsum_ms   LF4 with the affine einsum operators (ops/elastic.py)
  merged_ms   MergedLaneRunner LF4 (K1/K2) on the flat mesh

and the bound of the curvilinear step: its 6 operator applications'
batched-product FLOPs (De and Lf contractions) over the H100's 67 TFLOP/s
FP32 rate, and their per-element table reads (De, Lf, normals: re-read
every application, they dwarf the state) over its 3.35 TB/s, the larger of
the two.  The case: 96 x 48 P3 on the unit square, free top, absorbing
elsewhere, the top blended into a sinusoidal topography of amplitude
``--amp`` above z = 0.55 (the map of scripts/topography.py), random
float32 fields of 1e-3 from default_rng(3).

    python -m seigen_tpu_torch.bench.curvi_ab [--nx 96 --nz 48 --degree 3]

prints one JSON line with the GPU's name and power limit, and needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..mesh import build_discrete, rect_mesh
from ..ops import Material, build_params
from ..ops.curvilinear import build_curvi, curved_coords, make_curvi_ops
from ..ops.structured_exchange import detect_structured
from ..solver.damping import absorbing_bc_fn
from ..solver.lane_merged import MergedLaneRunner
from ..solver.timestep import State, cfl_dt, run
from .p1_pack_probe import events_ms
from .throughput import gpu_name_and_power_limit

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peaks
FP32_FLOPS_PER_S = 67e12


def topo_map(profile, z0: float, lz: float):
    """z-only diffeomorphism: identity for z <= z0, the full profile at
    z = lz, a smoothstep blend between."""
    def f(x):
        out = np.array(x, dtype=np.float64, copy=True)
        s = np.clip((x[:, 1] - z0) / (lz - z0), 0.0, 1.0)
        out[:, 1] = x[:, 1] + s * s * (3.0 - 2.0 * s) * profile(x[:, 0])
        return out

    return f


def main(nx: int = 96, nz: int = 48, degree: int = 3, n_steps: int = 50,
         amp: float = 0.06, device: str = "cuda") -> dict:
    """Measure the rows (module docstring); returns the JSON record."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the curvilinear A/B measures a CUDA device; "
                           "none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    mat = Material(rho=1.8, vp=2.5, vs=1.3)
    dm = build_discrete(
        rect_mesh(nx, nz), degree,
        bc_fn=absorbing_bc_fn(((0.0, 1.0), (0.0, 1.0)),
                              free_sides=[(1, "hi")]))
    X = curved_coords(dm, topo_map(
        lambda x: amp * np.sin(2 * np.pi * x), 0.55, 1.0))
    cp = build_curvi(dm, X, dtype=torch.float32, device=device)
    vop, sop = make_curvi_ops(cp)
    p = build_params(dm, mat, dtype=torch.float32, device=device)
    dt = cfl_dt(float(dm.h.min()), 2.5, degree, 0.3)
    E, n_p = dm.num_elements, dm.re.n_p
    rng = np.random.default_rng(3)
    st0 = State(*(torch.as_tensor(1e-3 * rng.standard_normal((E, n_p, c)),
                                  device=device).float() for c in (2, 3)))

    def per_step(run_n):  # ms a step of an n_steps run
        return events_ms(lambda: run_n(n_steps), 1) / n_steps

    rows = {
        "curvi_ms": per_step(lambda n: run(p, st0, dt, n, vel_op=vop,
                                           stress_op=sop)),
        "einsum_ms": per_step(lambda n: run(p, st0, dt, n)),
    }
    r = MergedLaneRunner(p, detect_structured(dm), dt, impl="kernel")
    ulm, slm = r.to_lm_state(st0)
    rows["merged_ms"] = per_step(lambda n: r.run_lm(ulm, slm, n))

    # bound of the curvilinear LF4 step: 6 operator applications, each
    # dominated by the De (E, dim, n_p, n_p) and Lf (E, nf, n_p, nfq)
    # contractions (vel and stress averaged) and their table reads
    dim, nf, n_sig, nfq = 2, 3, 3, cp.nfq
    flops = 6 * 2 * E * (dim * n_p * n_p + nf * n_p * nfq) * (n_sig + dim) / 2
    table_bytes = 6 * 4 * E * (dim * n_p * n_p + nf * n_p * nfq
                               + nf * nfq * dim)
    rows["bound_fp32_ms"] = flops / FP32_FLOPS_PER_S * 1e3
    rows["bound_hbm_ms"] = table_bytes / HBM_BYTES_PER_S * 1e3
    rows["bound_ms"] = max(rows["bound_fp32_ms"], rows["bound_hbm_ms"])
    rows["bound_by"] = ("bytes" if rows["bound_hbm_ms"]
                        >= rows["bound_fp32_ms"] else "operations")
    name, limit = gpu_name_and_power_limit(torch.device(device).index or 0)
    return {"E": E, "nx": nx, "nz": nz, "degree": degree, "steps": n_steps,
            "gpu": name, "power_limit": limit, **rows}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--nz", type=int, default=48)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--amp", type=float, default=0.06)
    a = ap.parse_args()
    print(json.dumps(main(nx=a.nx, nz=a.nz, degree=a.degree,
                          n_steps=a.steps, amp=a.amp)))
