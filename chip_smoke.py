#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (seigen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device   - require a CUDA device; print nvidia-smi's name and power limit.
2. build    - compile every kernel library from seigen_tpu_torch/csrc with
              nvcc, one nvcc per source, all at once: merged_kernels.cu
              (K1 merged_vel, K2 merged_stress and their v2 instantiations
              K8 fused_vel2, K9 fused_stress2), upwind_kernels.cu (K3
              upwind_rhs), lane_kernels.cu (K4 lane_vel, K5 lane_stress),
              lane_upwind_kernels.cu (K6 lane_upwind_rhs, K7
              lane_upwind_axpy) and trace_exchange.cu (K10
              trace_exchange); print ptxas's registers, stack and spills.
3. kernels  - every K1/K2 variant (vel plain/axpy/inject with 1 and 2
              groups; stress plain/axpy+damp/inject with 1 and 2 groups)
              against its plain PyTorch version on the card in float32, on
              box_mesh(4, 4, 4) at P3 and P2.
4. runner   - the LF4 main path: MergedLaneRunner on the n=24 P3 explosive-
              source case (E = 82 944) for 10 steps from a numpy-seeded
              random state, kernels vs plain versions; launch counts,
              finiteness; then every variant again at these shapes, with
              each kernel's time beside its plain version's.
5. bench    - seigen_tpu_torch.bench.throughput.main (100 steps, impl
              "merged") with the kernels and with the plain versions.
6. upwind   - the upwind-RK4 lane path.  Every K3 variant (plain, 1 and 2
              source groups, an acoustic vs = 0 half) against
              upwind_rhs_merged_ref on box_mesh(4, 4, 4) at P3 and P2;
              UpwindLaneRunner on the n=24 P3 case for 10 steps, kernel vs
              plain, elastic (blob source on the dense-group path, sponge)
              and viscoelastic (Q = 30/20, L = 3, scatter-source path):
              relative L2, launch counts (4 per step), finiteness; K3's
              variants and times at these shapes; the bench (impl
              "upwind_lane", 100 steps) with the kernel and the plain
              version; the upwind eigenmode on periodic box_mesh(N, N, N),
              N = 4 and 8, P2, float64 through the einsum run_rk4 (the
              merged plan refuses periodic meshes): L2(u) per N and the
              observed order, which must exceed 2.8.
7. lane     - the v1 lane-major LF engine.  Every K4 mode (SIG, TRAC, SEL)
              and K5 mode (TR, SEL) against its plain version: SIG/TR on
              box_mesh(4, 4, 4), TRAC/SEL on its scrambled copy, at P3 and
              P2, and all five on rect_mesh(8, 8) P2; LaneMajorRunner on
              the n=24 P3 case, LF2, and UnstructuredLaneRunner on its
              scrambled copy, LF4, with fused_select True and False, each
              for 10 steps kernel vs plain (relative L2, launch counts of
              1 K4 + 1 K5 per LF2 step and 3 + 3 per LF4 step,
              finiteness); each mode's time beside its plain version's
              and its bound at n=24 P3; the bench (impl "lane" at LF2 and
              "lane_u" at LF4, 100 steps) with the kernels and the plain
              versions; the LF4 eigenmode through the kernels on periodic
              box_mesh(N, N, N), N = 4 and 8, P2, float32: L2(u) per N
              and the observed order, which must exceed 2.8.
8. upwind_u - the unstructured upwind-RK4 path.  K6 and every K7 mode
              (stage, final, final + sponge row, 1 and 2 dense source
              groups, panel emission in stage and final mode) against the
              plain versions on scrambled box_mesh(4, 4, 4) at P3 and P2,
              on scrambled rect_mesh(8, 8) P2 (where the gathered and the
              emitted panel layouts differ: ftp 9, ftpp 16) and on an
              acoustic vs = 0 half; UnstructuredUpwindRunner on the
              scrambled n=24 P3 case for 10 steps, kernel vs plain, with
              the default (fused-epilogue) stepper, panel_emit=True,
              fused_axpy=False and viscoelastic Q = 30/20: relative L2,
              launch counts (4 K7 and no K6 a step on the fused steppers,
              4 K6 and no K7 on the glue and viscoelastic ones),
              finiteness; every mode's time beside its plain version's
              and its bound at these shapes; the bench (impl
              "upwind_lane_u", 100 steps) with panel_emit, with
              fused_axpy=False, with the default stepper and with the
              plain versions.
9. aniso    - the anisotropic (Voigt stiffness) path: the general Hooke
              law of K2 and K5 (their ANISO instantiations, counted by
              ``launches_c``).  With a per-element NON-symmetric random C:
              K2 plain / axpy / axpy + damp / 1 and 2 source groups on
              box_mesh(4, 4, 4) at P3 and P2 and rect_mesh(8, 8) P2, K5
              modes TR and SEL on the same meshes and their scrambled
              copies, each against its plain version.  With the bench's VTI
              stiffness at n=24 P3: MergedLaneRunner, LaneMajorRunner (LF4)
              and UnstructuredLaneRunner (scrambled case, fused_select True
              and False) for 10 steps kernel vs plain (relative L2,
              finiteness; 3 general-law stress launches a step and no
              isotropic one); each mode's time beside its plain version's
              and its bound; the ``vti`` benches (merged, lane LF4 beside
              its isotropic twin, lane_u).  An SH plane wave on periodic
              box_mesh(8, 2, 2) P3 in a VTI medium (gamma = 0.3) through
              LaneMajorRunner(stiffness=) in float32: back in phase after
              the period of sqrt(C66/rho) (error < 0.02) and not after the
              isotropic one.  The ElasticSimulation facade on the card
              (rect_mesh(8, 8) P2, source, receivers): impl "auto" runs the
              lane kernels, ``stiffness=`` the einsum path.  Phases 4-8
              must launch no general-law kernel.
10. fused   - the v2 exchange-fused LF4 engine.  K8 (plain, axpy) and K9
              (plain, axpy + sponge, and both with a per-element
              NON-symmetric C) against their plain versions, K10 (traction
              and velocity traces) against the plain gather, on
              box_mesh(4, 4, 4) at P3 and P2 and rect_mesh(8, 8) P2; K10
              also on their periodic twins.  FusedLaneRunner on the n=24
              P3 case for 10 steps: kernel vs plain and vs phase 4's kernel
              MergedLaneRunner (relative L2, finiteness), exactly 3 K8 + 3
              K9 + 6 K10 launches a step and no K1/K2; the same with the
              bench's VTI stiffness (3 general-law K9 a step, no isotropic
              one).  K8, K9, K9-C and K10 times beside their plain versions
              and bounds, and for K10 one torch.take over the plain
              version's index (library_ms); the bench (impl "fused" with
              the kernels and the plain versions, and --vti); the LF4
              eigenmode through K8/K9/K10 on periodic box_mesh(N, N, N),
              N = 4 and 8, P2, float32: order > 2.8.  Phases 1-9 must
              launch no K8, K9 or K10.

Tolerance of a kernel against its plain version: |k - p| <= rtol*|p| +
atol*max|p| with rtol = 2e-4, atol = 2e-5.  The absolute floor is taken
relative to the output's largest magnitude because float32 rounding of
the ~1e3-1e4-sized operator terms leaves absolute errors of ~1e-4 in
outputs that happen to be near zero, for the plain version as much as for
the kernel.

Each kernel's bound is the larger of its compulsory bytes (inputs read
once, outputs written once, from the main path's shapes) over the H100's
published 3.35 TB/s and its matrix-product FLOPs over the published 67
TFLOP/s FP32 rate.  K10 does no arithmetic: its library yardstick is the
gather alone (torch.take over the plain version's precomputed index, no
sign), the one PyTorch call that moves the same bytes.

Output: the JSON lines of the bench phases, then the nvidia-smi line, one
JSON line describing the kernels, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

RTOL, ATOL = 2e-4, 2e-5
RUNNER_STEPS = 10
BENCH_STEPS = 100
TIMING_REPS = 20
EIGEN_MIN_ORDER = 2.8
SH_WAVE_MAX_ERR = 0.02
SIDES = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peaks
FP32_FLOPS_PER_S = 67e12
KERNELS = {  # name -> (source, replaced TPU kernel)
    "merged_vel": ("seigen_tpu_torch/csrc/merged_kernels.cu",
                   "seigen_tpu/ops/merged_kernels.py:542"),
    "merged_stress": ("seigen_tpu_torch/csrc/merged_kernels.cu",
                      "seigen_tpu/ops/merged_kernels.py:582"),
    "upwind_rhs": ("seigen_tpu_torch/csrc/upwind_kernels.cu",
                   "seigen_tpu/ops/upwind_kernels.py:231"),
    "lane_vel": ("seigen_tpu_torch/csrc/lane_kernels.cu",
                 "seigen_tpu/ops/pallas_kernels.py:942"),
    "lane_stress": ("seigen_tpu_torch/csrc/lane_kernels.cu",
                    "seigen_tpu/ops/pallas_kernels.py:982"),
    "lane_upwind_rhs": ("seigen_tpu_torch/csrc/lane_upwind_kernels.cu",
                        "seigen_tpu/ops/pallas_kernels.py:848"),
    "lane_upwind_axpy": ("seigen_tpu_torch/csrc/lane_upwind_kernels.cu",
                         "seigen_tpu/ops/pallas_kernels.py:791"),
    "fused_vel2": ("seigen_tpu_torch/csrc/merged_kernels.cu",
                   "seigen_tpu/ops/fused_kernels.py:718"),
    "fused_stress2": ("seigen_tpu_torch/csrc/merged_kernels.cu",
                      "seigen_tpu/ops/fused_kernels.py:759"),
    "trace_exchange": ("seigen_tpu_torch/csrc/trace_exchange.cu",
                       "seigen_tpu/solver/lane_fused.py:247"),
}
ANISO_MODES = {  # general-Hooke-law mode -> (kernel, replaced TPU kernel)
    "merged_stress[C]": ("merged_stress",
                         "seigen_tpu/ops/fused_kernels.py:546"),
    "lane_stress[C,TR]": ("lane_stress",
                          "seigen_tpu/ops/pallas_kernels.py:497"),
    "lane_stress[C,SEL]": ("lane_stress",
                           "seigen_tpu/ops/pallas_kernels.py:527"),
    "fused_stress2[C]": ("fused_stress2",
                         "seigen_tpu/ops/fused_kernels.py:546"),
}
# the launches_c counts
C_COUNTS = ("merged_stress_c", "lane_stress_c", "fused_stress2_c")


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()


class Check:
    """Kernel-vs-plain comparisons, worst case per kernel."""

    def __init__(self):
        self.worst = {}  # kernel name -> max abs err

    def __call__(self, kname, label, got, ref):
        import torch

        err = (got - ref).abs()
        scale = ref.abs().max().item()
        bound = RTOL * ref.abs() + ATOL * scale
        ratio = (err / bound.clamp_min(1e-30)).max().item()
        max_err = err.max().item()
        ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
        log(f"  {label:<34s} max_abs_err {max_err:.3e}  max|ref| "
            f"{scale:.3e}  err/tol {ratio:.3f}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: kernel disagrees with its plain "
                                 f"version (err/tol {ratio:.3f})")
        self.worst[kname] = max(self.worst.get(kname, 0.0), max_err)


def make_case(n, degree, device):
    """A free-top, sponge-damped box case and its kernel runner."""
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask
    from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner

    ext = ((0.0, 1.0),) * 3
    dm = build_discrete(box_mesh(n, n, n), degree,
                        bc_fn=absorbing_bc_fn(ext, free_sides=[(2, "hi")]))
    p = build_params(dm, Material(1.0, 2.0, 1.0), dtype=torch.float32,
                     device=device)
    damp = torch.as_tensor(sponge_mask(dm, SIDES, width=0.3), device=device)
    return MergedLaneRunner(p, detect_structured(dm), 0.01,
                            damp=damp.float(), impl="kernel")


def variant_inputs(runner, seed):
    """numpy-seeded float32 operands in the runner's lane layout."""
    import numpy as np
    import torch

    d, plan = runner.d, runner.plan
    rng = np.random.default_rng(seed)

    def field(C, used, rows):
        a = rng.standard_normal((C, rows, plan.Ls)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * rows, plan.Ls),
                               device=runner.device)

    return {
        "sig": [field(d.n_sig, d.n_p, d.npp) for _ in range(3)],
        "u": [field(d.dim, d.n_p, d.npp) for _ in range(3)],
        "trs": field(d.nf, d.dim * d.n_fp, plan.rtf),
        "Su": [field(d.dim, d.n_p, d.npp) for _ in range(2)],
        "Ss": [field(d.n_sig, d.n_p, d.npp) for _ in range(2)],
    }


VARIANTS = (("vel", "plain"), ("vel", "axpy"), ("vel", "inject1"),
            ("vel", "inject2"), ("stress", "plain"), ("stress", "axpy_damp"),
            ("stress", "inject1"), ("stress", "inject2"))


def variant_call(runner, x, op, variant):
    """(kernel fn, plain fn, args, kwargs) of one operator variant."""
    from seigen_tpu_torch.ops import merged_kernels as mk

    d = runner.d
    if variant == "axpy" and op == "stress":  # the update without a sponge
        d = dataclasses.replace(d, damp=None)
    field = x["sig"][0] if op == "vel" else x["u"][0]
    pair = x["u"] if op == "vel" else x["sig"]
    S = x["Su"] if op == "vel" else x["Ss"]
    kw = {}
    if variant.startswith("axpy"):
        dt = float(runner.dt)
        kw = dict(axpy=(pair[1], pair[2]), dt=dt, c3=dt**3 / 24.0)
    elif variant.startswith("inject"):
        kw = dict(inject=[(S[g], (0.7, -1.3)[g])
                          for g in range(int(variant[-1]))])
    if op == "vel":
        kern = mk.VEL_KERNEL
        plain = mk.vel_merged_ref
    else:
        damp = d.damp if variant == "axpy_damp" else None
        kern = (lambda *a, **k: mk.STRESS_KERNEL(*a, damp=damp, **k))
        plain = mk.stress_merged_ref
    args = (runner.plan, d, field, x["trs"], runner.mask)
    return kern, plain, args, kw


def compare_variants(runner, check, tag, seed):
    import torch

    x = variant_inputs(runner, seed)
    for op, variant in VARIANTS:
        kern, plain, args, kw = variant_call(runner, x, op, variant)
        got = kern(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        kname = "merged_vel" if op == "vel" else "merged_stress"
        check(kname, f"{tag} {op} {variant} out", got[0], ref[0])
        check(kname, f"{tag} {op} {variant} traces", got[1], ref[1])
    return x


def time_ms(fn, reps=TIMING_REPS):
    import torch

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


def bound(d, plan, kname, aniso=False):
    """(bound_ms, "bytes" | "operations") of one plain launch of a kernel
    at these shapes: compulsory bytes (state rows n_p per component, the
    neighbour payload rows, the geo/impedance/mask rows the operator reads;
    the full output and trace arrays written) over the memory rate, and
    the Dr and LIFT matrix-product FLOPs over the FP32 rate.  aniso: K2
    reads the n_sig^2 stiffness rows instead of lambda and mu."""
    dim, n_p, nf, nfp, npp = d.dim, d.n_p, d.nf, d.n_fp, d.npp
    nft = nf * nfp
    geo = dim * dim + dim * nf  # Ginv, normals
    if kname == "merged_vel":  # sigma in, u out; scb, bfs, 1/rho
        c_in, c_out, geo = d.n_sig, dim, geo + 2 * nf + 1
    elif kname == "merged_stress":  # u in, sigma out; scb, dfs, lam, mu
        c_in, c_out = dim, d.n_sig
        geo += 2 * nf + (d.n_sig * d.n_sig if aniso else 2)
    else:  # u, sigma in and out; scb, 1/rho, lam, mu; 4*nf + 2 uwg rows
        c_in = c_out = dim + d.n_sig
        geo += nf + 3 + 4 * nf + 2
    rows = c_in * n_p + plan.pay * nft + geo + nf + c_out * npp \
        + nf * plan.rtf
    flops = 2 * (c_out * dim * n_p * n_p + c_out * n_p * nft)
    t_bytes = 4.0 * rows * plan.Ls / HBM_BYTES_PER_S * 1e3
    t_ops = float(flops) * plan.Ls / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def small_upwind_runner(degree, device, acoustic):
    """K3 runner on a free-top box_mesh(4, 4, 4): the bench material, or
    vs = 0 where x < 0.5 (the acoustic guard of the Riemann states)."""
    import numpy as np

    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.ops import Material, build_params, \
        build_upwind_data
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn
    from seigen_tpu_torch.solver.lane_upwind import UpwindLaneRunner

    ext = ((0.0, 1.0),) * 3
    dm = build_discrete(box_mesh(4, 4, 4), degree,
                        bc_fn=absorbing_bc_fn(ext, free_sides=[(2, "hi")]))
    vs = np.where(dm.coords.mean(axis=1)[:, 0] < 0.5, 0.0, 1.0) \
        if acoustic else 1.0
    mat = Material(1.0, 2.0, vs)
    return UpwindLaneRunner(
        build_params(dm, mat, device=device), detect_structured(dm),
        build_upwind_data(dm, mat, device=device), 0.01, impl="kernel")


def upwind_inputs(runner, seed):
    """numpy-seeded float32 K3 operands in the runner's lane layout."""
    import numpy as np
    import torch

    d, plan = runner.d, runner.plan
    rng = np.random.default_rng(seed)

    def field(C, used, rows):
        a = rng.standard_normal((C, rows, plan.Ls)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * rows, plan.Ls),
                               device=runner.device)

    return {"u": field(d.dim, d.n_p, d.npp),
            "s": field(d.n_sig, d.n_p, d.npp),
            "trs": field(d.nf, 2 * d.dim * d.n_fp, plan.rtf),
            "inj": [(field(d.dim, d.n_p, d.npp),
                     field(d.n_sig, d.n_p, d.npp), (0.7, -1.3)[g])
                    for g in range(2)]}


def upwind_args(runner, x):
    return (runner.plan, runner.d, runner.uwg, x["u"], x["s"], x["trs"],
            runner.mask)


def compare_upwind(runner, check, tag, seed, variants):
    """K3 variants ("plainN": N dense source groups) vs the plain version."""
    import torch

    from seigen_tpu_torch.ops import upwind_kernels as uk

    x = upwind_inputs(runner, seed)
    for variant in variants:
        inj = x["inj"][: int(variant[-1])]
        got = uk.UPWIND_KERNEL(*upwind_args(runner, x), inject=inj)
        ref = uk.upwind_rhs_merged_ref(*upwind_args(runner, x), inject=inj)
        torch.cuda.synchronize()
        for part, g, r in zip(("du", "ds", "traces"), got, ref):
            check("upwind_rhs", f"{tag} {variant} {part}", g, r)
    return x


def upwind_runner(case, impl, visco=False):
    """The bench's UpwindLaneRunner; visco: Q = 30/20, L = 3 over the band
    of scripts/explosive_source.py (0.25 f0 .. 2.5 f0)."""
    from seigen_tpu_torch.bench.throughput import make_runner
    from seigen_tpu_torch.ops import build_visco

    dm, p, src, damp, dt, _ = case
    f0 = src.f0[0].item()
    v = build_visco(p, 30.0, 20.0, 0.25 * f0, 2.5 * f0, L=3) if visco \
        else None
    return make_runner("upwind_lane", dm, p, src, damp, dt, impl, visco=v)


def all_kernels():
    """name -> kernel binding (each with its ``launches`` count)."""
    from seigen_tpu_torch.ops import fused_ops as fo
    from seigen_tpu_torch.ops import lane_kernels as lk
    from seigen_tpu_torch.ops import lane_upwind_kernels as luk
    from seigen_tpu_torch.ops import merged_kernels as mk
    from seigen_tpu_torch.ops import upwind_kernels as uk
    from seigen_tpu_torch.solver import lane_fused as lf

    return {"merged_vel": mk.VEL_KERNEL, "merged_stress": mk.STRESS_KERNEL,
            "upwind_rhs": uk.UPWIND_KERNEL, "lane_vel": lk.LANE_VEL,
            "lane_stress": lk.LANE_STRESS,
            "lane_upwind_rhs": luk.LANE_UPWIND_RHS,
            "lane_upwind_axpy": luk.LANE_UPWIND_AXPY,
            "fused_vel2": fo.VEL2_KERNEL, "fused_stress2": fo.STRESS2_KERNEL,
            "trace_exchange": lf.TRACE_EXCHANGE}


def reset_counts():
    for k in all_kernels().values():
        k.launches = 0
        if hasattr(k, "launches_c"):
            k.launches_c = 0


def read_counts():
    """Launches per kernel, and under C_COUNTS those of K2, K5 and K9 that
    ran the general Hooke law."""
    kernels = all_kernels()
    counts = {name: k.launches for name, k in kernels.items()}
    for name in C_COUNTS:
        counts[name] = kernels[name[:-2]].launches_c
    return counts


def expect_counts(tag, counts, **nonzero):
    """Fail unless the kernels (and general-law counts) of ``nonzero``
    launched exactly that often and every other one not at all."""
    expect = {name: nonzero.get(name, 0) for name in (*KERNELS, *C_COUNTS)}
    if counts != expect:
        raise AssertionError(f"{tag} launches {counts}, expected {expect}")


def compare_states(tag, out_k, out_r, what="kernel vs plain"):
    import torch

    for name in ("u", "s"):
        a, b = getattr(out_k, name), getattr(out_r, name)
        rel = ((a - b).norm() / b.norm()).item()
        finite = bool(torch.isfinite(a).all())
        nrm = a.norm().item()
        log(f"[{tag}] {name}: rel L2 {what} {rel:.3e}, norm "
            f"{nrm:.4e}, finite {finite}")
        if not (finite and nrm > 0 and rel < 1e-4):
            raise AssertionError(f"{tag} state {name} off: rel {rel}")


def eigenmode_order(dev):
    """Upwind RK4 on a travelling S wave over half a period, periodic
    box_mesh(N, N, N) P2, float64 on the card: (errors, order)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.ops import Material, build_params, \
        build_upwind_data
    from seigen_tpu_torch.solver import PlaneWave, State, cfl_dt, \
        interpolate, l2_error, run_rk4

    mat = Material(1.0, 2.0, 1.0)
    pw = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0, 0.0]),
                   mode="S", polarization=np.array([0.0, 0.0, 1.0]))
    T = 0.5 * pw.period
    errs = []
    for N in (4, 8):
        dm = build_discrete(box_mesh(N, N, N, periodic=(0, 1, 2)), 2)
        p = build_params(dm, mat, dtype=torch.float64, device=dev)
        w = build_upwind_data(dm, mat, dtype=torch.float64, device=dev)
        n = int(np.ceil(T / cfl_dt(dm.h.min(), 2.0, 2, 0.7)))
        st = State(*(torch.as_tensor(interpolate(dm, f, 0.0), device=dev)
                     for f in (pw.u, pw.sigma)))
        fin, _ = run_rk4(p, w, st, T / n, n)
        errs.append(l2_error(dm, fin.u, pw.u, T))
        log(f"[eigenmode] N={N} P2: E {dm.num_elements}, {n} steps, "
            f"L2(u) {errs[-1]:.6e}")
    return errs, math.log2(errs[0] / errs[1])


def phase_upwind(dev, case, st, check):
    """Phase 6 (see the module docstring); returns (K3 launches on the
    elastic main-path run, (kernel ms, plain ms), bound)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.ops import upwind_kernels as uk

    t0 = time.perf_counter()
    variants = ("plain0", "inject1", "inject2")
    for degree in (3, 2):
        small = small_upwind_runner(degree, dev, acoustic=False)
        log(f"[upwind] box_mesh(4,4,4) P{degree}: Ls {small.plan.Ls}, "
            f"rtf {small.plan.rtf}")
        compare_upwind(small, check, f"P{degree}", seed=10 + degree,
                       variants=variants)
        compare_upwind(small_upwind_runner(degree, dev, acoustic=True),
                       check, f"P{degree} acoustic", seed=20 + degree,
                       variants=("plain0",))
    log(f"[upwind] all small-mesh variants agree "
        f"({time.perf_counter() - t0:.1f} s)")

    for visco in (False, True):
        tag = "upwind visco" if visco else "upwind"
        t1 = time.perf_counter()
        up_k = upwind_runner(case, "kernel", visco)
        up_r = upwind_runner(case, "reference", visco)
        log(f"[{tag}] n=24 P3: pay {up_k.plan.pay}, rtf {up_k.plan.rtf}, "
            f"dense source groups "
            f"{0 if up_k.src_dense is None else len(up_k.src_dense)}; "
            f"setup {time.perf_counter() - t1:.1f} s")
        reset_counts()
        out_k, _ = up_k.run(st, RUNNER_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
        out_r, _ = up_r.run(st, RUNNER_STEPS)
        torch.cuda.synchronize()
        log(f"[{tag}] {RUNNER_STEPS} steps: launches {counts}")
        expect_counts(tag, counts, upwind_rhs=4 * RUNNER_STEPS)
        compare_states(tag, out_k, out_r)
        if not visco:
            launches = counts["upwind_rhs"]

    run_k = upwind_runner(case, "kernel")
    x = compare_upwind(run_k, check, "n=24 P3", seed=31, variants=variants)
    args = upwind_args(run_k, x)
    times = (time_ms(lambda: uk.UPWIND_KERNEL(*args)),
             time_ms(lambda: uk.upwind_rhs_merged_ref(*args)))
    bnd = bound(run_k.d, run_k.plan, "upwind_rhs")
    log(f"[upwind] upwind_rhs (plain) at n=24 P3: kernel {times[0]:.4f} "
        f"ms, plain {times[1]:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    del run_k, up_k, up_r

    for impl in ("kernel", "reference"):
        rec = throughput.main(n=24, degree=3, n_steps=BENCH_STEPS,
                              impl="upwind_lane", kernel_impl=impl,
                              case=case)
        if not (np.isfinite(rec["value"]) and rec["value"] > 0):
            raise AssertionError(f"upwind bench {impl}: bad rate "
                                 f"{rec['value']}")
        print(json.dumps(rec), flush=True)

    errs, order = eigenmode_order(dev)
    log(f"[eigenmode] observed order {order:.3f} (bar {EIGEN_MIN_ORDER})")
    if not (order > EIGEN_MIN_ORDER):
        raise AssertionError(f"upwind eigenmode order {order} <= "
                             f"{EIGEN_MIN_ORDER}: errors {errs}")
    return launches, times, bnd


LANE_MODES = {  # mode -> (kernel name, lane_kernels mode constant name)
    "SIG": ("lane_vel", "VEL_SIG"), "TRAC": ("lane_vel", "VEL_TRAC"),
    "SEL vel": ("lane_vel", "VEL_SEL"), "TR": ("lane_stress", "STRESS_TR"),
    "SEL stress": ("lane_stress", "STRESS_SEL")}


def small_lane_runners(dim, degree, dev):
    """(LaneMajorRunner, UnstructuredLaneRunner on a scrambled copy) kernel
    runners on a free-top box_mesh(4, 4, 4) (3D) or rect_mesh(8, 8) (2D)."""
    import dataclasses

    import numpy as np

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn
    from seigen_tpu_torch.solver.lane_major import LaneMajorRunner
    from seigen_tpu_torch.solver.lane_unstructured import \
        UnstructuredLaneRunner

    topo = box_mesh(4, 4, 4) if dim == 3 else rect_mesh(8, 8)
    bc = absorbing_bc_fn(((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")])
    mat = Material(1.0, 2.0, 1.0)
    dm = build_discrete(topo, degree, bc_fn=bc)
    lane = LaneMajorRunner(build_params(dm, mat, device=dev),
                           detect_structured(dm), 0.01, impl="kernel")
    perm = np.random.default_rng(0).permutation(topo.num_cells)
    dm = build_discrete(dataclasses.replace(
        topo, cells=topo.cells[perm], structure=None), degree, bc_fn=bc)
    lane_u = UnstructuredLaneRunner(build_params(dm, mat, device=dev), 0.01,
                                    centroids=dm.coords.mean(axis=1),
                                    impl="kernel")
    return lane, lane_u


def lane_inputs(runner, seed):
    """numpy-seeded float32 K4/K5 operands in the runner's lane layout."""
    import numpy as np
    import torch

    d = runner.d
    rng = np.random.default_rng(seed)

    def rows(C, used, pad):
        a = rng.standard_normal((C, pad, d.E)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * pad, d.E), device=runner.device)

    rows_pad = (d.dim * d.ftp + 7) // 8 * 8  # panel rows per face
    return {"sig": rows(d.n_sig, d.n_p, d.npp), "u": rows(d.dim, d.n_p, d.npp),
            "tr_sig": rows(d.n_sig, d.ftp, d.ftpp),
            "tr_u": rows(d.dim, d.ftp, d.ftpp),
            "panels": rows(d.nf, d.dim * d.ftp, rows_pad)}


def lane_call(runner, x, mode, cmat=None):
    """(kernel fn, plain fn) of one K4/K5 mode on the runner's data; cmat:
    the stiffness rows of the stress modes' general Hooke law."""
    from seigen_tpu_torch.ops import lane_kernels as lk

    d = runner.d
    kname, const = LANE_MODES[mode]
    kern = lk.LANE_VEL if kname == "lane_vel" else lk.LANE_STRESS
    m = getattr(lk, const)
    if mode == "SIG":
        args, plain = (x["sig"], x["tr_sig"]), lk.vel_op_lm_ref
    elif mode == "TRAC":
        args, plain = (x["sig"], x["tr_u"]), lk.vel_op_lm_trac_ref
    elif mode == "TR":
        return (lambda: kern(d, x["u"], x["tr_u"], m, cmat=cmat),
                lambda: lk.stress_op_lm_ref(d, x["u"], x["tr_u"], cmat=cmat))
    elif mode == "SEL vel":
        _, combo, sign, cfg = runner._pg_t
        return (lambda: kern(d, x["sig"], x["panels"], m, combo=combo,
                             sign=sign, selcfg=cfg),
                lambda: lk.vel_op_lm_trac_sel_ref(d, x["sig"], x["panels"],
                                                  combo, sign, cfg))
    else:
        _, combo, _, cfg = runner._pg_u
        return (lambda: kern(d, x["u"], x["panels"], m, combo=combo,
                             selcfg=cfg, cmat=cmat),
                lambda: lk.stress_op_lm_sel_ref(d, x["u"], x["panels"],
                                                combo, cfg, cmat=cmat))
    return (lambda: kern(d, *args, m)), (lambda: plain(d, *args))


def compare_lane(runner, check, tag, seed, modes):
    import torch

    x = lane_inputs(runner, seed)
    for mode in modes:
        kern, plain = lane_call(runner, x, mode)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        check(LANE_MODES[mode][0], f"{tag} {mode}", got, ref)
    return x


def lane_bound(d, mode, aniso=False):
    """(bound_ms, "bytes" | "operations") of one launch of a K4/K5 mode:
    compulsory bytes (state rows n_p per component, the neighbour payload
    rows the mode reads — for SEL the selected panel rows, the combo and
    the sign rows —, the geometry counted per face as in ``bound`` (Ginv,
    normals, Fscale, beta or delta; the kernel reads them expanded to face
    nodes) and the material rows, the output written at npp rows) over
    the memory rate, and the Dr and LIFT FLOPs over the FP32 rate.  aniso:
    a stress mode reads the n_sig^2 stiffness rows instead of lambda and
    mu."""
    dim, n_p, ftp, npp, n_sig = d.dim, d.n_p, d.ftp, d.npp, d.n_sig
    nf = d.nf
    vel = LANE_MODES[mode][0] == "lane_vel"
    c_in, c_out = (n_sig, dim) if vel else (dim, n_sig)
    payload = {"SIG": n_sig * ftp, "TRAC": dim * ftp, "TR": dim * ftp,
               "SEL vel": dim * ftp + 2 * nf,
               "SEL stress": dim * ftp + nf}[mode]
    geo = dim * dim + dim * nf + 2 * nf + (
        1 if vel else n_sig * n_sig if aniso else 2)
    rows = c_in * n_p + payload + geo + c_out * npp
    flops = 2 * (c_out * dim * n_p * n_p + c_out * n_p * ftp)
    t_bytes = 4.0 * rows * d.E / HBM_BYTES_PER_S * 1e3
    t_ops = float(flops) * d.E / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lane_eigenmode_order(dev, runner_cls=None, tag="lane eigenmode",
                         **per_step):
    """LF4 through K4/K5 (LaneMajorRunner; or through the kernels of
    ``runner_cls``, launched ``per_step`` times a step) on the travelling S
    wave of tests/test_eigenmode.py over half a period, periodic
    box_mesh(N, N, N) P2, float32 on the card: (errors, order)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver import PlaneWave, State, cfl_dt, \
        interpolate, l2_error
    from seigen_tpu_torch.solver.lane_major import LaneMajorRunner

    runner_cls = runner_cls or LaneMajorRunner
    per_step = per_step or dict(lane_vel=3, lane_stress=3)
    mat = Material(1.0, 2.0, 1.0)
    pw = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0, 0.0]),
                   mode="S", polarization=np.array([0.0, 0.0, 1.0]))
    T = 0.5 * pw.period
    errs = []
    for N in (4, 8):
        dm = build_discrete(box_mesh(N, N, N, periodic=(0, 1, 2)), 2)
        p = build_params(dm, mat, dtype=torch.float32, device=dev)
        n = max(int(np.ceil(T / cfl_dt(dm.h.min(), 2.0, 2, 0.4))), 1)
        dt = T / n
        st = State(*(torch.as_tensor(interpolate(dm, f, t), device=dev
                                     ).float()
                     for f, t in ((pw.u, 0.0), (pw.sigma, 0.5 * dt))))
        runner = runner_cls(p, detect_structured(dm), dt, order=4,
                            impl="kernel")
        reset_counts()
        fin, _ = runner.run(st, n)
        torch.cuda.synchronize()
        expect_counts(f"{tag} N={N}", read_counts(),
                      **{k: v * n for k, v in per_step.items()})
        errs.append(l2_error(dm, fin.u.cpu().numpy(), pw.u, n * dt))
        log(f"[{tag}] N={N} P2 LF4 float32: E {dm.num_elements}, "
            f"{n} steps, L2(u) {errs[-1]:.6e}")
    return errs, math.log2(errs[0] / errs[1])


def phase_lane(dev, case, st, check, n=24):
    """Phase 7 (see the module docstring); returns ({kernel: launches on
    the LF2 main-path run}, {kernel: (kernel ms, plain ms)} and {kernel:
    bound} of the main path's modes SIG and TR, and the scrambled case
    with its random state)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.solver.lane_unstructured import \
        UnstructuredLaneRunner
    from seigen_tpu_torch.solver.timestep import State

    t0 = time.perf_counter()
    for dim, degree in ((3, 3), (3, 2), (2, 2)):
        lane, lane_u = small_lane_runners(dim, degree, dev)
        tag = f"{dim}D P{degree}"
        log(f"[lane] {tag}: E {lane.E}; scrambled copy: "
            f"{len(lane_u._pg_u[3][7])} orientation groups")
        scrambled = (tuple(LANE_MODES) if dim == 2  # all five in 2D
                     else ("TRAC", "SEL vel", "SEL stress"))
        compare_lane(lane, check, f"{tag}", 30 + degree, ("SIG", "TR"))
        compare_lane(lane_u, check, f"{tag} scrambled", 40 + degree,
                     scrambled)
    log(f"[lane] all small-mesh modes agree "
        f"({time.perf_counter() - t0:.1f} s)")

    # LF2 main path: LaneMajorRunner on the bench case
    dm, p, src, damp, dt, _ = case
    lane_k, lane_r = (throughput.make_runner("lane", dm, p, src, damp, dt,
                                             impl, order=2)
                      for impl in ("kernel", "reference"))
    reset_counts()
    out_k, _ = lane_k.run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    main_counts = read_counts()
    out_r, _ = lane_r.run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    log(f"[lane LF2] n={n} P3, {RUNNER_STEPS} steps: launches {main_counts}")
    expect_counts("lane LF2", main_counts, lane_vel=RUNNER_STEPS,
                  lane_stress=RUNNER_STEPS)
    compare_states("lane LF2", out_k, out_r)
    del lane_r

    # LF4 on the scrambled case, both select paths
    t1 = time.perf_counter()
    scase = throughput.setup_case(n=n, degree=3, device=dev, scramble=True)
    sdm, sp, ssrc, sdamp, sdt, _ = scase
    E, n_p = sdm.num_elements, sdm.re.n_p
    rng = np.random.default_rng(8)
    sst = State(
        u=torch.as_tensor(rng.standard_normal((E, n_p, 3)), device=dev
                          ).float(),
        s=torch.as_tensor(rng.standard_normal((E, n_p, 6)), device=dev
                          ).float())
    log(f"[lane_u] scrambled n={n} P3 case: setup "
        f"{time.perf_counter() - t1:.1f} s")
    for fused in (True, False):
        tag = f"lane_u LF4 fused_select={fused}"
        t1 = time.perf_counter()
        k, r = (UnstructuredLaneRunner(
            sp, sdt, order=4, src=ssrc, damp=sdamp, impl=impl,
            centroids=sdm.coords.mean(axis=1), fused_select=fused)
            for impl in ("kernel", "reference"))
        log(f"[{tag}] runner setup {time.perf_counter() - t1:.1f} s")
        reset_counts()
        out_k, _ = k.run(sst, RUNNER_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
        out_r, _ = r.run(sst, RUNNER_STEPS)
        torch.cuda.synchronize()
        log(f"[{tag}] {RUNNER_STEPS} steps: launches {counts}")
        expect_counts(tag, counts, lane_vel=3 * RUNNER_STEPS,
                      lane_stress=3 * RUNNER_STEPS)
        compare_states(tag, out_k, out_r)
        if fused:
            lane_uk = k
        del r

    # every mode at n=24 P3: check, kernel and plain times, bound
    times, bounds = {}, {}
    for runner, modes, seed in ((lane_k, ("SIG", "TR"), 50),
                                (lane_uk, ("TRAC", "SEL vel", "SEL stress"),
                                 51)):
        x = compare_lane(runner, check, f"n={n} P3", seed, modes)
        for mode in modes:
            kern, plain = lane_call(runner, x, mode)
            t = (time_ms(kern), time_ms(plain))
            b = lane_bound(runner.d, mode)
            log(f"[lane] {LANE_MODES[mode][0]} ({mode}) at n={n} P3: kernel "
                f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, bound {b[0]:.4f} ms "
                f"({b[1]})")
            if mode in ("SIG", "TR"):  # the LF2 main path's modes
                times[LANE_MODES[mode][0]] = t
                bounds[LANE_MODES[mode][0]] = b
    del lane_k, lane_uk

    for impl, order, c in (("lane", 2, case), ("lane_u", 4, scase)):
        for kimpl in ("kernel", "reference"):
            rec = throughput.main(n=n, degree=3, n_steps=BENCH_STEPS,
                                  impl=impl, order=order, kernel_impl=kimpl,
                                  case=c)
            if not (np.isfinite(rec["value"]) and rec["value"] > 0):
                raise AssertionError(f"{impl} bench {kimpl}: bad rate "
                                     f"{rec['value']}")
            print(json.dumps(rec), flush=True)

    errs, order = lane_eigenmode_order(dev)
    log(f"[lane eigenmode] observed order {order:.3f} (bar "
        f"{EIGEN_MIN_ORDER})")
    if not (order > EIGEN_MIN_ORDER):
        raise AssertionError(f"LF4 kernel eigenmode order {order} <= "
                             f"{EIGEN_MIN_ORDER}: errors {errs}")
    launches = {k: main_counts[k] for k in ("lane_vel", "lane_stress")}
    return launches, times, bounds, (scase, sst)


UPWIND_U_MODES = {  # mode -> None (K6) or K7's (stage, damp, groups, emit)
    "rhs": None,
    "stage": (True, False, 0, False),
    "final": (False, False, 0, False),
    "final damp": (False, True, 0, False),
    "stage inject1": (True, False, 1, False),
    "final damp inject2": (False, True, 2, False),
    "stage emit": (True, False, 0, True),
    "final damp emit": (False, True, 0, True)}
UPWIND_U_MAIN = {"lane_upwind_rhs": "rhs",  # the bench steppers' modes
                 "lane_upwind_axpy": "stage inject1"}


def upwind_u_kernel_name(mode):
    return "lane_upwind_rhs" if mode == "rhs" else "lane_upwind_axpy"


def small_upwind_u_runner(dim, degree, dev, acoustic=False):
    """K6/K7 runner with a sponge on a scrambled free-top box_mesh(4, 4, 4)
    (3D) or rect_mesh(8, 8) (2D): the bench material, or vs = 0 where
    x < 0.5."""
    import dataclasses

    import numpy as np

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params, \
        build_upwind_data
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask
    from seigen_tpu_torch.solver.lane_upwind_u import \
        UnstructuredUpwindRunner

    topo = box_mesh(4, 4, 4) if dim == 3 else rect_mesh(8, 8)
    perm = np.random.default_rng(0).permutation(topo.num_cells)
    dm = build_discrete(
        dataclasses.replace(topo, cells=topo.cells[perm], structure=None),
        degree, bc_fn=absorbing_bc_fn(((0.0, 1.0),) * dim,
                                      free_sides=[(dim - 1, "hi")]))
    cent = dm.coords.mean(axis=1)
    mat = Material(1.0, 2.0,
                   np.where(cent[:, 0] < 0.5, 0.0, 1.0) if acoustic else 1.0)
    return UnstructuredUpwindRunner(
        build_params(dm, mat, device=dev),
        build_upwind_data(dm, mat, device=dev), 0.01, centroids=cent,
        damp=sponge_mask(dm, [(0, "lo")], width=0.3), impl="kernel")


def upwind_u_inputs(runner, seed):
    """numpy-seeded float32 K6/K7 operands in the runner's lane layout:
    panels in the gathered (pu, pt) and in the emitted (pu_e, pt_e)
    layout."""
    import numpy as np
    import torch

    d = runner.d
    rng = np.random.default_rng(seed)

    def rows(C, used, pad):
        a = rng.standard_normal((C, pad, d.E)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * pad, d.E), device=runner.device)

    def state(n=1):
        return [(rows(d.dim, d.n_p, d.npp), rows(d.n_sig, d.n_p, d.npp))
                for _ in range(n)]

    rows_pad = runner.selcfg[5]
    (u, s), base, acc = state(3)
    return {"u": u, "s": s, "base": base, "acc": acc, "S": state(2),
            "pu": rows(d.nf, d.dim * d.ftp, rows_pad),
            "pt": rows(d.nf, d.dim * d.ftp, rows_pad),
            "pu_e": rows(d.nf * d.dim, d.ftp, d.ftpp),
            "pt_e": rows(d.nf * d.dim, d.ftp, d.ftpp)}


def upwind_u_call(runner, x, mode):
    """(kernel fn, plain fn) of K6 or one K7 mode on the runner's data."""
    from seigen_tpu_torch.ops import lane_upwind_kernels as luk

    d = runner.d
    spec = UPWIND_U_MODES[mode]
    emit = spec is not None and spec[3]
    pu, pt = (x["pu_e"], x["pt_e"]) if emit else (x["pu"], x["pt"])
    cfg = luk.emitted_selcfg(runner.selcfg) if emit else runner.selcfg
    args = (d, runner.uw, x["u"], x["s"], pu, pt, runner.combo,
            runner.sign_u, runner.sign_t, cfg)
    if spec is None:
        return (lambda: luk.LANE_UPWIND_RHS(*args),
                lambda: luk.upwind_rhs_lm_sel_ref(*args))
    stage, damp, n_inj, _ = spec
    args += (*x["acc"], 0.21)
    kw = dict(base_u=x["base"][0] if stage else None,
              base_s=x["base"][1] if stage else None,
              cs=0.37 if stage else None,
              inject=[(*x["S"][g], (0.7, -1.3)[g]) for g in range(n_inj)],
              damp_row=runner.damp_u[: d.npp] if damp else None, emit=emit)
    return (lambda: luk.LANE_UPWIND_AXPY(*args, **kw),
            lambda: luk.upwind_rhs_lm_sel_axpy_ref(*args, **kw))


def compare_upwind_u(runner, check, tag, seed, modes=tuple(UPWIND_U_MODES)):
    import torch

    x = upwind_u_inputs(runner, seed)
    for mode in modes:
        kern, plain = upwind_u_call(runner, x, mode)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        check(upwind_u_kernel_name(mode), f"{tag} {mode}", got, ref)
    return x


def upwind_u_bound(d, mode):
    """(bound_ms, "bytes" | "operations") of one launch of K6 or a K7
    mode: compulsory bytes (u and sigma, and for K7 the accumulator, the
    base state, the sponge row and the dense patterns the mode reads, at
    n_p rows per component; the selected rows of both panels; the geometry
    counted per face as in ``lane_bound`` — Ginv, normals, Fscale, the
    neighbour impedances, the combo and both sign rows — and the material
    and own-impedance rows; the output, with the emitted panels, as
    written) over the memory rate, and the Dr and LIFT FLOPs over the FP32
    rate."""
    dim, n_p, ftp, npp, nf = d.dim, d.n_p, d.ftp, d.npp, d.nf
    c = dim + d.n_sig
    spec = UPWIND_U_MODES[mode] or (False, False, 0, False)
    stage, damp, n_inj, emit = spec
    axpy = UPWIND_U_MODES[mode] is not None
    state_in = c * n_p * (1 + axpy + stage + n_inj) + (n_p if damp else 0)
    geo = dim * dim + dim * nf + nf + 3 + 2 * nf + 2 + 3 * nf
    out = c * npp * (2 if stage else 1) + (2 * dim * d.ftpp if emit else 0)
    rows = state_in + 2 * dim * ftp + geo + out
    flops = 2 * (c * dim * n_p * n_p + c * n_p * ftp)
    t_bytes = 4.0 * rows * d.E / HBM_BYTES_PER_S * 1e3
    t_ops = float(flops) * d.E / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_upwind_u(dev, scase, sst, check, n=24):
    """Phase 8 (see the module docstring); returns ({kernel: launches on
    its main-path run}, {kernel: (kernel ms, plain ms)} and {kernel:
    bound} of the bench steppers' modes)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.ops import build_visco

    t0 = time.perf_counter()
    for dim, degree, acoustic in ((3, 3, False), (3, 2, False),
                                  (2, 2, False), (3, 2, True)):
        small = small_upwind_u_runner(dim, degree, dev, acoustic)
        tag = f"{dim}D P{degree}" + (" acoustic" if acoustic else "")
        log(f"[upwind_u] {tag}: E {small.E}, ftp {small.d.ftp}, ftpp "
            f"{small.d.ftpp}, {len(small.selcfg[7])} orientation groups")
        compare_upwind_u(small, check, tag, 60 + 10 * dim + degree)
    log(f"[upwind_u] all small-mesh modes agree "
        f"({time.perf_counter() - t0:.1f} s)")

    # the runner at full width: the four steppers, kernel vs plain
    dm, p, src, damp, dt, _ = scase
    f0 = src.f0[0].item()
    visco = build_visco(p, 30.0, 20.0, 0.25 * f0, 2.5 * f0, L=3)
    launches = {}
    for tag, opts, kname in (
            ("fused", {}, "lane_upwind_axpy"),
            ("panel_emit", {"panel_emit": True}, "lane_upwind_axpy"),
            ("glue", {"fused_axpy": False}, "lane_upwind_rhs"),
            ("visco", {"visco": visco}, "lane_upwind_rhs")):
        tag = f"upwind_u {tag}"
        t1 = time.perf_counter()
        k, r = (throughput.make_runner("upwind_lane_u", dm, p, src, damp,
                                       dt, impl, **opts)
                for impl in ("kernel", "reference"))
        log(f"[{tag}] scrambled n={n} P3: dense source groups "
            f"{0 if k.src_dense is None else len(k.src_dense)}; runner "
            f"setup {time.perf_counter() - t1:.1f} s")
        reset_counts()
        out_k, _ = k.run(sst, RUNNER_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
        out_r, _ = r.run(sst, RUNNER_STEPS)
        torch.cuda.synchronize()
        log(f"[{tag}] {RUNNER_STEPS} steps: launches {counts}")
        expect_counts(tag, counts, **{kname: 4 * RUNNER_STEPS})
        compare_states(tag, out_k, out_r)
        launches.setdefault(kname, counts[kname])  # fused and glue runs
        if not opts:
            run_k = k
        del r

    # every mode at n=24 P3: check, kernel and plain times, bound
    times, bounds = {}, {}
    x = compare_upwind_u(run_k, check, f"n={n} P3", 71)
    for mode in UPWIND_U_MODES:
        kern, plain = upwind_u_call(run_k, x, mode)
        t = (time_ms(kern), time_ms(plain))
        b = upwind_u_bound(run_k.d, mode)
        kname = upwind_u_kernel_name(mode)
        log(f"[upwind_u] {kname} ({mode}) at n={n} P3: kernel {t[0]:.4f} "
            f"ms, plain {t[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
        if UPWIND_U_MAIN[kname] == mode:
            times[kname], bounds[kname] = t, b
    del run_k, k, x

    for kimpl, opts in (("kernel", {"panel_emit": True}),
                        ("kernel", {"fused_axpy": False}),
                        ("kernel", {}), ("reference", {})):
        rec = throughput.main(n=n, degree=3, n_steps=BENCH_STEPS,
                              impl="upwind_lane_u", kernel_impl=kimpl,
                              case=scase, **opts)
        if not (np.isfinite(rec["value"]) and rec["value"] > 0):
            raise AssertionError(f"upwind_lane_u bench {kimpl} {opts}: bad "
                                 f"rate {rec['value']}")
        print(json.dumps(rec), flush=True)
    return launches, times, bounds


def random_stiffness(E, n_sig, seed):
    """Per-element NON-symmetric matrices: a C[c, k] / C[k, c] swap or a
    transposed strain index hides behind a symmetric one."""
    import numpy as np

    return np.random.default_rng(seed).standard_normal((E, n_sig, n_sig))


def small_aniso_runners(dim, degree, dev):
    """Kernel runners with a per-element random stiffness on a free-top,
    sponge-damped box_mesh(4, 4, 4) (3D) or rect_mesh(8, 8) (2D):
    (MergedLaneRunner, UnstructuredLaneRunner on the same mesh,
    UnstructuredLaneRunner on a scrambled copy)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask
    from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner
    from seigen_tpu_torch.solver.lane_unstructured import \
        UnstructuredLaneRunner

    topo = box_mesh(4, 4, 4) if dim == 3 else rect_mesh(8, 8)
    bc = absorbing_bc_fn(((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")])
    mat = Material(1.0, 2.0, 1.0)
    perm = np.random.default_rng(0).permutation(topo.num_cells)
    scrambled = dataclasses.replace(topo, cells=topo.cells[perm],
                                    structure=None)
    out = []
    for i, t in enumerate((topo, scrambled)):
        dm = build_discrete(t, degree, bc_fn=bc)
        p = build_params(dm, mat, device=dev)
        C = random_stiffness(dm.num_elements, p.n_sig, 90 + i)
        if i == 0:
            damp = torch.as_tensor(
                sponge_mask(dm, [(0, "lo"), (0, "hi")], width=0.3),
                device=dev).float()
            out.append(MergedLaneRunner(p, detect_structured(dm), 0.01,
                                        damp=damp, impl="kernel",
                                        stiffness=C))
        out.append(UnstructuredLaneRunner(
            p, 0.01, centroids=dm.coords.mean(axis=1), impl="kernel",
            stiffness=C))
    return out


STRESS_VARIANTS = ("plain", "axpy", "axpy_damp", "inject1", "inject2")


def compare_merged_aniso(runner, check, tag, seed):
    """Every K2 variant on operator data with a C section vs the plain
    version; returns the operands."""
    import torch

    from seigen_tpu_torch.ops import merged_kernels as mk

    if runner.d.off[6] < 0:
        raise AssertionError(f"{tag}: the operator data has no C section")
    x = variant_inputs(runner, seed)
    for variant in STRESS_VARIANTS:
        kern, plain, args, kw = variant_call(runner, x, "stress", variant)
        n0, c0 = mk.STRESS_KERNEL.launches, mk.STRESS_KERNEL.launches_c
        got = kern(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        if (mk.STRESS_KERNEL.launches, mk.STRESS_KERNEL.launches_c) != (
                n0 + 1, c0 + 1):
            raise AssertionError(f"{tag} {variant}: not one general-law "
                                 "launch of merged_stress")
        check("merged_stress[C]", f"{tag} C stress {variant} out", got[0],
              ref[0])
        check("merged_stress[C]", f"{tag} C stress {variant} traces", got[1],
              ref[1])
    return x


def compare_lane_aniso(runner, check, tag, seed):
    """K5 modes TR and SEL with the runner's cmat vs the plain versions
    (and not equal to the isotropic launch); returns the operands."""
    import torch

    from seigen_tpu_torch.ops import lane_kernels as lk

    x = lane_inputs(runner, seed)
    for mode, name in (("TR", "lane_stress[C,TR]"),
                       ("SEL stress", "lane_stress[C,SEL]")):
        kern, plain = lane_call(runner, x, mode, cmat=runner.cmat)
        n0, c0 = lk.LANE_STRESS.launches, lk.LANE_STRESS.launches_c
        got, ref = kern(), plain()
        iso = lane_call(runner, x, mode)[0]()
        torch.cuda.synchronize()
        if (lk.LANE_STRESS.launches, lk.LANE_STRESS.launches_c) != (
                n0 + 2, c0 + 1):
            raise AssertionError(f"{tag} {mode}: not one general-law and "
                                 "one isotropic launch of lane_stress")
        check(name, f"{tag} C {mode}", got, ref)
        if torch.allclose(got, iso):
            raise AssertionError(f"{tag} {mode}: cmat changed nothing")
    return x


def sh_wave_errors(dev):
    """An SH plane wave (x-propagating, y-polarized) in a VTI medium
    (gamma = 0.3) on periodic box_mesh(8, 2, 2) P3, LF4 through K4/K5 with
    the stiffness (LaneMajorRunner, float32): relative L2 misfit of u_y
    against the initial wave after the period of sqrt(C66/rho) and after
    the isotropic one, and the phase error expected of the latter."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.anisotropic import max_wavespeed, vti_stiffness
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver import State, cfl_dt
    from seigen_tpu_torch.solver.lane_major import LaneMajorRunner

    vp, vs, rho, gam = 2.0, 1.0, 1.0, 0.3
    C = vti_stiffness(vp, vs, rho, gamma=gam)
    c_sh = np.sqrt(C[5, 5] / rho)
    dm = build_discrete(box_mesh(8, 2, 2, periodic=(0, 1, 2)), 3)
    p = build_params(dm, Material(rho=rho, vp=vp, vs=vs),
                     dtype=torch.float32, device=dev)
    ex = detect_structured(dm)
    E, n_p = dm.num_elements, dm.re.n_p
    k = 2 * np.pi
    dt = cfl_dt(dm.h.min(), max_wavespeed(C, rho), 3, 0.4)
    x = np.asarray(dm.coords)[:, :, 0]
    u0 = np.cos(k * x)

    def run_T(T):
        n = int(np.ceil(T / dt))
        dtp = T / n
        u = np.zeros((E, n_p, 3))
        u[:, :, 1] = u0
        s = np.zeros((E, n_p, 6))
        # right-going SH wave: sigma_xy = -Z v with Z = rho c_sh
        s[:, :, 5] = -rho * c_sh * np.cos(k * (x - c_sh * 0.5 * dtp))
        runner = LaneMajorRunner(p, ex, dtp, order=4, impl="kernel",
                                 stiffness=C)
        reset_counts()
        fin, _ = runner.run(State(u=torch.as_tensor(u, device=dev).float(),
                                  s=torch.as_tensor(s, device=dev).float()),
                            n)
        torch.cuda.synchronize()
        expect_counts("SH wave", read_counts(), lane_vel=3 * n,
                      lane_stress=3 * n, lane_stress_c=3 * n)
        u1 = fin.u[:, :, 1].double().cpu().numpy()
        return np.sqrt(((u1 - u0) ** 2).mean()) / np.sqrt((u0**2).mean())

    e_good = run_T(2 * np.pi / (k * c_sh))
    e_iso = run_T(2 * np.pi / (k * vs))
    return e_good, e_iso, 2 * abs(np.sin(np.pi * (c_sh / vs - 1.0)))


def facade_runs(dev):
    """ElasticSimulation on the card, rect_mesh(8, 8) P2 with a source, a
    sponge and receivers: impl "auto" must run the lane kernels, and
    ``stiffness=`` the einsum anisotropic path."""
    import numpy as np

    from seigen_tpu_torch.mesh import rect_mesh
    from seigen_tpu_torch.ops import Material
    from seigen_tpu_torch.ops.anisotropic import iso_stiffness
    from seigen_tpu_torch.solver import ElasticSimulation, PointSource, \
        SimConfig, line

    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    cfg = SimConfig(degree=2, order=4, impl="auto", free_sides=((1, "hi"),),
                    absorbing_sides=((0, "lo"), (0, "hi"), (1, "lo")),
                    sponge_width=0.2)
    kw = dict(sources=[PointSource(position=(0.5, 0.6), f0=6.0, radius=0.15)],
              receiver_points=line((0.3, 0.9), (0.7, 0.9), 4), device=dev)
    for tag, stiffness, impl in (
            ("auto", None, "lane"),
            ("stiffness", iso_stiffness(float(mat.lam), float(mat.mu), 2),
             "einsum")):
        sim = ElasticSimulation(rect_mesh(8, 8), mat, cfg,
                                stiffness=stiffness, **kw)
        if sim._impl != impl:
            raise AssertionError(f"facade {tag}: impl {sim._impl!r}, "
                                 f"expected {impl!r}")
        reset_counts()
        fin, seis = sim.run(0.1)
        counts = read_counts()
        n = len(seis)
        ok = (np.isfinite(seis).all() and np.abs(seis).max() > 0
              and seis.shape[1:] == (4, 2) and fin.u.device.type == "cuda"
              and bool(fin.u.isfinite().all()))
        log(f"[facade {tag}] impl {sim._impl}, {n} steps of dt {sim.dt:.5f}:"
            f" max |seismogram| {np.abs(seis).max():.4e}, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not ok:
            raise AssertionError(f"facade {tag}: bad result")
        if impl == "lane":
            expect_counts(f"facade {tag}", counts, lane_vel=3 * n,
                          lane_stress=3 * n)
        else:
            expect_counts(f"facade {tag}", counts)


def phase_aniso(dev, case, st, scase, sst, check, n=24):
    """Phase 9 (see the module docstring); returns ({mode: launches on its
    main-path run}, {mode: (kernel ms, plain ms)}, {mode: bound}) keyed by
    ANISO_MODES."""
    import numpy as np
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.solver.lane_unstructured import \
        UnstructuredLaneRunner

    t0 = time.perf_counter()
    for dim, degree in ((3, 3), (3, 2), (2, 2)):
        merged, lane_u, lane_us = small_aniso_runners(dim, degree, dev)
        tag = f"{dim}D P{degree}"
        log(f"[aniso] {tag}: E {lane_u.E}, C section at geo row "
            f"{merged.d.off[6]} of {merged.d.off[7]}")
        compare_merged_aniso(merged, check, tag, 80 + degree)
        compare_lane_aniso(lane_u, check, tag, 82 + degree)
        compare_lane_aniso(lane_us, check, f"{tag} scrambled", 84 + degree)
    log(f"[aniso] all small-mesh general-law modes agree "
        f"({time.perf_counter() - t0:.1f} s)")

    # the runners at full width with the bench's VTI stiffness
    dm, p, src, damp, dt, _ = case
    sdm, sp, ssrc, sdamp, sdt, _ = scase
    S = RUNNER_STEPS
    launches, keep = {}, {}

    def lane_u_pair(fused):
        C = throughput.bench_stiffness("lane_u", sdm.num_elements)
        return (UnstructuredLaneRunner(
            sp, sdt, order=4, src=ssrc, damp=sdamp, impl=impl,
            centroids=sdm.coords.mean(axis=1), fused_select=fused,
            stiffness=C) for impl in ("kernel", "reference"))

    for tag, mode, make, state, expect in (
            ("merged vti", "merged_stress[C]",
             lambda: (throughput.make_runner("merged", dm, p, src, damp, dt,
                                             impl, vti=True)
                      for impl in ("kernel", "reference")), st,
             dict(merged_vel=3 * S, merged_stress=3 * S,
                  merged_stress_c=3 * S)),
            ("lane LF4 vti", "lane_stress[C,TR]",
             lambda: (throughput.make_runner("lane", dm, p, src, damp, dt,
                                             impl, order=4, vti=True)
                      for impl in ("kernel", "reference")), st,
             dict(lane_vel=3 * S, lane_stress=3 * S, lane_stress_c=3 * S)),
            ("lane_u LF4 vti fused_select=True", "lane_stress[C,SEL]",
             lambda: lane_u_pair(True), sst,
             dict(lane_vel=3 * S, lane_stress=3 * S, lane_stress_c=3 * S)),
            ("lane_u LF4 vti fused_select=False", None,
             lambda: lane_u_pair(False), sst,
             dict(lane_vel=3 * S, lane_stress=3 * S, lane_stress_c=3 * S))):
        t1 = time.perf_counter()
        k, r = make()
        log(f"[{tag}] n={n} P3 runner setup {time.perf_counter() - t1:.1f} s")
        reset_counts()
        out_k, _ = k.run(state, S)
        torch.cuda.synchronize()
        counts = read_counts()
        out_r, _ = r.run(state, S)
        torch.cuda.synchronize()
        log(f"[{tag}] {S} steps: launches {counts}")
        expect_counts(tag, counts, **expect)  # no isotropic stress launch
        compare_states(tag, out_k, out_r)
        if mode is not None:
            launches[mode] = counts[C_COUNTS[mode.startswith("lane")]]
            keep[mode] = k
        del r, out_k, out_r

    # every general-law mode at n=24 P3: check, kernel and plain times, bound
    times, bounds = {}, {}
    run_k = keep["merged_stress[C]"]
    x = compare_merged_aniso(run_k, check, f"n={n} P3", 86)
    kern, plain, args, kw = variant_call(run_k, x, "stress", "plain")
    times["merged_stress[C]"] = (time_ms(lambda: kern(*args, **kw)),
                                 time_ms(lambda: plain(*args, **kw)))
    bounds["merged_stress[C]"] = bound(run_k.d, run_k.plan, "merged_stress",
                                       aniso=True)
    del run_k, x, args, kw
    for name, mode in (("lane_stress[C,TR]", "TR"),
                       ("lane_stress[C,SEL]", "SEL stress")):
        runner = keep[name]
        x = lane_inputs(runner, 87)
        kern, plain = lane_call(runner, x, mode, cmat=runner.cmat)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        check(name, f"n={n} P3 C {mode}", got, ref)
        times[name] = (time_ms(kern), time_ms(plain))
        bounds[name] = lane_bound(runner.d, mode, aniso=True)
        del x, got, ref
    for name in times:
        t, b = times[name], bounds[name]
        log(f"[aniso] {name} at n={n} P3: kernel {t[0]:.4f} ms, plain "
            f"{t[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    keep.clear()
    del runner, kern, plain

    for impl, c, vti in (("merged", case, True), ("lane", case, False),
                         ("lane", case, True), ("lane_u", scase, True)):
        reset_counts()
        rec = throughput.main(n=n, degree=3, n_steps=BENCH_STEPS, impl=impl,
                              order=4, kernel_impl="kernel", case=c, vti=vti)
        counts = read_counts()
        stress = "merged_stress" if impl == "merged" else "lane_stress"
        if not (np.isfinite(rec["value"]) and rec["value"] > 0
                and rec["detail"]["vti"] is vti
                and counts[stress + "_c"] == (counts[stress] if vti else 0)):
            raise AssertionError(f"{impl} bench vti={vti}: rate "
                                 f"{rec['value']}, launches {counts}")
        print(json.dumps(rec), flush=True)

    e_good, e_iso, phase_err = sh_wave_errors(dev)
    log(f"[aniso SH wave] box_mesh(8,2,2) periodic P3 float32, VTI gamma "
        f"0.3: misfit after the anisotropic period {e_good:.6f} (bar "
        f"{SH_WAVE_MAX_ERR}), after the isotropic period {e_iso:.4f} "
        f"(expected phase error {phase_err:.4f})")
    if not (e_good < SH_WAVE_MAX_ERR and e_iso > 0.5 * phase_err):
        raise AssertionError(f"SH wave: {e_good} after the anisotropic "
                             f"period, {e_iso} after the isotropic one")

    facade_runs(dev)
    return launches, times, bounds


FUSED_VARIANTS = {  # check name -> (op, variant)
    "fused_vel2": (("vel", "plain"), ("vel", "axpy")),
    "fused_stress2": (("stress", "plain"), ("stress", "axpy_damp")),
    "fused_stress2[C]": (("stress", "plain"), ("stress", "axpy_damp"))}


def small_fused_runners(dim, degree, dev):
    """Kernel FusedLaneRunners on a free-top, sponge-damped box_mesh(4, 4,
    4) (3D) or rect_mesh(8, 8) (2D): isotropic, with a per-element random
    stiffness, and on the periodic twin of the mesh."""
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask
    from seigen_tpu_torch.solver.lane_fused import FusedLaneRunner

    topo, per = ((box_mesh(4, 4, 4), box_mesh(4, 4, 4, periodic=(0, 1, 2)))
                 if dim == 3 else
                 (rect_mesh(8, 8), rect_mesh(8, 8, periodic=(0, 1))))
    mat = Material(1.0, 2.0, 1.0)
    dm = build_discrete(topo, degree, bc_fn=absorbing_bc_fn(
        ((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")]))
    p = build_params(dm, mat, device=dev)
    ex = detect_structured(dm)
    damp = torch.as_tensor(sponge_mask(dm, [(0, "lo"), (0, "hi")],
                                       width=0.3), device=dev).float()
    C = random_stiffness(dm.num_elements, p.n_sig, 95)
    dm_per = build_discrete(per, degree)
    return (FusedLaneRunner(p, ex, 0.01, damp=damp, impl="kernel"),
            FusedLaneRunner(p, ex, 0.01, damp=damp, impl="kernel",
                            stiffness=C),
            FusedLaneRunner(build_params(dm_per, mat, device=dev),
                            detect_structured(dm_per), 0.01, impl="kernel"))


def fused_inputs(d, dev, seed):
    """numpy-seeded float32 K8/K9/K10 operands in the v2 lane layout."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def rows(C, used, pad):
        a = rng.standard_normal((C, pad, d.E)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * pad, d.E), device=dev)

    return {"sig": [rows(d.n_sig, d.n_p, d.npp) for _ in range(3)],
            "u": [rows(d.dim, d.n_p, d.npp) for _ in range(3)],
            "tr": rows(d.dim, d.ftp, d.ftpp)}


def fused_call(runner, x, op, variant):
    """(kernel fn, plain fn) of one K8/K9 variant on the runner's data (K9
    runs the general Hooke law when the runner has a stiffness)."""
    from seigen_tpu_torch.ops import fused_ops as fo

    d = runner.d
    field, pair = (x["sig"], x["u"]) if op == "vel" else (x["u"], x["sig"])
    kw = {}
    if variant.startswith("axpy"):
        dt = float(runner.dt)
        kw = dict(axpy=(pair[1], pair[2]), dt=dt, c3=dt**3 / 24.0)
    if op == "vel":
        return (lambda: fo.VEL2_KERNEL(d, field[0], x["tr"], **kw),
                lambda: fo.vel2_op_ref(d, field[0], x["tr"], **kw))
    damp = d.damp if variant == "axpy_damp" else None
    return (lambda: fo.STRESS2_KERNEL(d, field[0], x["tr"], damp=damp, **kw),
            lambda: fo.stress2_op_ref(d, field[0], x["tr"], **kw))


def compare_fused(iso, aniso, check, tag, seed):
    """Every K8/K9 variant (K9 also with the general Hooke law) vs the
    plain versions."""
    import torch

    from seigen_tpu_torch.ops import fused_ops as fo

    for name, variants in FUSED_VARIANTS.items():
        runner = aniso if name.endswith("[C]") else iso
        x = fused_inputs(runner.d, runner.device, seed)
        for op, variant in variants:
            kern, plain = fused_call(runner, x, op, variant)
            c0 = fo.STRESS2_KERNEL.launches_c
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if fo.STRESS2_KERNEL.launches_c - c0 != int(runner is aniso):
                raise AssertionError(f"{tag} {name} {variant}: general-law "
                                     "launch count off")
            check(name, f"{tag} {name} {variant} out", got[0], ref[0])
            check(name, f"{tag} {name} {variant} traces", got[1], ref[1])


def compare_exchange(runner, check, tag, seed):
    """K10 vs the plain gather, traction (negated) and velocity traces."""
    import torch

    from seigen_tpu_torch.solver import lane_fused as lf

    tr = fused_inputs(runner.d, runner.device, seed)["tr"]
    for negate in (True, False):
        got = lf.TRACE_EXCHANGE(runner.xplan, tr, negate)
        ref = lf.trace_exchange_ref(runner.xplan, tr, negate)
        torch.cuda.synchronize()
        check("trace_exchange", f"{tag} trace_exchange negate={negate}",
              got, ref)


def fused_bound(d, kname, aniso=False):
    """(bound_ms, "bytes" | "operations") of one plain launch of K8, K9 or
    K10 at these shapes.  K8/K9: state rows n_p per component, the dim*ftp
    consumer trace rows, the geometry once per face (Ginv, normals, scb,
    bfs or dfs) and the material rows (1/rho; lambda and mu, or the n_sig^2
    stiffness rows), the output at npp and its dim*ftpp trace rows
    written; the Dr and LIFT FLOPs.  K10: dim*ftp rows and nf mask rows
    read, dim*ftpp rows written, no arithmetic."""
    dim, n_p, nf, npp, n_sig = d.dim, d.n_p, d.nf, d.npp, d.n_sig
    ftp, ftpp = d.ftp, d.ftpp
    if kname == "trace_exchange":
        rows, flops = dim * ftp + nf + dim * ftpp, 0
    else:
        geo = dim * dim + dim * nf + 2 * nf
        if kname == "fused_vel2":
            c_in, c_out, geo = n_sig, dim, geo + 1
        else:
            c_in, c_out = dim, n_sig
            geo += n_sig * n_sig if aniso else 2
        rows = c_in * n_p + dim * ftp + geo + c_out * npp + dim * ftpp
        flops = 2 * (c_out * dim * n_p * n_p + c_out * n_p * ftp)
    t_bytes = 4.0 * rows * d.E / HBM_BYTES_PER_S * 1e3
    t_ops = float(flops) * d.E / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_fused(dev, case, st, check, merged_out, n=24):
    """Phase 10 (see the module docstring); merged_out: phase 4's kernel
    MergedLaneRunner state after RUNNER_STEPS steps from ``st``.  Returns
    ({kernel: launches on its main-path run}, {kernel: (kernel ms, plain
    ms)}, {kernel: bound}, {kernel: library ms})."""
    import numpy as np
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.solver import lane_fused as lf

    t0 = time.perf_counter()
    for dim, degree in ((3, 3), (3, 2), (2, 2)):
        iso, aniso, per = small_fused_runners(dim, degree, dev)
        tag = f"{dim}D P{degree}"
        log(f"[fused] {tag}: E {iso.d.E}, ftp {iso.d.ftp}, ftpp "
            f"{iso.d.ftpp}; periodic twin E {per.d.E}")
        compare_fused(iso, aniso, check, tag, 100 + 10 * dim + degree)
        compare_exchange(iso, check, tag, 120 + 10 * dim + degree)
        compare_exchange(per, check, f"{tag} periodic",
                         140 + 10 * dim + degree)
    log(f"[fused] all small-mesh variants agree "
        f"({time.perf_counter() - t0:.1f} s)")

    dm, p, src, damp, dt, _ = case
    S = RUNNER_STEPS
    launches, keep = {}, {}
    for tag, vti in (("fused", False), ("fused vti", True)):
        t1 = time.perf_counter()
        k, r = (throughput.make_runner("fused", dm, p, src, damp, dt, impl,
                                       vti=vti)
                for impl in ("kernel", "reference"))
        log(f"[{tag}] n={n} P3: runner setup "
            f"{time.perf_counter() - t1:.1f} s")
        reset_counts()
        out_k, _ = k.run(st, S)
        torch.cuda.synchronize()
        counts = read_counts()
        out_r, _ = r.run(st, S)
        torch.cuda.synchronize()
        log(f"[{tag}] {S} steps: launches {counts}")
        expect = dict(fused_vel2=3 * S, fused_stress2=3 * S,
                      trace_exchange=6 * S)
        if vti:
            expect["fused_stress2_c"] = 3 * S
        expect_counts(tag, counts, **expect)
        compare_states(tag, out_k, out_r)
        if vti:
            launches["fused_stress2[C]"] = counts["fused_stress2_c"]
            keep["fused_stress2[C]"] = k
        else:
            compare_states(tag, out_k, merged_out, "fused vs merged kernel")
            launches.update({name: counts[name] for name in expect})
            keep["fused"] = k
        del r, out_k, out_r

    # K8, K9, K9-C and K10 at n=24 P3: check, kernel and plain times, bound
    times, bounds, library = {}, {}, {}
    run_k = keep["fused"]
    x = fused_inputs(run_k.d, dev, 150)
    for name, runner in (("fused_vel2", run_k), ("fused_stress2", run_k),
                         ("fused_stress2[C]", keep["fused_stress2[C]"])):
        kern, plain = fused_call(runner, x, *FUSED_VARIANTS[name][0])
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        check(name, f"n={n} P3 {name} plain out", got[0], ref[0])
        check(name, f"n={n} P3 {name} plain traces", got[1], ref[1])
        times[name] = (time_ms(kern), time_ms(plain))
        bounds[name] = fused_bound(runner.d, name.removesuffix("[C]"),
                                   aniso=name.endswith("[C]"))
        del got, ref
    xp, tr = run_k.xplan, x["tr"]
    compare_exchange(run_k, check, f"n={n} P3", 151)
    times["trace_exchange"] = (
        time_ms(lambda: lf.TRACE_EXCHANGE(xp, tr, True)),
        time_ms(lambda: lf.trace_exchange_ref(xp, tr, True)))
    bounds["trace_exchange"] = fused_bound(run_k.d, "trace_exchange")
    index = xp.gather[0]
    library["trace_exchange"] = time_ms(lambda: torch.take(tr, index))
    for name in ("fused_vel2", "fused_stress2", "fused_stress2[C]",
                 "trace_exchange"):
        t, b = times[name], bounds[name]
        lib = (f", torch.take {library[name]:.4f} ms" if name in library
               else "")
        log(f"[fused] {name} at n={n} P3: kernel {t[0]:.4f} ms, plain "
            f"{t[1]:.4f} ms{lib}, bound {b[0]:.4f} ms ({b[1]})")
    keep.clear()
    del run_k, runner, x, xp, tr, index, kern, plain

    for kimpl, vti in (("kernel", False), ("reference", False),
                       ("kernel", True)):
        reset_counts()
        rec = throughput.main(n=n, degree=3, n_steps=BENCH_STEPS,
                              impl="fused", kernel_impl=kimpl, case=case,
                              vti=vti)
        counts = read_counts()
        n_c = counts["fused_stress2_c"]
        if not (np.isfinite(rec["value"]) and rec["value"] > 0
                and rec["detail"]["vti"] is vti
                and n_c == (counts["fused_stress2"] if vti else 0)):
            raise AssertionError(f"fused bench {kimpl} vti={vti}: rate "
                                 f"{rec['value']}, launches {counts}")
        print(json.dumps(rec), flush=True)

    errs, order = lane_eigenmode_order(
        dev, lf.FusedLaneRunner, "fused eigenmode", fused_vel2=3,
        fused_stress2=3, trace_exchange=6)
    log(f"[fused eigenmode] observed order {order:.3f} (bar "
        f"{EIGEN_MIN_ORDER})")
    if not (order > EIGEN_MIN_ORDER):
        raise AssertionError(f"v2 kernel eigenmode order {order} <= "
                             f"{EIGEN_MIN_ORDER}: errors {errs}")
    return launches, times, bounds, library


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    try:
        import numpy as np

        from seigen_tpu_torch.bench import throughput
        from seigen_tpu_torch.ops import lane_kernels as lk
        from seigen_tpu_torch.ops import lane_upwind_kernels as luk
        from seigen_tpu_torch.ops import merged_kernels as mk
        from seigen_tpu_torch.ops import upwind_kernels as uk
        from seigen_tpu_torch.ops.cuda_build import build_all
        from seigen_tpu_torch.solver import lane_fused as lf
        from seigen_tpu_torch.solver.timestep import State
    except ImportError as e:
        print(f"chip_smoke: the seigen_tpu_torch package is missing ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    # 1. device
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # 2. build: one nvcc per source, all at once
    libraries = (mk.LIBRARY, uk.LIBRARY, lk.LIBRARY, luk.LIBRARY,
                 lf.EXCHANGE_LIBRARY)
    wall = build_all(libraries)
    for k in all_kernels().values():
        k.build()  # load the symbols, check the argument structs
    for lib in libraries:
        log(f"[build] {lib.sources[0].name}: nvcc "
            f"{lib.build_seconds:.1f} s")
        for ln in lib.ptxas_report().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                log(f"  ptxas: {ln.strip()}")
    log(f"[build] phase {wall:.1f} s")

    # 3. kernels vs plain versions on small meshes
    check = Check()
    t0 = time.perf_counter()
    for degree in (3, 2):
        runner = make_case(4, degree, dev)
        log(f"[kernels] box_mesh(4,4,4) P{degree}: Ls {runner.plan.Ls}")
        compare_variants(runner, check, f"P{degree}", seed=degree)
    log(f"[kernels] all variants agree ({time.perf_counter() - t0:.1f} s)")

    # 4. runner: the main path at full width
    t0 = time.perf_counter()
    case = throughput.setup_case(n=24, degree=3, device=dev)
    dm, p, src, damp, dt, _ = case
    E, n_p = dm.num_elements, dm.re.n_p
    rng = np.random.default_rng(7)
    st = State(
        u=torch.as_tensor(rng.standard_normal((E, n_p, 3)), device=dev
                          ).float(),
        s=torch.as_tensor(rng.standard_normal((E, n_p, 6)), device=dev
                          ).float())
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner

    ex = detect_structured(dm)
    run_k = MergedLaneRunner(p, ex, dt, src=src, damp=damp, impl="kernel")
    run_r = MergedLaneRunner(p, ex, dt, src=src, damp=damp,
                             impl="reference")
    log(f"[runner] n=24 P3: E {E}, Ls {run_k.plan.Ls}, dense source groups "
        f"{len(run_k.src_dense)}; setup {time.perf_counter() - t0:.1f} s")
    reset_counts()
    out_k, _ = run_k.run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    launches = read_counts()
    out_r, _ = run_r.run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    log(f"[runner] {RUNNER_STEPS} steps: launches {launches}")
    expect_counts("LF4 path", launches, merged_vel=3 * RUNNER_STEPS,
                  merged_stress=3 * RUNNER_STEPS)
    compare_states("runner", out_k, out_r)

    # every variant at the main path's shapes, with kernel and plain times
    x = compare_variants(run_k, check, "n=24 P3", seed=24)
    times, bounds = {}, {}
    for op, variant in (("vel", "plain"), ("stress", "plain")):
        kern, plain, args, kw = variant_call(run_k, x, op, variant)
        kname = "merged_vel" if op == "vel" else "merged_stress"
        times[kname] = (time_ms(lambda: kern(*args, **kw)),
                        time_ms(lambda: plain(*args, **kw)))
        bounds[kname] = bound(run_k.d, run_k.plan, kname)
        log(f"[runner] {kname} ({variant}) at n=24 P3: kernel "
            f"{times[kname][0]:.4f} ms, plain {times[kname][1]:.4f} ms, "
            f"bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]})")
    log(f"[runner] phase {time.perf_counter() - t0:.1f} s")

    # 5. bench: kernels and plain versions on the same case
    t0 = time.perf_counter()
    for impl in ("kernel", "reference"):
        rec = throughput.main(n=24, degree=3, n_steps=BENCH_STEPS,
                              kernel_impl=impl, case=case)
        if not (np.isfinite(rec["value"]) and rec["value"] > 0):
            raise AssertionError(f"bench {impl}: bad rate {rec['value']}")
        print(json.dumps(rec), flush=True)
    log(f"[bench] phase {time.perf_counter() - t0:.1f} s")

    # 6. upwind: the upwind-RK4 lane path
    t0 = time.perf_counter()
    launches["upwind_rhs"], times["upwind_rhs"], bounds["upwind_rhs"] = \
        phase_upwind(dev, case, st, check)
    log(f"[upwind] phase {time.perf_counter() - t0:.1f} s")

    # 7. lane: the v1 lane-major LF engine (LF2 lane, LF4 lane_u)
    t0 = time.perf_counter()
    lane_launches, lane_times, lane_bounds, (scase, sst) = phase_lane(
        dev, case, st, check)
    launches.update(lane_launches)
    times.update(lane_times)
    bounds.update(lane_bounds)
    log(f"[lane] phase {time.perf_counter() - t0:.1f} s")

    # 8. upwind_u: the unstructured upwind-RK4 path
    t0 = time.perf_counter()
    for have, new in zip((launches, times, bounds),
                         phase_upwind_u(dev, scase, sst, check)):
        have.update(new)
    log(f"[upwind_u] phase {time.perf_counter() - t0:.1f} s")

    # 9. aniso: the general Hooke law of K2 and K5
    t0 = time.perf_counter()
    for have, new in zip((launches, times, bounds),
                         phase_aniso(dev, case, st, scase, sst, check)):
        have.update(new)
    log(f"[aniso] phase {time.perf_counter() - t0:.1f} s")

    # 10. fused: the v2 exchange-fused LF4 engine (K8, K9, K10)
    t0 = time.perf_counter()
    *fused, library = phase_fused(dev, case, st, check, out_k)
    for have, new in zip((launches, times, bounds), fused):
        have.update(new)
    log(f"[fused] phase {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    sources = dict(KERNELS)
    sources.update({m: (KERNELS[k][0], replaces)
                    for m, (k, replaces) in ANISO_MODES.items()})
    kernels = [{"name": k, "route": "cuda", "source": src_file,
                "replaces": replaces, "launches": launches[k],
                "max_abs_err": check.worst[k], "ms": times[k][0],
                "plain_ms": times[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": library.get(k)}
               for k, (src_file, replaces) in sources.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
