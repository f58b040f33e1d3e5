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
              trace_exchange); print ptxas's registers, stack and spills,
              a line for each instantiation of the tile kernels — K1, K2,
              K2-C, K8, K9, K9-C, K3, K4 (TRAC/SEL and SIG), K5, K5-C, K6
              and K7 at the eight element shapes and K1pk, K2pk, K8pk and
              K9pk (the packed K1, K2, K8 and K9; K11 is K8pk's 3D P1
              instantiation) at 2D and 3D P1 — each must report a 0 B
              stack frame and no spills.
3. kernels  - every K1/K2 variant (vel plain/axpy/inject with 1 and 2
              groups; stress plain/axpy/axpy+damp/inject with 1 and 2
              groups) against its plain PyTorch version on the card in
              float32, at all eight element shapes: 3D P1-P4 on
              box_mesh(5, 3, 4) and 2D P1-P4 on rect_mesh(14, 10), whose
              60 and 35 lanes per class end every class in a ragged tile.
4. runner   - the LF4 main path: MergedLaneRunner on the n=24 P3 explosive-
              source case (E = 82 944) for 10 steps from a numpy-seeded
              random state, kernels vs plain versions; launch counts,
              finiteness; then every variant again at these shapes, each
              kernel variant's time beside its own bound (and the plain
              variants' plain-version times), and the summed bound of an
              LF4 step's six launches (2 plain + 1 axpy of each operator).
5. bench    - seigen_tpu_torch.bench.throughput.main (100 steps, impl
              "merged") with the kernels and with the plain versions.
6. upwind   - the upwind-RK4 lane path.  Every K3 variant (plain, 1 and 2
              source groups, an acoustic vs = 0 half) against
              upwind_rhs_merged_ref at the eight shapes on the meshes of
              phase 3 (ragged last tiles);
              UpwindLaneRunner on the n=24 P3 case for 10 steps, kernel vs
              plain, elastic (blob source on the dense-group path, sponge)
              and viscoelastic (Q = 30/20, L = 3, scatter-source path):
              relative L2, launch counts (4 per step), finiteness; K3's
              variants at these shapes, each variant's time beside its own
              bound; the bench (impl
              "upwind_lane", 100 steps) with the kernel and the plain
              version; the upwind eigenmode on periodic box_mesh(N, N, N),
              N = 4 and 8, P2, float64 through the einsum run_rk4 (the
              merged plan refuses periodic meshes): L2(u) per N and the
              observed order, which must exceed 2.8.
7. lane     - the v1 lane-major LF engine.  Every K4 mode (SIG, TRAC, SEL)
              and K5 mode (TR, SEL) against its plain version: SIG/TR on
              box_mesh(4, 4, 4), TRAC/SEL on its scrambled copy, at P3 and
              P2, and all five on rect_mesh(8, 8) P2 (gathered panels of
              component stride 9, ftpp 16); every K4 and K5 mode (both are
              tile kernels) at the eight element shapes on the meshes of
              phase 3 (ragged last tiles; SIG, TRAC and TR) and their
              scrambled copies (all five);
              LaneMajorRunner on the n=24 P3 case, LF2, and
              UnstructuredLaneRunner on its scrambled copy, LF4, with
              fused_select True and False, each for 10 steps kernel vs
              plain (relative L2, launch counts of
              1 K4 + 1 K5 per LF2 step and 3 + 3 per LF4 step,
              finiteness); each mode's time beside its plain version's
              and its bound at n=24 P3; the bench (impl "lane" at LF2 and
              "lane_u" at LF4, 100 steps) with the kernels and the plain
              versions; the LF4 eigenmode through the kernels on periodic
              box_mesh(N, N, N), N = 4 and 8, P2, float32: L2(u) per N
              and the observed order, which must exceed 2.8.
8. upwind_u - the unstructured upwind-RK4 path (K6 and K7 are the two
              instantiations of one tile kernel).  K6 and every K7 mode
              (stage, final, final + sponge row, 1 and 2 dense source
              groups, panel emission in stage and final mode) against the
              plain versions at the eight shapes on scrambled copies of
              the meshes of phase 3, on scrambled rect_mesh(8, 8) P2
              (where the gathered and the emitted panel layouts differ:
              ftp 9, ftpp 16) and on an acoustic vs = 0 half of scrambled
              box_mesh(4, 4, 4) P2; UnstructuredUpwindRunner on the
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
              K2 plain / axpy / axpy + damp / 1 and 2 source groups at the
              eight shapes and on the meshes of phase 3, K5 modes TR and
              SEL on box_mesh(4, 4, 4) at P3 and P2 and rect_mesh(8, 8) P2,
              at the eight shapes on the meshes of phase 3, and on their
              scrambled copies, each against its plain version.  With the
              bench's VTI stiffness at n=24 P3: MergedLaneRunner, LaneMajorRunner (LF4)
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
              NON-symmetric C) against their plain versions at the eight
              element shapes on the meshes of phase 3 (ragged last tiles
              of the tile kernel) and on box_mesh(4, 4, 4) at P3 and P2
              and rect_mesh(8, 8) P2; K10 (traction and velocity traces)
              against the plain gather on the last three and on their
              periodic twins.  FusedLaneRunner on the n=24
              P3 case for 10 steps: kernel vs plain and vs phase 4's kernel
              MergedLaneRunner (relative L2, finiteness), exactly 3 K8 + 3
              K9 + 6 K10 launches a step and no K1/K2; the same with the
              bench's VTI stiffness (3 general-law K9 a step, no isotropic
              one).  K8, K9, K9-C and K10 times beside their plain versions
              and bounds (every K8/K9 variant beside its own bound), and
              for K10 one torch.take over the plain
              version's index (library_ms); the bench (impl "fused" with
              the kernels and the plain versions, and --vti); the LF4
              eigenmode through K8/K9/K10 on periodic box_mesh(N, N, N),
              N = 4 and 8, P2, float32: order > 2.8.  Phases 1-9 must
              launch no K8, K9 or K10.
11. packed  - the P1 two-elements-per-lane layout: the NPAR = 2
              instantiations of K1/K2/K8/K9, the packed tile kernel
              (counted by ``launches_pk``), and K11 p1_pack_vel, the
              packed K8 on the probe's geo.  ptxas's lines of the packed
              instantiations; every K1/K2 variant (as phase 3) and every
              K8/K9 variant (plain, axpy; plain, axpy + sponge) on packed
              data against the plain versions on box_mesh(4, 4, 4) P1 and
              rect_mesh(8, 8) P1 (a whole tile and a ragged one, and a
              ragged one alone) with a random density per element, so
              that a 1/rho row read at the other parity shows; K11
              against packed_vel_op_ref on the same 3D mesh.
              MergedLaneRunner(packed=True) on the n=32 P1 explosive-
              source case (E = 196 608) for 10 steps: kernel vs plain and
              packed kernel vs unpacked kernel runner (relative L2),
              exactly 3 + 3 packed K1/K2 launches a step and no other;
              each packed kernel's time beside its plain version's and its
              bound at these shapes (K1pk's and K8pk's axpy, K2pk's and
              K9pk's axpy + sponge variants beside their own bounds too),
              with the unpacked K1/K2 at the same
              case beside them; the benches at n=32 P1 (impl "merged" and
              "merged_pk" with the kernels, "merged_pk" with the plain
              versions); the pack probe (p1_pack_probe.main): padded K8
              against K11, packed K8, padded and packed K9, in ms per op
              beside their bytes bounds.  Phases 1-10 must launch no
              packed instantiation and no K11.
12. cpml    - C-PML on the merged engine (solver/lane_cpml.py: K1/K2 on
              direction-masked geometry, classical RK4) and the port's
              other solver modules.  CpmlLaneRunner on the n=24 P3 case
              (phase 4's mesh, source and random state; a C-PML of width
              0.15 on the five non-free sides in place of the sponge) for
              10 steps: kernel vs plain (relative L2 < 1e-4), exactly 12
              K1 + 12 K2 plain launches a step and no other kernel; the
              kernel lane runner against the einsum run_cpml in float32
              on box_mesh(4, 4, 4) and rect_mesh(8, 8) P2 (6 steps, a
              random material, a source; relative L2 < 1e-4); absorption
              (the pulse of tests/test_cpml.py in the all-absorbing
              rect_mesh(12, 12) P3: interior residual with the C-PML <
              0.01 x without); the main path (MergedLaneRunner, kernels)
              on the explosion of tests/test_greens.py against
              ExplosionGreens3D (velocity misfit < 0.12, pressure < 0.18,
              signed correlation > 0.995; 3 + 3 launches a step); curved
              LF4 on rect_mesh(8, 8) P2, 300 steps, finite and energy <
              50 x its start; the LF4 eigenmode sweeps of
              tests/test_eigenmode.py through the einsum timestep.run in
              float64 (2D P1-P3, 3D P1-P4, orders above its bars); the
              rows of bench/pml_ab.py at 2D n=64 P3 and 3D n=24 P3 (the
              lane C-PML's ms a step, DOF-updates/s, K1/K2 ms against the
              rest) and of bench/curvi_ab.py.

Tolerance of a kernel against its plain version: |k - p| <= rtol*|p| +
atol*max|p| with rtol = 2e-4, atol = 2e-5.  The absolute floor is taken
relative to the output's largest magnitude because float32 rounding of
the ~1e3-1e4-sized operator terms leaves absolute errors of ~1e-4 in
outputs that happen to be near zero, for the plain version as much as for
the kernel.

Each kernel's bound is the larger of its compulsory bytes (inputs read
once, outputs written once, from the main path's shapes; a K1/K2 variant
counts its own axpy, damping and source rows) over the H100's published
3.35 TB/s and its matrix-product FLOPs over the published 67 TFLOP/s FP32
rate.  K10 does no arithmetic: its library yardstick is the
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
# phase 12: C-PML, the Green's-function check, curvilinear, LF eigenmodes
CPML_WIDTH = 0.15
CPML_MAX_REL = 1e-4
CPML_ABSORPTION = 0.01  # residual with profiles / without, at most
GREENS_SRC = (0.515, 0.505, 0.525)  # tests/test_greens.py
GREENS_REC = ((0.745, 0.615, 0.575), (0.305, 0.365, 0.665),
              (0.635, 0.655, 0.285))
GREENS_MAX_V, GREENS_MAX_P, GREENS_MIN_CORR = 0.12, 0.18, 0.995
CURVI_MAX_GROWTH = 50.0  # tests/test_curvilinear.py:145
# LF4 spatial orders, tests/test_eigenmode.py:51 and :124
LF_MIN_ORDER_2D = {1: 1.4, 2: 2.8, 3: 3.0}
LF_MIN_ORDER_3D = {1: 1.3, 2: 2.8, 3: 3.4, 4: 4.2}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peaks
FP32_FLOPS_PER_S = 67e12
KERNELS = {  # name -> (source, replaced TPU kernel); all but K10 are the
    # tile kernels of the two tile headers
    "merged_vel": ("seigen_tpu_torch/csrc/merged_tile.cuh",
                   "seigen_tpu/ops/merged_kernels.py:542"),
    "merged_stress": ("seigen_tpu_torch/csrc/merged_tile.cuh",
                      "seigen_tpu/ops/merged_kernels.py:582"),
    "upwind_rhs": ("seigen_tpu_torch/csrc/upwind_tile.cuh",
                   "seigen_tpu/ops/upwind_kernels.py:231"),
    "lane_vel": ("seigen_tpu_torch/csrc/merged_tile.cuh",
                 "seigen_tpu/ops/pallas_kernels.py:942"),
    "lane_stress": ("seigen_tpu_torch/csrc/merged_tile.cuh",
                    "seigen_tpu/ops/pallas_kernels.py:982"),
    "lane_upwind_rhs": ("seigen_tpu_torch/csrc/upwind_tile.cuh",
                        "seigen_tpu/ops/pallas_kernels.py:848"),
    "lane_upwind_axpy": ("seigen_tpu_torch/csrc/upwind_tile.cuh",
                         "seigen_tpu/ops/pallas_kernels.py:791"),
    "fused_vel2": ("seigen_tpu_torch/csrc/merged_tile.cuh",
                   "seigen_tpu/ops/fused_kernels.py:718"),
    "fused_stress2": ("seigen_tpu_torch/csrc/merged_tile.cuh",
                      "seigen_tpu/ops/fused_kernels.py:759"),
    "trace_exchange": ("seigen_tpu_torch/csrc/trace_exchange.cu",
                       "seigen_tpu/solver/lane_fused.py:247"),
    "p1_pack_vel": ("seigen_tpu_torch/csrc/merged_tile.cuh",
                    "seigen_tpu/bench/p1_pack_probe.py:176"),
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
PACKED_MODES = {  # packed P1 instantiation -> (kernel, replaced TPU kernel)
    "merged_vel[pk]": ("merged_vel", "seigen_tpu/ops/merged_kernels.py:542"),
    "merged_stress[pk]": ("merged_stress",
                          "seigen_tpu/ops/merged_kernels.py:582"),
    "fused_vel2[pk]": ("fused_vel2", "seigen_tpu/ops/fused_kernels.py:718"),
    "fused_stress2[pk]": ("fused_stress2",
                          "seigen_tpu/ops/fused_kernels.py:759"),
}
# the launches_pk counts
PK_COUNTS = ("merged_vel_pk", "merged_stress_pk", "fused_vel2_pk",
             "fused_stress2_pk")
# (dim, degree) of the eight element shapes of the tile kernels
SHAPES = ((3, 1), (3, 2), (3, 3), (3, 4), (2, 1), (2, 2), (2, 3), (2, 4))
# the tile kernels' instantiations: label -> (library, mangled name prefix,
# template arguments after the shape)
TILE_PTXAS = {
    "merged_vel": ("merged", "merged_tile_kernel", "Lb1ELb0ELb0EE"),
    "merged_stress": ("merged", "merged_tile_kernel", "Lb0ELb0ELb0EE"),
    "merged_stress[C]": ("merged", "merged_tile_kernel", "Lb0ELb1ELb0EE"),
    "fused_vel2": ("merged", "merged_tile_kernel", "Lb1ELb0ELb1EE"),
    "fused_stress2": ("merged", "merged_tile_kernel", "Lb0ELb0ELb1EE"),
    "fused_stress2[C]": ("merged", "merged_tile_kernel", "Lb0ELb1ELb1EE"),
    "lane_vel": ("lane", "lane_vel_tile_kernel", "Lb0EE"),  # TRAC, SEL
    "lane_vel[SIG]": ("lane", "lane_vel_tile_kernel", "Lb1EE"),
    "lane_stress": ("lane", "lane_stress_tile_kernel", "Lb0EE"),
    "lane_stress[C]": ("lane", "lane_stress_tile_kernel", "Lb1EE"),
    "upwind_rhs": ("upwind", "upwind_tile_kernel", "EE"),
    "lane_upwind_rhs": ("lane_upwind", "lane_upwind_tile_kernel", "Lb0EE"),
    "lane_upwind_axpy": ("lane_upwind", "lane_upwind_tile_kernel", "Lb1EE"),
}
# K1pk, K2pk, K8pk (and K11) and K9pk, the packed tile instantiations
# merged_tile_pk_kernel<DIM, NP, NFP, VEL, V2> (library, mangled name
# prefix) at 2D and 3D P1
PACKED_TILE_PTXAS = {
    f"{label} {dim}D P1": (
        "merged", f"merged_tile_pk_kernelILi{dim}ELi{dim + 1}ELi{dim}E{rest}")
    for label, rest in (("merged_vel[pk]", "Lb1ELb0EE"),
                        ("merged_stress[pk]", "Lb0ELb0EE"),
                        ("fused_vel2[pk]", "Lb1ELb1EE"),
                        ("fused_stress2[pk]", "Lb0ELb1EE"))
    for dim in (2, 3)}


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


def small_merged_runner(dim, degree, device, stiffness_seed=None):
    """A kernel MergedLaneRunner on a free-top, sponge-damped
    box_mesh(5, 3, 4) (3D, 60 lanes per class) or rect_mesh(14, 10) (2D,
    35 lanes per class); with ``stiffness_seed`` a per-element random
    stiffness (the general Hooke law)."""
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask
    from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner

    topo = box_mesh(5, 3, 4) if dim == 3 else rect_mesh(14, 10)
    dm = build_discrete(topo, degree, bc_fn=absorbing_bc_fn(
        ((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")]))
    p = build_params(dm, Material(1.0, 2.0, 1.0), dtype=torch.float32,
                     device=device)
    damp = torch.as_tensor(sponge_mask(dm, [(0, "lo"), (0, "hi")],
                                       width=0.3), device=device).float()
    C = (None if stiffness_seed is None else
         random_stiffness(dm.num_elements, p.n_sig, stiffness_seed))
    return MergedLaneRunner(p, detect_structured(dm), 0.01, damp=damp,
                            impl="kernel", stiffness=C)


def shape_nodes(dim, degree):
    """(n_p, n_fp) of the P``degree`` triangle or tetrahedron."""
    k = degree
    if dim == 2:
        return (k + 1) * (k + 2) // 2, k + 1
    return (k + 1) * (k + 2) * (k + 3) // 6, (k + 1) * (k + 2) // 2


def ptxas_entries(lib):
    """{mangled entry: (registers, stack frame, spill store, spill load
    bytes)} of a library's ptxas report."""
    from seigen_tpu_torch.bench.ptxas_ab import report_entries

    return {k: tuple(v)
            for k, v in report_entries(lib.ptxas_report()).items()}


def ptxas_entry(entries, key):
    hits = [v for k, v in entries.items() if key in k]
    if len(hits) != 1:
        raise AssertionError(f"ptxas: {len(hits)} entries match {key}")
    return hits[0]


def check_ptxas():
    """Phase 2: a line for each tile instantiation of K1/K2/K8/K9, K3,
    K4/K5 and K6/K7 and of K1pk/K2pk/K8pk/K9pk, which must keep no local
    memory (0 B stack frame, no spills)."""
    from seigen_tpu_torch.ops import lane_kernels as lk
    from seigen_tpu_torch.ops import lane_upwind_kernels as luk
    from seigen_tpu_torch.ops import merged_kernels as mk
    from seigen_tpu_torch.ops import upwind_kernels as uk

    entries = {name: ptxas_entries(lib) for name, lib in (
        ("merged", mk.LIBRARY), ("upwind", uk.LIBRARY), ("lane", lk.LIBRARY),
        ("lane_upwind", luk.LIBRARY))}

    def tile_line(label, lib, key):
        regs, stack, st, ld = ptxas_entry(entries[lib], key)
        log(f"[build] tile {label}: {regs} registers, {stack} B stack frame, "
            f"{st} B spill stores, {ld} B spill loads")
        if (stack, st, ld) != (0, 0, 0):
            raise AssertionError(f"ptxas tile {label}: local memory")

    for dim, degree in SHAPES:
        n_p, n_fp = shape_nodes(dim, degree)
        for label, (lib, kernel, rest) in TILE_PTXAS.items():
            tile_line(f"{label} {dim}D P{degree}", lib,
                      f"{kernel}ILi{dim}ELi{n_p}ELi{n_fp}E{rest}")
    for label, (lib, key) in PACKED_TILE_PTXAS.items():
        tile_line(label, lib, key)


def variant_inputs(runner, seed):
    """numpy-seeded float32 operands in the runner's lane layout (packed:
    the live rows of each parity block)."""
    import numpy as np
    import torch

    d, plan = runner.d, runner.plan
    rng = np.random.default_rng(seed)

    def field(C, used, rows):
        a = rng.standard_normal((C, d.n_par, rows // d.n_par, plan.Ls)
                                ).astype(np.float32)
        a[:, :, used:] = 0.0
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
            ("vel", "inject2"), ("stress", "plain"), ("stress", "axpy"),
            ("stress", "axpy_damp"), ("stress", "inject1"),
            ("stress", "inject2"))


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
        kname = ("merged_vel" if op == "vel" else "merged_stress") + (
            "[pk]" if runner.d.n_par == 2 else "")
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


def bound_rows(d, plan, kname, aniso=False, variant="plain"):
    """Float rows per lane that one launch must move: the live rows of its
    input (n_p per component), the neighbour payload rows, the
    geo/impedance/mask rows the operator reads, each per element (n_par of
    them a lane), and the variant's own operands — the axpy rows ax0 and
    ax1 (C_out x n_p live rows each), the damping rows (n_p) and the dense
    source rows (C_out x n_p a group) — plus the full output and trace
    arrays written.  aniso: K2 reads the n_sig^2 stiffness rows instead of
    lambda and mu."""
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
    extra = 0
    if variant.startswith("axpy"):
        extra += 2 * c_out * n_p + (n_p if variant == "axpy_damp" else 0)
    elif variant.startswith("inject"):
        extra += int(variant[-1]) * c_out * n_p
    return d.n_par * (c_in * n_p + plan.pay * nft + geo + nf + extra) \
        + c_out * npp + nf * plan.rtf


def bound(d, plan, kname, aniso=False, variant="plain"):
    """(bound_ms, "bytes" | "operations") of one launch of a kernel
    variant at these shapes: the bytes of ``bound_rows`` over the memory
    rate, and the Dr and LIFT matrix-product FLOPs of every element over
    the FP32 rate."""
    dim, n_p, nft = d.dim, d.n_p, d.nf * d.n_fp
    c_out = {"merged_vel": dim, "merged_stress": d.n_sig}.get(
        kname, dim + d.n_sig)
    rows = bound_rows(d, plan, kname, aniso, variant)
    flops = 2 * d.n_par * (c_out * dim * n_p * n_p + c_out * n_p * nft)
    t_bytes = 4.0 * rows * plan.Ls / HBM_BYTES_PER_S * 1e3
    t_ops = float(flops) * plan.Ls / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def small_upwind_runner(dim, degree, device, acoustic):
    """K3 runner on a free-top box_mesh(5, 3, 4) (3D, 60 lanes per class)
    or rect_mesh(14, 10) (2D, 35): the bench material, or vs = 0 where
    x < 0.5 (the acoustic guard of the Riemann states)."""
    import numpy as np

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params, \
        build_upwind_data
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn
    from seigen_tpu_torch.solver.lane_upwind import UpwindLaneRunner

    topo = box_mesh(5, 3, 4) if dim == 3 else rect_mesh(14, 10)
    dm = build_discrete(topo, degree, bc_fn=absorbing_bc_fn(
        ((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")]))
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
    from seigen_tpu_torch.bench import p1_pack_probe as probe
    from seigen_tpu_torch.solver import lane_fused as lf

    return {"merged_vel": mk.VEL_KERNEL, "merged_stress": mk.STRESS_KERNEL,
            "upwind_rhs": uk.UPWIND_KERNEL, "lane_vel": lk.LANE_VEL,
            "lane_stress": lk.LANE_STRESS,
            "lane_upwind_rhs": luk.LANE_UPWIND_RHS,
            "lane_upwind_axpy": luk.LANE_UPWIND_AXPY,
            "fused_vel2": fo.VEL2_KERNEL, "fused_stress2": fo.STRESS2_KERNEL,
            "trace_exchange": lf.TRACE_EXCHANGE,
            "p1_pack_vel": probe.PACK_VEL_KERNEL}


def reset_counts():
    for k in all_kernels().values():
        k.launches = 0
        for sub in ("launches_c", "launches_pk"):
            if hasattr(k, sub):
                setattr(k, sub, 0)


def read_counts():
    """Launches per kernel, under C_COUNTS those of K2, K5 and K9 that ran
    the general Hooke law, and under PK_COUNTS those of K1, K2, K8 and K9
    that ran the packed P1 layout."""
    kernels = all_kernels()
    counts = {name: k.launches for name, k in kernels.items()}
    for name in C_COUNTS:
        counts[name] = kernels[name[:-2]].launches_c
    for name in PK_COUNTS:
        counts[name] = kernels[name[:-3]].launches_pk
    return counts


def expect_counts(tag, counts, **nonzero):
    """Fail unless the kernels (and general-law and packed counts) of
    ``nonzero`` launched exactly that often and every other one not at
    all."""
    expect = {name: nonzero.get(name, 0)
              for name in (*KERNELS, *C_COUNTS, *PK_COUNTS)}
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
    for dim, degree in SHAPES:
        small = small_upwind_runner(dim, degree, dev, acoustic=False)
        log(f"[upwind] {dim}D P{degree}: NC {small.plan.NC}, Ls "
            f"{small.plan.Ls}, rtf {small.plan.rtf}")
        compare_upwind(small, check, f"{dim}D P{degree}",
                       seed=10 * dim + degree, variants=variants)
        compare_upwind(small_upwind_runner(dim, degree, dev, acoustic=True),
                       check, f"{dim}D P{degree} acoustic",
                       seed=20 * dim + degree, variants=("plain0",))
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
    for variant in variants:  # each variant's time beside its own bound
        inj = x["inj"][: int(variant[-1])]
        t = time_ms(lambda: uk.UPWIND_KERNEL(*args, inject=inj))
        b = bound(run_k.d, run_k.plan, "upwind_rhs",
                  variant="plain" if variant == "plain0" else variant)
        line = (f"[upwind] upwind_rhs ({variant}) at n=24 P3: kernel "
                f"{t:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
                f"{100 * b[0] / t:.1f}% of the bound")
        if variant == "plain0":
            times = (t, time_ms(lambda: uk.upwind_rhs_merged_ref(*args)))
            bnd = b
            line += f"; plain {times[1]:.4f} ms"
        log(line)
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


def small_topology(dim, ragged):
    """box_mesh(4, 4, 4) or rect_mesh(8, 8), or with ``ragged`` phase 3's
    box_mesh(5, 3, 4) or rect_mesh(14, 10)."""
    from seigen_tpu_torch.mesh import box_mesh, rect_mesh

    if ragged:
        return box_mesh(5, 3, 4) if dim == 3 else rect_mesh(14, 10)
    return box_mesh(4, 4, 4) if dim == 3 else rect_mesh(8, 8)


LANE_MODES = {  # mode -> (kernel name, lane_kernels mode constant name)
    "SIG": ("lane_vel", "VEL_SIG"), "TRAC": ("lane_vel", "VEL_TRAC"),
    "SEL vel": ("lane_vel", "VEL_SEL"), "TR": ("lane_stress", "STRESS_TR"),
    "SEL stress": ("lane_stress", "STRESS_SEL")}


def small_lane_runners(dim, degree, dev, ragged=False):
    """(LaneMajorRunner, UnstructuredLaneRunner on a scrambled copy) kernel
    runners on a free-top box_mesh(4, 4, 4) (3D) or rect_mesh(8, 8) (2D),
    or with ``ragged`` on phase 3's meshes."""
    import dataclasses

    import numpy as np

    from seigen_tpu_torch.mesh import build_discrete
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn
    from seigen_tpu_torch.solver.lane_major import LaneMajorRunner
    from seigen_tpu_torch.solver.lane_unstructured import \
        UnstructuredLaneRunner

    topo = small_topology(dim, ragged)
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
    for dim, degree in SHAPES:  # the tile kernels: ragged last tiles
        lane, lane_u = small_lane_runners(dim, degree, dev, ragged=True)
        tag = f"{dim}D P{degree} ragged"
        compare_lane(lane, check, tag, 130 + 10 * dim + degree,
                     ("SIG", "TRAC", "TR"))
        compare_lane(lane_u, check, f"{tag} scrambled",
                     150 + 10 * dim + degree, tuple(LANE_MODES))
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


def small_upwind_u_runner(dim, degree, dev, acoustic=False, small=False):
    """K6/K7 runner with a sponge on a scrambled free-top box_mesh(5, 3, 4)
    (3D) or rect_mesh(14, 10) (2D), or with ``small`` box_mesh(4, 4, 4) or
    rect_mesh(8, 8): the bench material, or vs = 0 where x < 0.5."""
    import dataclasses

    import numpy as np

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params, \
        build_upwind_data
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask
    from seigen_tpu_torch.solver.lane_upwind_u import \
        UnstructuredUpwindRunner

    if small:
        topo = box_mesh(4, 4, 4) if dim == 3 else rect_mesh(8, 8)
    else:
        topo = box_mesh(5, 3, 4) if dim == 3 else rect_mesh(14, 10)
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


def upwind_u_rows(d, mode):
    """Float rows per lane that one launch of K6 or a K7 mode must move:
    u and sigma, and for K7 the accumulator, the base state, the sponge
    row and the dense patterns the mode reads, at n_p rows per component;
    the selected rows of both panels; the geometry counted per face as in
    ``lane_bound`` — Ginv, normals, Fscale, the neighbour impedances, the
    combo and both sign rows — and the material and own-impedance rows;
    the output, with the emitted panels, as written."""
    dim, n_p, ftp, npp, nf = d.dim, d.n_p, d.ftp, d.npp, d.nf
    c = dim + d.n_sig
    spec = UPWIND_U_MODES[mode] or (False, False, 0, False)
    stage, damp, n_inj, emit = spec
    axpy = UPWIND_U_MODES[mode] is not None
    state_in = c * n_p * (1 + axpy + stage + n_inj) + (n_p if damp else 0)
    geo = dim * dim + dim * nf + nf + 3 + 2 * nf + 2 + 3 * nf
    out = c * npp * (2 if stage else 1) + (2 * dim * d.ftpp if emit else 0)
    return state_in + 2 * dim * ftp + geo + out


def upwind_u_bound(d, mode):
    """(bound_ms, "bytes" | "operations") of one launch of K6 or a K7
    mode: the bytes of ``upwind_u_rows`` over the memory rate, and the Dr
    and LIFT FLOPs over the FP32 rate."""
    dim, n_p, ftp = d.dim, d.n_p, d.ftp
    c = dim + d.n_sig
    rows = upwind_u_rows(d, mode)
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
    for dim, degree, acoustic, small_mesh in (
            *((dim, degree, False, False) for dim, degree in SHAPES),
            (2, 2, False, True), (3, 2, True, True)):
        small = small_upwind_u_runner(dim, degree, dev, acoustic, small_mesh)
        tag = (f"{dim}D P{degree}" + (" small" if small_mesh else "")
               + (" acoustic" if acoustic else ""))
        log(f"[upwind_u] {tag}: E {small.E}, ftp {small.d.ftp}, ftpp "
            f"{small.d.ftpp}, {len(small.selcfg[7])} orientation groups")
        compare_upwind_u(small, check, tag,
                         60 + 10 * dim + degree + 5 * small_mesh)
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
            f"ms, plain {t[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]}, "
            f"{upwind_u_rows(run_k.d, mode)} rows a lane), "
            f"{100 * b[0] / t[0]:.1f}% of the bound")
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


def small_aniso_runners(dim, degree, dev, ragged=False):
    """Kernel runners with a per-element random stiffness on a free-top
    box_mesh(4, 4, 4) (3D) or rect_mesh(8, 8) (2D), or with ``ragged`` on
    phase 3's meshes: (UnstructuredLaneRunner on the mesh,
    UnstructuredLaneRunner on a scrambled copy)."""
    import numpy as np

    from seigen_tpu_torch.mesh import build_discrete
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn
    from seigen_tpu_torch.solver.lane_unstructured import \
        UnstructuredLaneRunner

    topo = small_topology(dim, ragged)
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
    for dim, degree in SHAPES:
        merged = small_merged_runner(dim, degree, dev, stiffness_seed=90)
        tag = f"{dim}D P{degree}"
        log(f"[aniso] {tag}: NC {merged.plan.NC}, C section at geo row "
            f"{merged.d.off[6]} of {merged.d.off[7]}")
        compare_merged_aniso(merged, check, tag, 80 + 10 * dim + degree)
    for dim, degree in ((3, 3), (3, 2), (2, 2)):
        lane_u, lane_us = small_aniso_runners(dim, degree, dev)
        tag = f"{dim}D P{degree}"
        log(f"[aniso] {tag}: E {lane_u.E}")
        compare_lane_aniso(lane_u, check, tag, 82 + degree)
        compare_lane_aniso(lane_us, check, f"{tag} scrambled", 84 + degree)
    for dim, degree in SHAPES:  # K5-C's tile kernel: ragged last tiles
        lane_u, lane_us = small_aniso_runners(dim, degree, dev, ragged=True)
        tag = f"{dim}D P{degree} ragged"
        compare_lane_aniso(lane_u, check, tag, 160 + 10 * dim + degree)
        compare_lane_aniso(lane_us, check, f"{tag} scrambled",
                           180 + 10 * dim + degree)
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
    kern, plain, args, kw = variant_call(run_k, x, "stress", "axpy_damp")
    t = time_ms(lambda: kern(*args, **kw))
    b = bound(run_k.d, run_k.plan, "merged_stress", aniso=True,
              variant="axpy_damp")
    log(f"[aniso] merged_stress[C] (axpy_damp) at n={n} P3: kernel {t:.4f} "
        f"ms, bound {b[0]:.4f} ms ({b[1]}), {100 * b[0] / t:.1f}% of the "
        "bound")
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


def small_fused_runners(dim, degree, dev, ragged=False):
    """Kernel FusedLaneRunners on a free-top, sponge-damped box_mesh(4, 4,
    4) (3D) or rect_mesh(8, 8) (2D), or with ``ragged`` on phase 3's
    box_mesh(5, 3, 4) or rect_mesh(14, 10): isotropic, with a per-element
    random stiffness, and (not ragged) on the periodic twin of the mesh."""
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask
    from seigen_tpu_torch.solver.lane_fused import FusedLaneRunner

    if ragged:
        topo, per = (box_mesh(5, 3, 4) if dim == 3 else rect_mesh(14, 10),
                     None)
    else:
        topo, per = ((box_mesh(4, 4, 4),
                      box_mesh(4, 4, 4, periodic=(0, 1, 2)))
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
    twin = None
    if per is not None:
        dm_per = build_discrete(per, degree)
        twin = FusedLaneRunner(build_params(dm_per, mat, device=dev),
                               detect_structured(dm_per), 0.01,
                               impl="kernel")
    return (FusedLaneRunner(p, ex, 0.01, damp=damp, impl="kernel"),
            FusedLaneRunner(p, ex, 0.01, damp=damp, impl="kernel",
                            stiffness=C), twin)


def fused_inputs(d, dev, seed):
    """numpy-seeded float32 K8/K9/K10 operands in the v2 lane layout
    (packed: state rows live in each parity block)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lanes = d.E // d.n_par

    def rows(C, used, pad, blocks=1):
        a = rng.standard_normal((C, blocks, pad // blocks, lanes)
                                ).astype(np.float32)
        a[:, :, used:] = 0.0
        return torch.as_tensor(a.reshape(C * pad, lanes), device=dev)

    return {"sig": [rows(d.n_sig, d.n_p, d.npp, d.n_par) for _ in range(3)],
            "u": [rows(d.dim, d.n_p, d.npp, d.n_par) for _ in range(3)],
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


def fused_rows(d, kname, aniso=False, variant="plain"):
    """Float rows per lane that one launch of a K8/K9 variant or of K10
    must move.  K8/K9: state rows n_p per component, the dim*ftp consumer
    trace rows, the geometry once per face (Ginv, normals, scb, bfs or dfs)
    and the material rows (1/rho; lambda and mu, or the n_sig^2 stiffness
    rows), and the variant's own axpy rows (2 x C_out x n_p) and sponge
    row (n_p), each per element (n_par of them a lane); the output at npp
    and its dim*ftpp trace rows written.  K10: dim*ftp rows and nf mask
    rows read, dim*ftpp rows written."""
    dim, n_p, nf, npp, n_sig = d.dim, d.n_p, d.nf, d.npp, d.n_sig
    ftp, ftpp = d.ftp // d.n_par, d.ftpp
    if kname == "trace_exchange":
        return dim * ftp + nf + dim * ftpp
    geo = dim * dim + dim * nf + 2 * nf
    if kname == "fused_vel2":
        c_in, c_out, geo = n_sig, dim, geo + 1
    else:
        c_in, c_out = dim, n_sig
        geo += n_sig * n_sig if aniso else 2
    extra = 0
    if variant.startswith("axpy"):
        extra = 2 * c_out * n_p + (n_p if variant == "axpy_damp" else 0)
    return d.n_par * (c_in * n_p + dim * ftp + geo + extra) + c_out * npp \
        + dim * ftpp


def fused_bound(d, kname, aniso=False, variant="plain"):
    """(bound_ms, "bytes" | "operations") of one launch of a K8/K9 variant
    or of K10 at these shapes: the bytes of ``fused_rows`` over the memory
    rate, and the Dr and LIFT FLOPs over the FP32 rate (K10 does no
    arithmetic)."""
    dim, n_p, n_par = d.dim, d.n_p, d.n_par
    ftp = d.ftp // n_par
    rows = fused_rows(d, kname, aniso, variant)
    flops = 0
    if kname != "trace_exchange":
        c_out = dim if kname == "fused_vel2" else d.n_sig
        flops = 2 * n_par * (c_out * dim * n_p * n_p + c_out * n_p * ftp)
    lanes = d.E // n_par
    t_bytes = 4.0 * rows * lanes / HBM_BYTES_PER_S * 1e3
    t_ops = float(flops) * lanes / FP32_FLOPS_PER_S * 1e3
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
    for dim, degree in SHAPES:
        iso, aniso, _ = small_fused_runners(dim, degree, dev, ragged=True)
        tag = f"{dim}D P{degree} ragged"
        log(f"[fused] {tag}: E {iso.d.E}, ftp {iso.d.ftp}, ftpp "
            f"{iso.d.ftpp}")
        compare_fused(iso, aniso, check, tag, 160 + 10 * dim + degree)
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

    # every K8/K9 variant and K10 at n=24 P3: check, kernel time beside the
    # variant's own bound, plain times of the plain variants
    times, bounds, library = {}, {}, {}
    run_k = keep["fused"]
    x = fused_inputs(run_k.d, dev, 150)
    for name, runner in (("fused_vel2", run_k), ("fused_stress2", run_k),
                         ("fused_stress2[C]", keep["fused_stress2[C]"])):
        kname, aniso = name.removesuffix("[C]"), name.endswith("[C]")
        for op, variant in FUSED_VARIANTS[name]:
            kern, plain = fused_call(runner, x, op, variant)
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            check(name, f"n={n} P3 {name} {variant} out", got[0], ref[0])
            check(name, f"n={n} P3 {name} {variant} traces", got[1], ref[1])
            del got, ref
            t = time_ms(kern)
            b = fused_bound(runner.d, kname, aniso, variant)
            rows = fused_rows(runner.d, kname, aniso, variant)
            line = (f"[fused] {name} ({variant}) at n={n} P3: kernel "
                    f"{t:.4f} ms, bound {b[0]:.4f} ms ({b[1]}, {rows} rows "
                    f"a lane), {100 * b[0] / t:.1f}% of the bound")
            if variant == "plain":
                times[name], bounds[name] = (t, time_ms(plain)), b
                line += f"; plain {times[name][1]:.4f} ms"
            log(line)
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


def packed_ptxas_lines():
    """ptxas's lines of the packed instantiations (the packed tile
    kernel)."""
    from seigen_tpu_torch.ops import merged_kernels as mk

    out, keep = [], False
    for ln in mk.LIBRARY.ptxas_report().splitlines():
        if "Compiling" in ln:
            keep = "merged_tile_pk_kernel" in ln
        if keep:
            out.append(ln.strip())
    return out


def small_packed_runner(dim, dev):
    """A packed kernel MergedLaneRunner on a free-top, sponge-damped
    box_mesh(4, 4, 4) (3D) or rect_mesh(8, 8) (2D) at P1, with a density
    drawn per element (uniform in [1, 1.5), numpy-seeded), so that the two
    parities of a lane read different 1/rho rows."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask
    from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner

    topo = box_mesh(4, 4, 4) if dim == 3 else rect_mesh(8, 8)
    dm = build_discrete(topo, 1, bc_fn=absorbing_bc_fn(
        ((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")]))
    rho = np.random.default_rng(240 + dim).uniform(1.0, 1.5,
                                                    dm.num_elements)
    p = build_params(dm, Material(rho, 2.0, 1.0), device=dev)
    damp = torch.as_tensor(sponge_mask(dm, [(0, "lo"), (0, "hi")],
                                       width=0.3), device=dev).float()
    return p, MergedLaneRunner(p, detect_structured(dm), 0.01, damp=damp,
                               impl="kernel", packed=True)


def probe_inputs(p, seed):
    """numpy-seeded float32 sigma and traces of the P1 pack probe's layout
    (pairs (2j, 2j+1)) on p's device."""
    import numpy as np
    import torch

    from seigen_tpu_torch.bench import p1_pack_probe as probe

    E = p.Ginv.shape[0]
    rng = np.random.default_rng(seed)
    sig = rng.standard_normal((E, 4, 6)).astype(np.float32)
    trc = rng.standard_normal((E, 3, 12)).astype(np.float32)
    return (torch.as_tensor(probe.pack_state(sig, 4), device=p.device),
            torch.as_tensor(probe.pack_traces(trc), device=p.device))


def phase_packed(dev, check, n=32):
    """Phase 11 (see the module docstring).  Returns ({kernel: launches on
    its main-path run}, {kernel: (kernel ms, plain ms)}, {kernel:
    bound})."""
    import numpy as np
    import torch

    from seigen_tpu_torch.bench import p1_pack_probe as probe
    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner
    from seigen_tpu_torch.solver.timestep import State

    lines = packed_ptxas_lines()
    for ln in lines:
        log(f"  ptxas [pk]: {ln}")
    log(f"[packed] ptxas: {sum('Compiling' in ln for ln in lines)} packed "
        "instantiations")

    t0 = time.perf_counter()
    for dim in (3, 2):
        p, runner = small_packed_runner(dim, dev)
        tag = f"{dim}D P1 [pk]"
        log(f"[packed] {tag}: Ls {runner.plan.Ls}, rtq {runner.plan.rtq}, "
            f"rtf {runner.plan.rtf}, ftpp {runner.d.ftpp}")
        compare_variants(runner, check, tag, seed=200 + dim)
        x = fused_inputs(runner.d, dev, 210 + dim)
        for name in ("fused_vel2", "fused_stress2"):
            for op, variant in FUSED_VARIANTS[name]:
                kern, plain = fused_call(runner, x, op, variant)
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                check(f"{name}[pk]", f"{tag} {name} {variant} out", got[0],
                      ref[0])
                check(f"{name}[pk]", f"{tag} {name} {variant} traces",
                      got[1], ref[1])
        if dim == 3:
            d_pr = probe.build_packed_vel_data(p)
            sig_p, tr_p = probe_inputs(p, 220)
            got = probe.PACK_VEL_KERNEL(d_pr, sig_p, tr_p)
            ref = probe.packed_vel_op_ref(d_pr, sig_p, tr_p)
            torch.cuda.synchronize()
            check("p1_pack_vel", f"{tag} p1_pack_vel out", got[0], ref[0])
            check("p1_pack_vel", f"{tag} p1_pack_vel traces", got[1],
                  ref[1])
    log(f"[packed] all small-mesh variants agree "
        f"({time.perf_counter() - t0:.1f} s)")

    # the packed LF4 path at the P1 case's full width
    t1 = time.perf_counter()
    case = throughput.setup_case(n=n, degree=1, device=dev)
    dm, p, src, damp, dt, _ = case
    E, n_p = dm.num_elements, dm.re.n_p
    rng = np.random.default_rng(7)
    st = State(
        u=torch.as_tensor(rng.standard_normal((E, n_p, 3)), device=dev
                          ).float(),
        s=torch.as_tensor(rng.standard_normal((E, n_p, 6)), device=dev
                          ).float())
    ex = detect_structured(dm)
    run_k, run_r, run_u = (
        MergedLaneRunner(p, ex, dt, src=src, damp=damp, impl=impl,
                         packed=packed)
        for impl, packed in (("kernel", True), ("reference", True),
                             ("kernel", False)))
    log(f"[packed] n={n} P1: E {E}, Ls {run_k.plan.Ls} (unpacked "
        f"{run_u.plan.Ls}), dense source groups {len(run_k.src_dense)}; "
        f"setup {time.perf_counter() - t1:.1f} s")
    S = RUNNER_STEPS
    reset_counts()
    out_k, _ = run_k.run(st, S)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[packed] {S} steps: launches {counts}")
    expect_counts("packed LF4 path", counts, merged_vel=3 * S,
                  merged_stress=3 * S, merged_vel_pk=3 * S,
                  merged_stress_pk=3 * S)
    launches = {"merged_vel[pk]": counts["merged_vel_pk"],
                "merged_stress[pk]": counts["merged_stress_pk"]}
    out_r, _ = run_r.run(st, S)
    out_u, _ = run_u.run(st, S)
    torch.cuda.synchronize()
    compare_states("packed", out_k, out_r)
    compare_states("packed", out_k, out_u, "packed vs unpacked kernel")
    del out_k, out_r, out_u, run_r

    # every K1/K2 variant at these shapes; kernel, plain and bound of each
    # packed kernel, the unpacked K1/K2 on the same case beside them
    times, bounds = {}, {}
    x = compare_variants(run_k, check, f"n={n} P1 [pk]", seed=230)
    xu = variant_inputs(run_u, 231)
    for op in ("vel", "stress"):
        kname = "merged_vel" if op == "vel" else "merged_stress"
        for runner, xx, label in ((run_k, x, f"{kname}[pk]"),
                                  (run_u, xu, kname)):
            kern, plain, args, kw = variant_call(runner, xx, op, "plain")
            t = (time_ms(lambda: kern(*args, **kw)),
                 time_ms(lambda: plain(*args, **kw)))
            b = bound(runner.d, runner.plan, kname)
            log(f"[packed] {label} at n={n} P1: kernel {t[0]:.4f} ms, plain "
                f"{t[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
            if runner is run_k:
                times[label], bounds[label] = t, b
    for op, variant in (("vel", "axpy"), ("stress", "axpy_damp")):
        kname = "merged_vel" if op == "vel" else "merged_stress"
        kern, _, args, kw = variant_call(run_k, x, op, variant)
        t = time_ms(lambda: kern(*args, **kw))
        b = bound(run_k.d, run_k.plan, kname, variant=variant)
        log(f"[packed] {kname}[pk] ({variant}) at n={n} P1: kernel {t:.4f} "
            f"ms, bound {b[0]:.4f} ms ({b[1]}), {100 * b[0] / t:.1f}% of the "
            "bound")
    del x, xu, run_u, args, kw
    xf = fused_inputs(run_k.d, dev, 232)
    for name, op, variant in (("fused_vel2", "vel", "axpy"),
                              ("fused_stress2", "stress", "axpy_damp")):
        kern, _ = fused_call(run_k, xf, op, variant)
        t = time_ms(kern)
        b = fused_bound(run_k.d, name, variant=variant)
        log(f"[packed] {name}[pk] ({variant}) at n={n} P1: kernel {t:.4f} "
            f"ms, bound {b[0]:.4f} ms ({b[1]}), {100 * b[0] / t:.1f}% of the "
            "bound")
    for name in ("fused_vel2", "fused_stress2"):
        kern, plain = fused_call(run_k, xf, *FUSED_VARIANTS[name][0])
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        check(f"{name}[pk]", f"n={n} P1 {name}[pk] plain out", got[0],
              ref[0])
        check(f"{name}[pk]", f"n={n} P1 {name}[pk] plain traces", got[1],
              ref[1])
        times[f"{name}[pk]"] = (time_ms(kern), time_ms(plain))
        bounds[f"{name}[pk]"] = fused_bound(run_k.d, name)
    d_pr = probe.build_packed_vel_data(p)
    sig_p, tr_p = probe_inputs(p, 233)
    kern = (lambda: probe.PACK_VEL_KERNEL(d_pr, sig_p, tr_p))
    plain = (lambda: probe.packed_vel_op_ref(d_pr, sig_p, tr_p))
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    check("p1_pack_vel", f"n={n} P1 p1_pack_vel out", got[0], ref[0])
    check("p1_pack_vel", f"n={n} P1 p1_pack_vel traces", got[1], ref[1])
    times["p1_pack_vel"] = (time_ms(kern), time_ms(plain))
    bounds["p1_pack_vel"] = fused_bound(d_pr, "fused_vel2")
    for name in ("fused_vel2[pk]", "fused_stress2[pk]", "p1_pack_vel"):
        t, b = times[name], bounds[name]
        log(f"[packed] {name} at n={n} P1: kernel {t[0]:.4f} ms, plain "
            f"{t[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    del xf, got, ref, kern, plain, sig_p, tr_p, d_pr, run_k

    # the benches: unpacked and packed kernels, packed plain versions
    for impl, kimpl in (("merged", "kernel"), ("merged_pk", "kernel"),
                        ("merged_pk", "reference")):
        reset_counts()
        rec = throughput.main(n=n, degree=1, n_steps=BENCH_STEPS, impl=impl,
                              kernel_impl=kimpl, case=case)
        c = read_counts()
        pk = impl == "merged_pk" and kimpl == "kernel"
        ok = all(c[f"{k}_pk"] == (c[k] if pk else 0) for k in
                 ("merged_vel", "merged_stress"))
        if not (np.isfinite(rec["value"]) and rec["value"] > 0 and ok
                and (c["merged_vel"] > 0) == (kimpl == "kernel")):
            raise AssertionError(f"bench {impl} {kimpl}: rate "
                                 f"{rec['value']}, launches {c}")
        print(json.dumps(rec), flush=True)

    # the pack probe: padded K8 against K11 (and packed K8, K9)
    reset_counts()
    steps = 300
    rec = probe.main(n_steps=steps, p=p)
    counts = read_counts()
    per = 1 + 3 * steps  # warm-up, then best of 3 runs
    expect_counts("pack probe", counts, fused_vel2=2 * per,
                  fused_stress2=2 * per, fused_vel2_pk=per,
                  fused_stress2_pk=per, p1_pack_vel=per)
    launches.update({"fused_vel2[pk]": counts["fused_vel2_pk"],
                     "fused_stress2[pk]": counts["fused_stress2_pk"],
                     "p1_pack_vel": counts["p1_pack_vel"]})
    print(json.dumps(rec), flush=True)
    return launches, times, bounds


def cpml_case(dm, p, dev, seed, n_steps=6):
    """The einsum C-PML run_cpml and the kernel CpmlLaneRunner on one small
    case in float32 (a per-element random material, a mollified source,
    C-PML on every side but the free top, a random state): relative L2 of
    the lane runner's u and s against the einsum's."""
    import numpy as np
    import torch

    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver import CpmlLaneRunner, PointSource, State, \
        build_sources, cfl_dt, cpml_init, cpml_profiles, make_cpml_rhs, \
        run_cpml

    dim = p.dim
    rng = np.random.default_rng(seed)
    E, n_p = dm.num_elements, dm.re.n_p
    sides = [(ax, s) for ax in range(dim) for s in ("lo", "hi")][:-1]
    h = float(dm.h.min())
    dt = cfl_dt(h, 3.0, 2, 0.2)
    src = build_sources(dm, [PointSource(
        position=(0.5,) * (dim - 1) + (0.6,), f0=4.0, t0=0.15,
        amplitude=50.0, radius=2 * h)], device=dev)
    u0, s0 = (torch.as_tensor(0.01 * rng.standard_normal((E, n_p, c)),
                              device=dev).float() for c in (dim, p.n_sig))
    dprof, aprof = cpml_profiles(dm, sides, 0.3, 3.0, f0=4.0)
    ref, _ = run_cpml(p, cpml_init(p, u0, s0), dt, n_steps,
                      make_cpml_rhs(p, dprof, aprof, src=src))
    lr = CpmlLaneRunner(p, dm, detect_structured(dm), dt, sides, 0.3, 3.0,
                        f0=4.0, src=src, impl="kernel")
    out, _ = lr.run(State(u=u0, s=s0), n_steps)
    return [((getattr(out, f) - getattr(ref, f)).norm()
             / getattr(ref, f).norm()).item() for f in ("u", "s")]


def cpml_absorption(dev):
    """The pulse of tests/test_cpml.py:80 in the all-absorbing
    rect_mesh(12, 12) P3, float32, through the kernel lane runner with a
    C-PML of width 0.25 on all four sides and with no profiles (sides
    []): (interior residual energy with, without)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver import CpmlLaneRunner, State, \
        absorbing_bc_fn, cfl_dt

    dm = build_discrete(rect_mesh(12, 12), 3,
                        bc_fn=absorbing_bc_fn([(0.0, 1.0)] * 2, []))
    p = build_params(dm, Material(rho=1.0, vp=2.0, vs=1.0), device=dev)
    E, n_p = dm.num_elements, dm.re.n_p
    co = dm.coords
    r2 = (co[..., 0] - 0.5) ** 2 + (co[..., 1] - 0.5) ** 2
    u0 = np.zeros((E, n_p, 2))
    u0[..., 1] = np.exp(-r2 / 0.01)
    st = State(u=torch.as_tensor(u0, device=dev).float(),
               s=torch.zeros((E, n_p, 3), device=dev))
    n = int(np.ceil(1.0 / cfl_dt(dm.h.min(), 2.0, 3, 0.35)))
    inner = torch.as_tensor(
        (co[..., 0] > 0.3) & (co[..., 0] < 0.7)
        & (co[..., 1] > 0.3) & (co[..., 1] < 0.7), device=dev)
    res = []
    for sides in ([(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi")], []):
        lr = CpmlLaneRunner(p, dm, detect_structured(dm), 1.0 / n, sides,
                            0.25, 2.0, f0=3.0, impl="kernel")
        fin, _ = lr.run(st, n)
        if not bool(torch.isfinite(fin.u).all()):
            raise AssertionError(f"absorption run {sides}: not finite")
        res.append((fin.u[inner] ** 2).sum().item())
    log(f"[cpml] absorption: rect_mesh(12, 12) P3, {n} RK4 steps, "
        f"interior residual {res[0]:.4e} with C-PML, {res[1]:.4e} without, "
        f"ratio {res[0] / res[1]:.3e} (bar {CPML_ABSORPTION})")
    return res[0] / res[1]


def greens_misfits(dev):
    """The main path (MergedLaneRunner, kernels, float32) on the explosion
    of tests/test_greens.py:48 — box_mesh(12, 12, 12) P2, all absorbing,
    a 0.12 sponge — against ExplosionGreens3D at its three receivers
    before the first reflection: [(velocity misfit, pressure misfit)] per
    receiver, the signed correlation at the first, and the launches."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver import ExplosionGreens3D, PointSource, \
        State, absorbing_bc_fn, build_receivers, build_sources, cfl_dt, \
        sponge_mask
    from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner

    n, degree, f0 = 12, 2, 2.0
    mat = Material(rho=1.5, vp=2.0, vs=1.0)
    dm = build_discrete(box_mesh(n, n, n), degree,
                        bc_fn=absorbing_bc_fn(((0.0, 1.0),) * 3, []))
    p = build_params(dm, mat, device=dev)
    t0, radius, amp = 1.2 / f0, 1.0 / n, 3.0
    src = build_sources(dm, [PointSource(
        position=GREENS_SRC, f0=f0, t0=t0, amplitude=amp, radius=radius)],
        device=dev)
    rec = np.array(GREENS_REC)
    rcv = build_receivers(dm, rec, device=dev)
    damp = torch.as_tensor(sponge_mask(
        dm, [(a, s) for a in range(3) for s in ("lo", "hi")], width=0.12),
        device=dev).float()
    dt = cfl_dt(float(dm.h.min()), 2.0, degree, cfl=0.4)
    n_steps = int(np.ceil(1.05 / dt))
    E, n_p = dm.num_elements, dm.re.n_p
    runner = MergedLaneRunner(p, detect_structured(dm), dt, src=src,
                              damp=damp, receivers=rcv, record_pressure=True,
                              impl="kernel")
    st = State(u=torch.zeros((E, n_p, 3), device=dev),
               s=torch.zeros((E, n_p, 6), device=dev))
    reset_counts()
    _, seis = runner.run(st, n_steps)
    torch.cuda.synchronize()
    launches = read_counts()
    ana = ExplosionGreens3D(mat=mat, position=np.array(GREENS_SRC), f0=f0,
                            t0=t0, amplitude=amp, radius=radius)
    tg = (np.arange(n_steps) + 1) * dt
    ref_v, ref_p = ana.velocity(rec, tg), ana.pressure(rec, tg)
    m = tg < 0.95
    mis = [(np.linalg.norm(seis[m, r, :3] - ref_v[m, r])
            / np.linalg.norm(ref_v[m, r]),
            np.linalg.norm(seis[m, r, 3] - ref_p[m, r, 0])
            / np.linalg.norm(ref_p[m, r, 0])) for r in range(len(rec))]
    a0, s0 = ref_v[m, 0].reshape(-1), seis[m, 0, :3].reshape(-1)
    corr = float(a0 @ s0 / (np.linalg.norm(a0) * np.linalg.norm(s0)))
    log(f"[cpml] greens: box_mesh(12, 12, 12) P2, E {E}, {n_steps} LF4 "
        f"steps; misfits (velocity, pressure) "
        + ", ".join(f"({v:.4f}, {q:.4f})" for v, q in mis)
        + f" (bars {GREENS_MAX_V}, {GREENS_MAX_P}); correlation {corr:.5f} "
        f"(bar {GREENS_MIN_CORR})")
    return mis, corr, launches, n_steps


def curvi_growth(dev):
    """Curved LF4 (tests/test_curvilinear.py:145): rect_mesh(8, 8) P2 under
    the test's smooth map, a velocity bump, 300 steps in float64 through
    the timestep.run hooks: (finite, energy ratio end/start)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_curvi, build_params, \
        curved_coords, make_curvi_ops
    from seigen_tpu_torch.solver import State, absorbing_bc_fn, cfl_dt, run

    dm = build_discrete(rect_mesh(8, 8), 2, bc_fn=absorbing_bc_fn(
        ((0, 1), (0, 1)), free_sides=[(1, "hi")]))
    p = build_params(dm, Material(rho=1.3, vp=2.0, vs=1.1),
                     dtype=torch.float64, device=dev)

    def phi(x):
        a, out = 0.03, x.copy()
        out[:, 0] = x[:, 0] + a * np.sin(np.pi * x[:, 0]) * np.sin(
            2 * np.pi * x[:, 1])
        out[:, 1] = x[:, 1] + a * np.sin(2 * np.pi * x[:, 0]) * np.sin(
            np.pi * x[:, 1])
        return out

    X = curved_coords(dm, phi)
    vop, sop = make_curvi_ops(build_curvi(dm, X, dtype=torch.float64,
                                          device=dev))
    x, y = X[..., 0], X[..., 1]
    bump = np.exp(-60.0 * ((x - 0.5) ** 2 + (y - 0.55) ** 2))
    st = State(u=torch.as_tensor(np.stack([bump, 0 * bump], -1), device=dev),
               s=torch.zeros(X.shape[:2] + (3,), dtype=torch.float64,
                             device=dev))
    e0 = (st.u ** 2).sum().item()
    fin, _ = run(p, st, cfl_dt(float(dm.h.min()), 2.0, 2, 0.3), 300,
                 vel_op=vop, stress_op=sop)
    e1 = ((fin.u ** 2).sum() + (fin.s ** 2).sum()).item()
    finite = bool(torch.isfinite(fin.u).all() & torch.isfinite(fin.s).all())
    log(f"[cpml] curvilinear LF4: rect_mesh(8, 8) P2 curved, 300 steps, "
        f"finite {finite}, energy {e1 / e0:.4f} x its start (bar "
        f"{CURVI_MAX_GROWTH})")
    return finite, e1 / e0


def lf_eigen_orders(dev):
    """The LF4 spatial-convergence sweeps of tests/test_eigenmode.py
    through the port's einsum timestep.run in float64 on the card: an S
    plane wave on periodic meshes, 2D P1-P3 over a period (three sizes,
    the least-squares order), 3D P1-P4 over half a period (N = 4, 8);
    fails below the test's bars."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.solver import PlaneWave, State, cfl_dt, \
        convergence_order, interpolate, l2_error, run

    mat = Material(1.0, 2.0, 1.0)
    pw2 = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    pw3 = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0, 0.0]),
                    mode="S", polarization=np.array([0.0, 0.0, 1.0]))
    sweeps = [(2, q, Ns) for q, Ns in ((1, (8, 16, 32)), (2, (4, 8, 16)),
                                       (3, (2, 4, 8)))]
    sweeps += [(3, q, (4, 8)) for q in (1, 2, 3, 4)]
    orders = {}
    for dim, q, Ns in sweeps:
        pw, T = (pw2, pw2.period) if dim == 2 else (pw3, 0.5 * pw3.period)
        errs, steps = [], []
        for N in Ns:
            topo = rect_mesh(N, N, periodic=(0, 1)) if dim == 2 else \
                box_mesh(N, N, N, periodic=(0, 1, 2))
            dm = build_discrete(topo, q)
            p = build_params(dm, mat, dtype=torch.float64, device=dev)
            n = max(int(np.ceil(T / cfl_dt(dm.h.min(), 2.0, q, 0.4))), 1)
            dt = T / n
            st = State(*(torch.as_tensor(interpolate(dm, f, t), device=dev)
                         for f, t in ((pw.u, 0.0), (pw.sigma, 0.5 * dt))))
            fin, _ = run(p, st, dt, n)
            errs.append(l2_error(dm, fin.u, pw.u, n * dt))
            steps.append(n)
        order = (convergence_order([1.0 / N for N in Ns], errs)
                 if dim == 2 else math.log2(errs[0] / errs[1]))
        bar = (LF_MIN_ORDER_2D if dim == 2 else LF_MIN_ORDER_3D)[q]
        log(f"[cpml] LF4 eigenmode {dim}D P{q}: N {Ns}, steps {steps}, "
            f"L2(u) " + ", ".join(f"{e:.4e}" for e in errs)
            + f"; order {order:.3f} (bar {bar})")
        # 2D: the error must also shrink five-fold across the sweep
        if not (order > bar and (dim == 3 or errs[-1] < 0.2 * errs[0])):
            raise AssertionError(f"LF4 eigenmode {dim}D P{q}: order {order}")


def phase_cpml(dev, case, st):
    """Phase 12 (see the module docstring)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.bench import curvi_ab, pml_ab
    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver import CpmlLaneRunner, absorbing_bc_fn

    # 1. the lane C-PML at full width: kernels against plain versions
    t0 = time.perf_counter()
    dm, p, src, _, dt, _ = case
    ex = detect_structured(dm)
    sides = pml_ab.sides_for(3)
    f0 = float(src.f0[0])
    runners = {impl: CpmlLaneRunner(p, dm, ex, dt, sides, CPML_WIDTH, 2.0,
                                    f0=f0, src=src, impl=impl)
               for impl in ("kernel", "reference")}
    log(f"[cpml] n=24 P3: E {dm.num_elements}, C-PML width {CPML_WIDTH} on "
        f"{len(sides)} sides, source groups "
        f"{len(runners['kernel']._src_groups)}; setup "
        f"{time.perf_counter() - t0:.1f} s")
    reset_counts()
    out_k, _ = runners["kernel"].run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    launches = read_counts()
    out_r, _ = runners["reference"].run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    del runners
    log(f"[cpml] {RUNNER_STEPS} RK4 steps: launches {launches}")
    expect_counts("C-PML path", launches, merged_vel=12 * RUNNER_STEPS,
                  merged_stress=12 * RUNNER_STEPS)
    compare_states("cpml", out_k, out_r)

    # 2. against the einsum oracle on small meshes
    for name, topo in (("box_mesh(4, 4, 4)", box_mesh(4, 4, 4)),
                       ("rect_mesh(8, 8)", rect_mesh(8, 8))):
        dim = len(topo.extents)
        dm_s = build_discrete(topo, 2, bc_fn=absorbing_bc_fn(
            [(0.0, 1.0)] * dim, [(dim - 1, "hi")]))
        rng_mat = np.random.default_rng(dim)
        E = dm_s.num_elements
        p_s = build_params(dm_s, Material(
            rho=1.0 + rng_mat.random(E), vp=2.0 + rng_mat.random(E),
            vs=0.8 + 0.3 * rng_mat.random(E)), device=dev)
        rel = cpml_case(dm_s, p_s, dev, seed=70 + dim)
        log(f"[cpml] lane vs einsum C-PML, {name} P2, 6 steps: rel L2 u "
            f"{rel[0]:.3e}, s {rel[1]:.3e} (bar {CPML_MAX_REL})")
        if not max(rel) < CPML_MAX_REL:
            raise AssertionError(f"lane C-PML off the einsum on {name}")

    # 3. absorption
    if not cpml_absorption(dev) < CPML_ABSORPTION:
        raise AssertionError("the C-PML does not absorb")

    # 4. the main path against the analytic explosion
    mis, corr, launches_g, n_g = greens_misfits(dev)
    expect_counts("Green's-function run", launches_g,
                  merged_vel=3 * n_g, merged_stress=3 * n_g)
    if not (all(v < GREENS_MAX_V and q < GREENS_MAX_P for v, q in mis)
            and corr > GREENS_MIN_CORR):
        raise AssertionError(f"main path off the analytic explosion: {mis}, "
                             f"correlation {corr}")

    # 5. curvilinear stability, 6. LF eigenmode orders
    finite, growth = curvi_growth(dev)
    if not (finite and growth < CURVI_MAX_GROWTH):
        raise AssertionError(f"curved LF4 unstable: energy x{growth}")
    lf_eigen_orders(dev)
    log(f"[cpml] checks {time.perf_counter() - t0:.1f} s")

    # 7. timings: pml_ab at 2D n=64 P3 and 3D n=24 P3, curvi_ab
    recs = [pml_ab.main(dim=2, n=64, degree=3, n_steps=20),
            pml_ab.main(dim=3, n=24, degree=3, n_steps=10,
                        case=(dm, p, dt)),
            curvi_ab.main(n_steps=20)]
    for rec in recs:
        print(json.dumps(rec), flush=True)
    r3 = recs[1]
    log(f"[cpml] lane C-PML n=24 P3: {r3['lane_pml_ms']:.4f} ms a step "
        f"({r3['lane_pml_ms'] / r3['merged_sponge_ms']:.2f}x the sponge "
        f"step's {r3['merged_sponge_ms']:.4f}), "
        f"{r3['lane_pml_dof_per_s']:.4e} DOF-updates/s; K1/K2 "
        f"{r3['lane_pml_kernel_ms']:.4f} ms, the rest "
        f"{r3['lane_pml_glue_ms']:.4f} ms")


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
    check_ptxas()
    log(f"[build] phase {wall:.1f} s")

    # 3. kernels vs plain versions on small meshes
    check = Check()
    t0 = time.perf_counter()
    for dim, degree in SHAPES:
        runner = small_merged_runner(dim, degree, dev)
        log(f"[kernels] {dim}D P{degree}: NC {runner.plan.NC}, Ls "
            f"{runner.plan.Ls}")
        compare_variants(runner, check, f"{dim}D P{degree}",
                         seed=10 * dim + degree)
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

    # every variant at the main path's shapes: each kernel variant's time
    # beside its own bound, the plain variants' plain-version times
    x = compare_variants(run_k, check, "n=24 P3", seed=24)
    times, bounds = {}, {}
    for op, variant in VARIANTS:
        kern, plain, args, kw = variant_call(run_k, x, op, variant)
        kname = "merged_vel" if op == "vel" else "merged_stress"
        t = time_ms(lambda: kern(*args, **kw))
        b = bound(run_k.d, run_k.plan, kname, variant=variant)
        line = (f"[runner] {kname} ({variant}) at n=24 P3: kernel {t:.4f} "
                f"ms, bound {b[0]:.4f} ms ({b[1]}, "
                f"{bound_rows(run_k.d, run_k.plan, kname, variant=variant)}"
                f" rows a lane), {100 * b[0] / t:.1f}% of the bound")
        if variant == "plain":
            times[kname] = (t, time_ms(lambda: plain(*args, **kw)))
            bounds[kname] = b
            line += f"; plain {times[kname][1]:.4f} ms"
        log(line)
    step = sum(k * bound(run_k.d, run_k.plan, kname, variant=v)[0]
               for kname, v, k in (("merged_vel", "plain", 2),
                                   ("merged_vel", "axpy", 1),
                                   ("merged_stress", "plain", 2),
                                   ("merged_stress", "axpy_damp", 1)))
    log(f"[runner] bound of an LF4 step's six K1/K2 launches (2 plain + 1 "
        f"axpy of each): {step:.4f} ms")
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
    log(f"[fused] phase {time.perf_counter() - t0:.1f} s")

    # 11. packed: the P1 two-elements-per-lane layout and K11
    t0 = time.perf_counter()
    for have, new in zip((launches, times, bounds),
                         phase_packed(dev, check)):
        have.update(new)
    log(f"[packed] phase {time.perf_counter() - t0:.1f} s")

    # 12. cpml: the lane C-PML on K1/K2, the analytic and curved checks
    t0 = time.perf_counter()
    phase_cpml(dev, case, st)
    log(f"[cpml] phase {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    sources = dict(KERNELS)
    sources.update({m: (KERNELS[k][0], replaces)
                    for m, (k, replaces) in ANISO_MODES.items()})
    # the packed layout runs the packed tile kernel
    sources.update({m: ("seigen_tpu_torch/csrc/merged_tile.cuh", replaces)
                    for m, (_, replaces) in PACKED_MODES.items()})
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
