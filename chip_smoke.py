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
              stack frame and no spills.  Then the host mesh-setup library
              (mesh/native, g++): its seconds; it must be available, since
              every later phase's setup takes it.
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
13. tools   - the user's tools, through their entry points.
              cli.explosive_source at n=24 P3 with --impl merged and the
              default --T (exactly 3 K1 + 3 K2 launches a step and no
              other; its DOF-updates/s from the run report's "run"
              region beside phase 5's bench), a run to T = 0.5 that
              writes a checkpoint and a --resume from it to the end (the
              resumed seismograms against the tail of the uninterrupted
              run chunked at the same step, relative L2 < 1e-6: a chunk
              seeds its traces from the state), --impl pallas to T = 0.5 (K4 SIG and
              K5 TR through the element-major wrappers: exactly 3 + 3
              launches a step and no other kernel; ms a step; its
              seismograms against the merged run's, relative L2 < 1e-4);
              every CLI branch on 3D n=6 P2 (--T 0.3 --f0 8) against its
              einsum path (relative L2 < 1e-4), each launching exactly
              its kernels: --impl pallas, lane, fused, merged, lane_u,
              --scheme upwind-rk4 (structured and lane_u) with and
              without --qp 30 --qs 20, --pml 0.2 on merged, --vti on
              merged; the facade's xla_roll, pallas and pallas_roll
              against its einsum (rect_mesh(8, 8) P2); cli.precision_study
              (K8/K9/K10 in float32 against the plain runner in float64:
              error within 1.1x and < 1e-4); cli.eigenmode2d at its
              default sizes and cli.eigenmode3d per degree at N = 4, 8 in
              float64, each above tests/test_eigenmode.py's bar;
              cli.topography at its default 48x24 P3 with --vtk; a
              device_trace of 5 merged steps that names K1 and K2; one
              VTK snapshot at n=24 P3 (its seconds); bench.roofline's
              merged step beside the bench's measured step.
14. grad    - the gradient engines of solver/lane_diff.py, on the card
              with no fallback.  Per engine (lane: K4 SIG / K5 TR and
              merged: K1 / K2 on phase 4's n=24 P3 case, merged packed:
              K1pk / K2pk on n=32 P1, lane_u: K4 TRAC SEL / K5 SEL on
              phase 7's scrambled case) one backward of A and one of B'
              (each the other kernel between mass weights) on random
              float32 lane fields against the plain versions' (the
              kernel tolerance below), and the adjoint identity <A x, y>
              = <x, A^T y> through the kernels (relative mismatch <
              1e-4).  The merged engine's vp gradient on the n=24 P3 case
              (one shot, 16 receivers, 100 steps, segment 10, observed
              data from vp * 1.02) against the roll path's (autograd
              through the einsum step on the roll exchange): cosine >=
              0.9999; each path's gradient and forward-sweep seconds,
              their ratio, peak memory; exactly 9 K1 and 9 K2 launches a
              step (3 forward, 3 recomputed, 3 transposed; the first
              step's ops on a zero state carry no gradient) and no other
              kernel, and the profiler's count of device tile kernels on
              a 20-step gradient.  cli.fwi (3D n=8 P1, merged, 3
              iterations) reduces the misfit; cli.rtm (3D n=6 P1, areal,
              merged) images the reflector within half a wavelength with
              focus > 0.5 (tests/test_rtm.py's 3D bars).  The
              bench/fwi_grad.py rows (roll, lane, merged, merged_pk,
              lane_u at n=24 P1; cut to 40 steps, one shot, one timing
              without warm-up: its defaults, 200 steps and 2 shots, take
              six minutes, the roll path most of them).
15. sharded - the slab-sharded paths of parallel/ (one process a rank,
              halo planes over torch.distributed).  Every K1/K2 variant
              (as phase 3) on a one-rank halo plan (Grest halo lanes on
              both sides of every class's trace lanes) of phase 3's meshes
              at 3D P3/P2 and 2D P3/P2 and, packed, K1pk/K2pk at 3D and 2D
              P1: one launch and the interior launch then the boundary
              launch, each against the plain version (own trace lanes),
              the pair bitwise equal to the one launch; K3 on halo plans
              at 3D P3 and 2D P2 with 0-2 source groups.  The same checks
              at n=24 P3 on the main path's halo plan before the times.
              At one rank on the n=24 P3 case, 10 steps from phase 4's
              state: ShardedFusedRunner with fill off (bitwise phase 4's
              MergedLaneRunner run, 3 + 3 launches a step), local, skip,
              ppermute (3 + 3) and ppermute with the overlap split (6 K1
              + 6 K2 a step), ShardedLaneRunner (LF4,
              3 K4 SIG + 3 K5 TR a step) against LaneMajorRunner, and
              ShardedUpwindRunner with Q = 30/20 (4 K3 a step) against
              UpwindLaneRunner, each relative L2 < 1e-4; the split pair's
              and K3's times beside one launch, the plain version and the
              bound; the benches of every one-rank fill mode beside phase
              5's merged, lane_sharded beside lane (LF4), and
              fused_sharded_pk beside merged_pk at n=32 P1.  Two ranks
              (NCCL with two cards, else gloo on the one card, staged
              through pinned host memory; the line names which ran) on
              the n=24 P3 case: the global state against phase 4's
              (relative L2 < 1e-4), the launches, DOF-updates/s and the
              halo bytes a step; the same run with the split bitwise
              equal to it.
16. sharded_e2 - the rest of the sharded paths (parallel/: Morton blocks,
              the general einsum path, the sharded gradients).  K4 TRAC
              SEL and K5 SEL at the shapes of rank 0 of a 2-rank
              ShardedUnstructuredRunner on the scrambled n=24 P3 case (its
              lanes, select codes and panel rows) against their plain
              versions, their times beside the plain versions and the
              bound.  At one rank, 10 steps from phase 7's scrambled
              state: ShardedUnstructuredRunner (3 K4 + 3 K5 a step)
              against UnstructuredLaneRunner, relative L2 < 1e-4; the
              lane_u_sharded bench beside lane_u.  Two ranks (NCCL with
              two cards, else gloo on the one card): the same run
              (relative L2 < 1e-4, rank 0's launches, DOF-updates/s, the
              panel bytes a step a rank); run_distributed on tiny_case's
              3D P2 case in float64 against timestep.run (rtol 1e-10);
              the lane, merged, packed-P1 and lane_u domain-decomposed
              gradients and shot-DP's vg_factory_sharded (merged, 2
              shots) against the one-device LaneDiffFwi on phase 14's
              cases (lane, merged: n=24 P3; packed: n=32 P1; lane_u: the
              scrambled n=24 P3), 10 steps in segments of 5, shots at
              the receiver line's depth with t0 = 0, observed data from vp
              x 1.02: vp gradient cosine >= 0.9999, misfit within 1e-5.
17. native  - the host mesh-setup library (mesh/native: the JAX package's
              C++ source) against the NumPy setup, each forced by
              replacing ``native.available``.  build_discrete of the
              explosive-source case at n=24 P3 (in turns NumPy, native,
              native, NumPy) and at n=40 P3 (E = 384 000), the seconds of
              each: nbr, bc and coords exactly equal, Ginv, detJ, normals,
              Fscale and h within rtol 1e-12 and an absolute 1e-14 times
              the field's largest magnitude; morton_order and
              make_plan(dm, 4) on the scrambled n=24 P3 case, both paths,
              seconds, every array and round_perms identical; setup_case
              at n=24 P3 both ways in the same turns, the seconds to the
              first merged step, then 10 MergedLaneRunner steps (3 + 3
              K1/K2 launches a step) from one seeded state on the first
              case of each: relative L2 native against NumPy < 1e-6
              (float32 state, geometry in ulps).

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

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

try:  # the bound arithmetic of every kernel (main() reports its absence)
    from seigen_tpu_torch.bench.roofline import UPWIND_U_MODES, bound, \
        bound_rows, fused_bound, fused_rows, lane_bound, upwind_u_bound, \
        upwind_u_rows
except ImportError:
    pass

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
# phase 13: the user's tools (the CLIs, the element-major wrappers, utils/)
TOOLS_MAX_REL = 1e-4  # a CLI branch against its einsum path, rel. L2
RESUME_MAX_REL = 1e-6  # resumed tail against the uninterrupted run
# phase 14: gradients (solver/lane_diff.py; the einsum "roll" gradient)
GRAD_STEPS = 100
GRAD_SEGMENT = 10
GRAD_RCV_LINE = ((0.1, 0.5, 0.9), (0.9, 0.5, 0.9))
GRAD_VP_SCALE = 1.02  # observed data from vp * this
GRAD_MIN_COSINE = 0.9999
ADJOINT_MAX_REL = 1e-4  # <A x, y> against <x, A^T y>, float32 kernels
FWI_CLI = ("--dim", "3", "--n", "8", "--degree", "1", "--iters", "3",
           "--shots", "2", "--T", "0.6", "--grad-path", "merged")
FWI_GRAD_STEPS = 40  # bench/fwi_grad.py at n=24 P1, one shot, one timing
RTM_CLI = ("--dim", "3", "--n", "6", "--degree", "1", "--shots", "4",
           "--receivers", "16", "--areal", "--grad-path", "merged")
FULL_CLI = ("--dim", "3", "--n", "24", "--degree", "3")
SMALL_CLI = ("--dim", "3", "--n", "6", "--degree", "2", "--T", "0.3",
             "--f0", "8")
VTI = ("--vti", "0.15,0.05,0.1")
UPWIND, Q = ("--scheme", "upwind-rk4"), ("--qp", "30", "--qs", "20")
# label -> (CLI arguments, those of its einsum path, the launches a step of
# each kernel it runs — every other count must stay 0)
LF_LANE = {"lane_vel": 3, "lane_stress": 3}
SMALL_BRANCHES = {
    "einsum": (("--impl", "einsum"), None, {}),
    "pallas": (("--impl", "pallas"), ("--impl", "einsum"), LF_LANE),
    "lane": (("--impl", "lane"), ("--impl", "einsum"), LF_LANE),
    "fused": (("--impl", "fused"), ("--impl", "einsum"),
              {"fused_vel2": 3, "fused_stress2": 3, "trace_exchange": 6}),
    "merged": (("--impl", "merged"), ("--impl", "einsum"),
               {"merged_vel": 3, "merged_stress": 3}),
    "lane_u": (("--impl", "lane_u"), ("--impl", "einsum"), LF_LANE),
    "upwind_lane": (UPWIND, UPWIND + ("--impl", "einsum"),
                    {"upwind_rhs": 4}),
    "upwind_lane_u": (UPWIND + ("--impl", "lane_u"),
                      UPWIND + ("--impl", "einsum"), {"lane_upwind_axpy": 4}),
    "upwind_lane Q": (UPWIND + Q, UPWIND + Q + ("--impl", "einsum"),
                      {"upwind_rhs": 4}),
    "upwind_lane_u Q": (UPWIND + Q + ("--impl", "lane_u"),
                        UPWIND + Q + ("--impl", "einsum"),
                        {"lane_upwind_rhs": 4}),
    "pml": (("--pml", "0.2", "--impl", "merged"),
            ("--pml", "0.2", "--impl", "einsum"),
            {"merged_vel": 12, "merged_stress": 12}),
    "vti merged": (VTI + ("--impl", "merged"), VTI + ("--impl", "einsum"),
                   {"merged_vel": 3, "merged_stress": 3,
                    "merged_stress_c": 3}),
}
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
# phase 15: the sharded paths' kernel modes (halo trace lanes; K1/K2 as
# the interior and boundary launches of the overlap split) -> kernel
SHARDED_MODES = {"merged_vel[split]": "merged_vel",
                 "merged_stress[split]": "merged_stress",
                 "upwind_rhs[halo]": "upwind_rhs"}
# phase 16: K4 TRAC SEL / K5 SEL on a Morton block's lanes and panels
# -> (kernel, replaced TPU kernel)
SHARDED_E2_MODES = {
    "lane_vel[SEL,shard]": ("lane_vel",
                            "seigen_tpu/ops/pallas_kernels.py:373"),
    "lane_stress[SEL,shard]": ("lane_stress",
                               "seigen_tpu/ops/pallas_kernels.py:386")}
DD_STEPS = 10
DD_SEGMENT = 5
E2_BENCH_STEPS = 20  # the 2-rank lane_u_sharded bench (gloo: ~30 ms a step)
DD_VP_SCALE = 1.02  # observed data from vp * this
DD_MIN_COSINE = 0.9999
DD_VALUE_REL = 1e-5
# phase 16's gradients: tag -> (bench case, engine, packed)
DD_CASES = {"lane": ("case", "lane", False),
            "merged": ("case", "merged", False),
            "packed": ("pcase", "merged", True),
            "lane_u": ("scase", "lane_u", False)}
# phase 17: the native mesh-setup library against the NumPy setup
NATIVE_SIZES = (24, 40)  # build_discrete at n=24 P3 and n=40 P3 (E = 384k)
# tests/test_native.py's bounds, atol times the field's largest magnitude
NATIVE_RTOL, NATIVE_ATOL = 1e-12, 1e-14
NATIVE_GEOMETRY = ("Ginv", "detJ", "normals", "Fscale", "h")
NATIVE_MAX_REL = 1e-6  # 10 merged steps, native case vs NumPy case, f32
NATIVE_SHARDS = 4
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

    def field(C, used, rows, L=plan.Ls):
        a = rng.standard_normal((C, d.n_par, rows // d.n_par, L)
                                ).astype(np.float32)
        a[:, :, used:] = 0.0
        return torch.as_tensor(a.reshape(C * rows, L), device=runner.device)

    return {
        "sig": [field(d.n_sig, d.n_p, d.npp) for _ in range(3)],
        "u": [field(d.dim, d.n_p, d.npp) for _ in range(3)],
        # the producer traces lie on the plan's trace lanes (a slab's halo
        # lanes too)
        "trs": field(d.nf, d.dim * d.n_fp, plan.rtf, plan.Lt),
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

    def field(C, used, rows, L=plan.Ls):
        a = rng.standard_normal((C, rows, L)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * rows, L), device=runner.device)

    return {"u": field(d.dim, d.n_p, d.npp),
            "s": field(d.n_sig, d.n_p, d.npp),
            "trs": field(d.nf, 2 * d.dim * d.n_fp, plan.rtf, plan.Lt),
            "inj": [(field(d.dim, d.n_p, d.npp),
                     field(d.n_sig, d.n_p, d.npp), (0.7, -1.3)[g])
                    for g in range(2)]}


def upwind_args(runner, x):
    return (runner.plan, runner.d, runner.uwg, x["u"], x["s"], x["trs"],
            runner.mask)


def compare_upwind(runner, check, tag, seed, variants, kname="upwind_rhs"):
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
            check(kname, f"{tag} {variant} {part}", g, r)
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


def rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def cli_run(tmp, name, args, counts=False):
    """cli.explosive_source.main(args) with its seismograms written to
    ``tmp`` (and a run report); returns (seismograms, report, launch
    counts of the run or None)."""
    import os

    import numpy as np

    from seigen_tpu_torch.cli import explosive_source

    out = os.path.join(tmp, f"{name}.npz")
    report = os.path.join(tmp, f"{name}.json")
    if counts:
        reset_counts()
    rc = explosive_source.main(list(args) + ["--out", out, "--report",
                                             report])
    launches = read_counts() if counts else None
    if rc != 0:
        raise AssertionError(f"explosive_source {name}: exit {rc}")
    with open(report) as f:
        rep = json.load(f)
    return np.load(out)["seismograms"], rep, launches


def run_rate(rep):
    """(ms a step, DOF-updates/s) of a CLI run from its report's ``run``
    region."""
    steps = rep["n_steps"] - rep["step0"]
    sec = rep["timings"]["run"]["seconds"]
    return 1e3 * sec / steps, rep["dof"] * steps / sec


def tools_full_width(tmp, bench_rec):
    """Phase 13, 1 and 2: the CLI's merged run at n=24 P3 (its rate beside
    the bench's), a run to T = 0.5 that writes a checkpoint and the resume
    from it against an uninterrupted run with the same chunks, and --impl
    pallas (K4 SIG / K5 TR through the element-major wrappers)."""
    import os

    full = list(FULL_CLI) + ["--impl", "merged"]
    seis_a, rep_a, la = cli_run(tmp, "merged", full, counts=True)
    n = rep_a["n_steps"]
    expect_counts("CLI merged", la, merged_vel=3 * n, merged_stress=3 * n)
    if not (seis_a.shape == (n, 16, 3) and math.isfinite(seis_a.sum())):
        raise AssertionError(f"CLI merged: seismograms {seis_a.shape}")
    ms, rate = run_rate(rep_a)
    log(f"[tools] CLI --impl merged n=24 P3: E {rep_a['E']}, {n} steps, "
        f"run {rep_a['timings']['run']['seconds']:.3f} s, {ms:.4f} ms a "
        f"step, {rate:.4e} DOF-updates/s; bench --impl merged "
        f"{bench_rec['value']:.4e} ({100 * rate / bench_rec['value']:.1f}%)"
        f"; setup {rep_a['timings']['setup']['seconds']:.1f} s")

    # the resume: a run's chunks start from the state alone (the runner
    # seeds its traces from it), so the uninterrupted run is chunked where
    # the resumed one starts
    ck = os.path.join(tmp, "ck.npz")
    seis_b, rep_b, _ = cli_run(tmp, "half", full + [
        "--T", "0.5", "--checkpoint", ck, "--checkpoint-every", "100000"])
    half = rep_b["n_steps"]
    seis_c, rep_c, _ = cli_run(tmp, "resumed", full + ["--resume", ck])
    seis_k, rep_k, _ = cli_run(tmp, "chunked", full + [
        "--checkpoint", os.path.join(tmp, "ck2.npz"),
        "--checkpoint-every", str(half)])
    tail = seis_k[-len(seis_c):]
    rel = rel_l2(seis_c, tail)
    log(f"[tools] resume from step {rep_c['step0']} (checkpoint of "
        f"{os.path.getsize(ck) / 2**20:.1f} MiB; the half run's run region "
        f"{rep_b['timings']['run']['seconds']:.3f} s with its write): "
        f"{len(seis_c)} steps, rel L2 against the uninterrupted run "
        f"chunked at {half} {rel:.3e} (bar {RESUME_MAX_REL}); that run "
        f"against the unchunked one {rel_l2(seis_k, seis_a):.3e}")
    if not (rep_c["step0"] == half and rel < RESUME_MAX_REL):
        raise AssertionError(f"resume off: rel {rel}")

    seis_p, rep_p, lp = cli_run(tmp, "pallas", full[:-1] + [
        "pallas", "--T", "0.5"], counts=True)
    n_p = rep_p["n_steps"]
    expect_counts("CLI pallas", lp, lane_vel=3 * n_p, lane_stress=3 * n_p)
    rel = rel_l2(seis_p, seis_b)
    ms_p, rate_p = run_rate(rep_p)
    log(f"[tools] CLI --impl pallas n=24 P3: {n_p} steps, launches "
        f"{3 * n_p} K4 SIG + {3 * n_p} K5 TR and no other, {ms_p:.4f} ms a "
        f"step, {rate_p:.4e} DOF-updates/s; seismograms vs --impl merged "
        f"rel L2 {rel:.3e} (bar {TOOLS_MAX_REL})")
    if not rel < TOOLS_MAX_REL:
        raise AssertionError(f"CLI pallas off merged: rel {rel}")


def tools_branches(tmp, dev):
    """Phase 13, 3: every CLI branch on a small case against its einsum
    path, and the facade's element-major impls against its einsum."""
    import numpy as np

    from seigen_tpu_torch.mesh import rect_mesh
    from seigen_tpu_torch.ops import Material
    from seigen_tpu_torch.solver import ElasticSimulation, PointSource, \
        SimConfig, line

    runs = {}
    for label, (args, ref, per_step) in SMALL_BRANCHES.items():
        seis, rep, counts = cli_run(tmp, label.replace(" ", "_"),
                                    SMALL_CLI + args, counts=True)
        expect_counts(f"CLI {label}", counts, **{
            k: v * rep["n_steps"] for k, v in per_step.items()})
        runs[args] = seis
        if ref is None:
            continue
        if ref not in runs:
            runs[ref] = cli_run(tmp, "ref", SMALL_CLI + ref)[0]
        rel = rel_l2(seis, runs[ref])
        log(f"[tools] CLI {label} (3D n=6 P2, {rep['n_steps']} steps): vs "
            f"its einsum path rel L2 {rel:.3e}, max |seismogram| "
            f"{np.abs(seis).max():.3e}; kernels "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not (rel < TOOLS_MAX_REL and np.abs(seis).max() > 0):
            raise AssertionError(f"CLI {label} off its einsum path: {rel}")

    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    kw = dict(sources=[PointSource(position=(0.5, 0.6), f0=6.0, radius=0.15)],
              receiver_points=line((0.3, 0.9), (0.7, 0.9), 4), device=dev)
    cfg = dict(degree=2, order=4, free_sides=((1, "hi"),),
               absorbing_sides=((0, "lo"), (0, "hi"), (1, "lo")),
               sponge_width=0.2)
    ref, _ = ElasticSimulation(rect_mesh(8, 8), mat,
                               SimConfig(impl="einsum", **cfg), **kw).run(0.1)
    for impl in ("xla_roll", "pallas", "pallas_roll"):
        sim = ElasticSimulation(rect_mesh(8, 8), mat,
                                SimConfig(impl=impl, **cfg), **kw)
        reset_counts()
        fin, seis = sim.run(0.1)
        counts = read_counts()
        n = len(seis)
        rel = max(((getattr(fin, f) - getattr(ref, f)).norm()
                   / getattr(ref, f).norm()).item() for f in ("u", "s"))
        log(f"[tools] facade {impl}: {n} steps, vs einsum rel L2 {rel:.3e};"
            f" kernels {({k: v for k, v in counts.items() if v})}")
        if impl == "xla_roll":
            expect_counts(f"facade {impl}", counts)
        else:
            expect_counts(f"facade {impl}", counts, lane_vel=3 * n,
                          lane_stress=3 * n)
        if not rel < TOOLS_MAX_REL:
            raise AssertionError(f"facade {impl} off its einsum: {rel}")


def tools_studies(tmp):
    """Phase 13, 4 and 5: the precision gate, the eigenmode CLIs at the
    test bars, the topography CLI with its VTK series."""
    import os

    from seigen_tpu_torch.cli import eigenmode2d, eigenmode3d, \
        precision_study, topography

    prec = os.path.join(tmp, "precision.json")
    rc = precision_study.main(["--out", prec])
    with open(prec) as f:
        res = json.load(f)
    log(f"[tools] precision gate (2D P3 rect_mesh(16, 16), "
        f"{res['runs']['f32']['steps']} steps): kernels f32 L2(u) "
        f"{res['runs']['f32']['err']:.6e}, plain f64 "
        f"{res['runs']['f64']['err']:.6e}, ratio {res['ratio']:.4f} (bar "
        f"{res['max_ratio']}, and < {res['max_err']})")
    if rc != 0:
        raise AssertionError("the precision gate failed")

    if eigenmode2d.main(["--min-order", str(LF_MIN_ORDER_2D[2])]) != 0:
        raise AssertionError("cli.eigenmode2d below its bar")
    for q, bar in LF_MIN_ORDER_3D.items():  # the bars' sizes, N = 4, 8
        if eigenmode3d.main(["--degrees", str(q), "--sizes", "4,8",
                             "--f64", "--min-order", str(bar)]) != 0:
            raise AssertionError(f"cli.eigenmode3d P{q} below its bar")

    t0 = time.perf_counter()
    vtk = os.path.join(tmp, "topo", "topo.pvd")
    if topography.main(["--vtk", vtk, "--out",
                        os.path.join(tmp, "topo.npz")]) != 0:
        raise AssertionError("cli.topography failed")
    n_vtu = len([f for f in os.listdir(os.path.dirname(vtk))
                 if f.endswith(".vtu")])
    log(f"[tools] cli.topography 48x24 P3: {n_vtu} VTU snapshots, "
        f"{time.perf_counter() - t0:.1f} s")


def tools_utils(tmp, case, run_k, out_k, bench_rec):
    """Phase 13, 6: a device trace of 5 merged steps names K1 and K2; one
    VTK snapshot at full width; the roofline of the merged step."""
    import os

    import torch

    from seigen_tpu_torch.bench import roofline
    from seigen_tpu_torch.bench.profile_step import kernel_group
    from seigen_tpu_torch.utils import PVDWriter, device_trace

    logdir = os.path.join(tmp, "trace")
    ulm, slm = run_k.to_lm_state(out_k)
    with device_trace(logdir):
        run_k.run_lm(ulm, slm, 5)
        torch.cuda.synchronize()
    (trace,) = os.listdir(logdir)
    with open(os.path.join(logdir, trace)) as f:
        events = json.load(f)["traceEvents"]
    groups = {kernel_group(e["name"]) for e in events
              if e.get("cat") == "kernel"}
    log(f"[tools] device_trace of 5 merged steps: {trace}, "
        f"{len(events)} events, kernel groups {sorted(groups)}")
    if not {"merged_vel", "merged_stress"} <= groups:
        raise AssertionError("the device trace does not name K1 and K2")

    dm = case[0]
    t0 = time.perf_counter()
    PVDWriter(os.path.join(tmp, "vtk", "full.pvd"), dm).write(0.0, {
        "u": out_k.u.cpu().numpy(),
        "p": (-out_k.s[..., :3].mean(dim=-1)).cpu().numpy()})
    log(f"[tools] VTK snapshot at n=24 P3 ({dm.num_elements * 4} points, "
        f"u and p): {time.perf_counter() - t0:.2f} s")

    d = bench_rec["detail"]
    step_ms = 1e3 * d["seconds"] / d["steps"]
    rec = roofline.main(n=24, degree=3, measured_ms=step_ms)
    print(json.dumps(rec), flush=True)
    log(f"[tools] roofline of the merged step: {rec['MB_per_step']:.1f} MB,"
        f" bound {rec['roofline_ms']:.4f} ms, measured {step_ms:.4f} ms "
        f"(the bench's), {100 * rec['roofline_fraction']:.1f}% of it")


def phase_tools(dev, case, run_k, out_k, bench_rec):
    """Phase 13 (see the module docstring)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tools_full_width(tmp, bench_rec)
        log(f"[tools] full width {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tools_branches(tmp, dev)
        log(f"[tools] branches {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tools_studies(tmp)
        log(f"[tools] studies {time.perf_counter() - t0:.1f} s")
        tools_utils(tmp, case, run_k, out_k, bench_rec)


def grad_rcv(case):
    """The 16-receiver line of phase 14, in the case's element order."""
    from seigen_tpu_torch.solver import build_receivers, line

    dm, p = case[0], case[1]
    return build_receivers(dm, line(*GRAD_RCV_LINE, 16), device=p.device)


def grad_engine(case, engine, impl, packed=False, n_steps=GRAD_STEPS,
                segment=GRAD_SEGMENT):
    """A LaneDiffFwi on a bench case: its source as the one shot, the
    16-receiver line at depth 0.9, the case's sponge; observed data unset."""
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.lane_diff import LaneDiffFwi

    dm, p, src, damp, dt, _ = case
    return LaneDiffFwi(p, dm, detect_structured(dm), dt, n_steps, src,
                       grad_rcv(case), None, damp=damp, segment=segment,
                       engine=engine, impl=impl, packed=packed)


def valid_rows(ldf):
    """(npp,) bool: the node rows of the engine's layout (not padding)."""
    import torch

    d = ldf.runner.d
    j = torch.arange(d.npp, device=ldf.device)
    return (j % (d.npp // ldf._npar)) < d.n_p


def grad_inputs(ldf, seed):
    """Random float32 (sigma, u, ubar, ebar) lane fields, padding rows 0."""
    import numpy as np
    import torch

    d = ldf.runner.d
    rng = np.random.default_rng(seed)
    keep = valid_rows(ldf)[None, :, None]

    def field(C):
        x = torch.as_tensor(rng.standard_normal((C, d.npp, ldf._L)),
                            device=ldf.device).float()
        return (x * keep).reshape(C * d.npp, -1).contiguous()

    return field(d.n_sig), field(d.dim), field(d.dim), field(d.n_sig)


def backward_of(op, x, cot):
    """The gradient op's autograd backward hands x for the cotangent."""
    import torch

    x = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(op(x), x, cot)
    return g


def compare_grad_engine(tag, ldf_k, ldf_r, check, seed):
    """Phase 14, 1-2: one A and one B backward with the kernels against
    the plain versions (the backward of A is a B' launch between mass
    weights and vice versa), and the adjoint identity <A x, y> = <x, A^T
    y> with the kernels.  Returns the worst adjoint mismatch."""
    sig, u, ubar, ebar = grad_inputs(ldf_k, seed)
    ka, kb = ldf_k.ops, ldf_r.ops
    names = ("merged_vel", "merged_stress") if ldf_k.engine == "merged" \
        else ("lane_vel", "lane_stress")
    # A's backward launches the stress kernel, B's the velocity kernel
    check(names[1], f"{tag} A backward",
          backward_of(ka.A, sig, ubar), backward_of(kb.A, sig, ubar))
    check(names[0], f"{tag} B backward",
          backward_of(ka.B, u, ebar), backward_of(kb.B, u, ebar))
    worst = 0.0
    for label, op, x, y in (("A", ka.A, sig, ubar), ("B", ka.B, u, ebar)):
        lhs = float((op(x).double() * y.double()).sum())
        rhs = float((x.double() * backward_of(op, x, y).double()).sum())
        rel = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
        worst = max(worst, rel)
        log(f"  {tag} <{label} x, y> {lhs:.6e}, <x, {label}^T y> "
            f"{rhs:.6e}: relative mismatch {rel:.3e}")
        if not rel < ADJOINT_MAX_REL:
            raise AssertionError(f"{tag} {label}: adjoint identity off "
                                 f"({rel:.3e})")
    return worst


def full_width_gradient(case, smi):
    """Phase 14, 3: the merged engine's vp gradient at full width against
    the roll path's (einsum autograd on the structured roll exchange), the
    wall seconds of each gradient and forward sweep, peak memory, and the
    K1/K2 launches per gradient step (the wrapper counts, and the
    profiler's device kernels on a shorter run)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.ops.structured_exchange import \
        make_structured_ops
    from seigen_tpu_torch.solver.adjoint import make_fwi_gradient, \
        run_segmented, theta_of_params, with_material
    from seigen_tpu_torch.utils.profiling import device_profile

    _, p, src, damp, dt, st0 = case
    ldf = grad_engine(case, "merged", "kernel")
    vp0 = theta_of_params(p)["vp"].detach()
    ldf.observed = ldf.synth({"vp": vp0 * GRAD_VP_SCALE})
    theta = {"vp": vp0}
    vg = ldf.vg_factory(None)
    vg(theta)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    v_m, g_m = vg(theta)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    launches = read_counts()
    peak_m = torch.cuda.max_memory_allocated()
    n = GRAD_STEPS
    expect_counts("merged gradient", launches, merged_vel=9 * n - 3,
                  merged_stress=9 * n - 2)
    t0 = time.perf_counter()
    ldf.synth(theta)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0

    vo, so = make_structured_ops(ldf.runner.ex)
    vg_roll, _ = make_fwi_gradient(
        p, st0, dt, n, src, grad_rcv(case),
        ldf.observed[0], fields=("vp",), damp=damp, segment=GRAD_SEGMENT,
        vel_op=vo, stress_op=so)
    torch.cuda.synchronize()  # no warm-up: the roll path builds nothing
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v_r, g_r = vg_roll(theta)
    torch.cuda.synchronize()
    t_grad_r = time.perf_counter() - t0
    peak_r = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        t0 = time.perf_counter()
        run_segmented(with_material(p, **theta), st0, dt, n, src=src,
                      damp=damp, receivers=grad_rcv(case), vel_op=vo,
                      stress_op=so)
        torch.cuda.synchronize()
        t_fwd_r = time.perf_counter() - t0
    a = g_r["vp"].double().cpu().numpy()
    b = g_m["vp"].double().cpu().numpy()
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(a))
    log(f"[grad] merged vs roll vp gradient at n=24 P3 ({n} steps, segment "
        f"{GRAD_SEGMENT}, one shot): cosine {cos:.8f}, rel L2 {rel:.3e}; "
        f"misfit {v_m:.6e} vs {v_r:.6e}")
    for name, tg, tf, pk in (("merged", t_grad, t_fwd, peak_m),
                             ("roll", t_grad_r, t_fwd_r, peak_r)):
        log(f"[grad] {name}: gradient {tg:.3f} s, forward sweep {tf:.3f} s,"
            f" ratio {tg / tf:.2f}, peak memory {pk / 2**30:.3f} GiB "
            f"({smi})")
    log(f"[grad] merged gradient launches {launches['merged_vel']} K1 + "
        f"{launches['merged_stress']} K2 over {n} steps: "
        f"{launches['merged_vel'] / n:.2f} + "
        f"{launches['merged_stress'] / n:.2f} a step")
    if not cos >= GRAD_MIN_COSINE:
        raise AssertionError(f"merged vp gradient cosine {cos} against "
                             f"roll < {GRAD_MIN_COSINE}")
    del ldf, vg, vg_roll

    # the profiler's count of device tile kernels on a 20-step gradient
    short = grad_engine(case, "merged", "kernel", n_steps=20)
    short.observed = np.zeros((1, 20, 16, 3), np.float32)
    vg_s = short.vg_factory(None)
    vg_s(theta)
    with device_profile() as prof:
        vg_s(theta)
        torch.cuda.synchronize()
    tiles = sum(e.count for e in prof.key_averages()
                if "merged_tile_kernel" in e.key)
    log(f"[grad] profiler: {tiles} merged tile kernel launches over a 20-"
        f"step gradient ({tiles / 20:.2f} a step; wrapper count "
        f"{(9 * 20 - 3) + (9 * 20 - 2)})" if tiles else
        "[grad] profiler: no device kernels recorded (not measured)")


def grad_clis(tmp):
    """Phase 14, 4: cli.fwi (merged) reduces the misfit; cli.rtm (3D,
    areal, merged) meets tests/test_rtm.py's 3D bars."""
    import contextlib
    import io
    import os

    from seigen_tpu_torch.cli import fwi, rtm

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fwi.main(list(FWI_CLI))
    out = buf.getvalue().strip().splitlines()
    s = json.loads(out[-1])
    log(f"[grad] cli.fwi {' '.join(FWI_CLI)}: exit {rc}, E {s['E']}, "
        f"{s['n_steps']} steps, misfit {s['misfit_first']:.4e} -> "
        f"{s['misfit_last']:.4e}, model error {s['model_err_init']:.4f} -> "
        f"{s['model_err_final']:.4f} ({time.perf_counter() - t0:.1f} s)")
    if rc != 0 or not s["misfit_last"] < s["misfit_first"]:
        raise AssertionError(f"cli.fwi: the misfit did not fall: {s}")
    js = os.path.join(tmp, "rtm.json")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = rtm.main(list(RTM_CLI) + ["--json", js])
    with open(js) as f:
        r = json.load(f)
    half = r["vmax"] / r["f0"] / 2
    log(f"[grad] cli.rtm {' '.join(RTM_CLI)}: exit {rc}, E {r['E']}, z_error "
        f"{r['z_error']:.4f} (bar {half:.4f}), focus {r['focus']:.3f} (bar "
        f"0.5) ({time.perf_counter() - t0:.1f} s)")
    if rc != 0 or not (r["z_error"] < half and r["focus"] > 0.5):
        raise AssertionError(f"cli.rtm misses the 3D bars: {r}")


def phase_gradients(dev, case, scase, smi):
    """Phase 14 (see the module docstring)."""
    import tempfile

    import torch

    from seigen_tpu_torch.bench import fwi_grad, throughput

    check = Check()  # kept apart from the main path's worst errors
    t0 = time.perf_counter()
    pcase = throughput.setup_case(n=32, degree=1, device=dev)
    worst = 0.0
    for tag, c, engine, packed in (
            ("lane n=24 P3", case, "lane", False),
            ("merged n=24 P3", case, "merged", False),
            ("merged packed n=32 P1", pcase, "merged", True),
            ("lane_u scrambled n=24 P3", scase, "lane_u", False)):
        ldf_k = grad_engine(c, engine, "kernel", packed=packed)
        ldf_r = grad_engine(c, engine, "reference", packed=packed)
        worst = max(worst, compare_grad_engine(tag, ldf_k, ldf_r, check,
                                               seed=len(tag)))
        del ldf_k, ldf_r
        torch.cuda.empty_cache()
    del pcase
    log(f"[grad] backward kernels agree, adjoint identity within "
        f"{worst:.3e} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    full_width_gradient(case, smi)
    torch.cuda.empty_cache()
    log(f"[grad] full width {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        grad_clis(tmp)
    t0 = time.perf_counter()
    fwi_grad.run(n_steps=FWI_GRAD_STEPS, repeats=1, shots=1, warmup=False,
                 paths=fwi_grad.PATHS, log=log)
    log(f"[grad] fwi_grad rows {time.perf_counter() - t0:.1f} s")


def own_lanes(plan, tr):
    """The own trace lanes of a (rows, Lt) trace array (a halo plan's halo
    lanes are the fill's: the kernel does not write them)."""
    return tr.view(tr.shape[0], plan.m, plan.NCt)[
        :, :, plan.h0 : plan.h0 + plan.NC]


def small_case(dim, degree, dev, rho_seed=None):
    """(dm, p, ex, damp) of phase 3's free-top box_mesh(5, 3, 4) (3D) or
    rect_mesh(14, 10) (2D), sponge-damped along x; with ``rho_seed`` a
    density per element uniform in [1, 1.5) (numpy-seeded)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_tpu_torch.ops import Material, build_params
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn, sponge_mask

    topo = box_mesh(5, 3, 4) if dim == 3 else rect_mesh(14, 10)
    dm = build_discrete(topo, degree, bc_fn=absorbing_bc_fn(
        ((0.0, 1.0),) * dim, free_sides=[(dim - 1, "hi")]))
    rho = 1.0 if rho_seed is None else np.random.default_rng(
        rho_seed).uniform(1.0, 1.5, dm.num_elements)
    p = build_params(dm, Material(rho, 2.0, 1.0), dtype=torch.float32,
                     device=dev)
    damp = torch.as_tensor(sponge_mask(dm, [(0, "lo"), (0, "hi")],
                                       width=0.3), device=dev).float()
    return dm, p, detect_structured(dm), damp


def small_sharded_runner(dim, degree, dev, packed=False):
    """A one-rank kernel ShardedFusedRunner with halo lanes (fill
    "ppermute") and the overlap split on phase 3's meshes (packed: P1 with
    a random density per element, as phase 11)."""
    from seigen_tpu_torch.parallel import ShardedFusedRunner

    dm, p, ex, damp = small_case(dim, degree, dev,
                                 240 + dim if packed else None)
    return ShardedFusedRunner(p, ex, 0.01, 1, damp=damp,
                              fill_mode="ppermute", overlap=True,
                              impl="kernel", packed=packed)


def small_halo_k3(dev, check):
    """K3 on halo plans (one-rank ShardedUpwindRunner, fill "ppermute") on
    phase 3's meshes at 3D P3 and 2D P2, 0-2 source groups, against its
    plain version on the own trace lanes."""
    import torch

    from seigen_tpu_torch.bench.throughput import BENCH_MAT
    from seigen_tpu_torch.ops import build_upwind_data
    from seigen_tpu_torch.ops import upwind_kernels as uk
    from seigen_tpu_torch.parallel import ShardedUpwindRunner

    for dim, degree in ((3, 3), (2, 2)):
        dm, p, ex, damp = small_case(dim, degree, dev)
        w = build_upwind_data(dm, BENCH_MAT, device=dev)
        r = ShardedUpwindRunner(p, ex, w, 0.01, 1, damp=damp,
                                fill_mode="ppermute", impl="kernel")
        x = upwind_inputs(r, 80 + dim)
        for g in range(3):
            inj = x["inj"][:g]
            got = uk.UPWIND_KERNEL(*upwind_args(r, x), inject=inj)
            ref = uk.upwind_rhs_merged_ref(*upwind_args(r, x), inject=inj)
            torch.cuda.synchronize()
            tag = f"halo {dim}D P{degree} {g} groups"
            check("upwind_rhs[halo]", f"{tag} du", got[0], ref[0])
            check("upwind_rhs[halo]", f"{tag} ds", got[1], ref[1])
            check("upwind_rhs[halo]", f"{tag} traces",
                  own_lanes(r.plan, got[2]), own_lanes(r.plan, ref[2]))


def compare_split(runner, check, tag, seed):
    """Every K1/K2 variant on the halo plan: one launch, and the interior
    launch then the boundary launch into the same outputs, each against
    the plain version; the pair bitwise equal to the one launch."""
    import torch

    plan = runner.plan
    lo, hi = runner._split
    x = variant_inputs(runner, seed)
    for op, variant in VARIANTS:
        kern, plain, args, kw = variant_call(runner, x, op, variant)
        full = kern(*args, **kw)
        part = kern(*args, lanes=(lo, hi, 0), **kw)
        part = kern(*args, lanes=(lo, hi, 1), out=part, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        kname = ("merged_vel" if op == "vel" else "merged_stress") + "[split]"
        check(kname, f"{tag} {op} {variant} out", full[0], ref[0])
        check(kname, f"{tag} {op} {variant} traces",
              own_lanes(plan, full[1]), own_lanes(plan, ref[1]))
        check(kname, f"{tag} {op} {variant} split out", part[0], ref[0])
        check(kname, f"{tag} {op} {variant} split traces",
              own_lanes(plan, part[1]), own_lanes(plan, ref[1]))
        if not (torch.equal(full[0], part[0]) and torch.equal(
                own_lanes(plan, full[1]), own_lanes(plan, part[1]))):
            raise AssertionError(f"{tag} {op} {variant}: the split launches "
                                 "differ from one launch")
    return x


def sharded_upwind_runner(case, visco=False):
    """A one-rank kernel ShardedUpwindRunner (halo lanes) on a case, with
    upwind_runner's material and Q."""
    from seigen_tpu_torch.bench.throughput import BENCH_MAT
    from seigen_tpu_torch.ops import build_upwind_data, build_visco
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.parallel import ShardedUpwindRunner

    dm, p, src, damp, dt, _ = case
    f0 = src.f0[0].item() if src is not None else 1.0
    v = build_visco(p, 30.0, 20.0, 0.25 * f0, 2.5 * f0, L=3) if visco \
        else None
    w = build_upwind_data(dm, BENCH_MAT, dtype=p.dtype, device=p.device)
    return ShardedUpwindRunner(p, detect_structured(dm), w, dt, 1, src=src,
                               damp=damp, visco=v, fill_mode="ppermute",
                               impl="kernel")


def seeded_state(dm, dev, seed=7):
    """Phase 4's numpy-seeded random float32 state (seed 8: phase 7's on
    the scrambled case)."""
    import numpy as np
    import torch

    from seigen_tpu_torch.solver.timestep import State

    E, n_p = dm.num_elements, dm.re.n_p
    rng = np.random.default_rng(seed)
    return State(
        u=torch.as_tensor(rng.standard_normal((E, n_p, 3)), device=dev
                          ).float(),
        s=torch.as_tensor(rng.standard_normal((E, n_p, 6)), device=dev
                          ).float())


def sharded_rank(comm, path):
    """One rank of phase 15's multi-rank run: ShardedFusedRunner (kernels)
    on the n=24 P3 case from phase 4's state for RUNNER_STEPS steps, then
    the same with the overlap split, then the fused_sharded bench on the
    first runner; rank 0 writes the global state and a JSON record next
    to ``path``."""
    import numpy as np
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.parallel import ShardedFusedRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = comm.device
    case = throughput.setup_case(n=24, degree=3, device=dev)
    dm, p, src, damp, dt, state0 = case
    r = ShardedFusedRunner(p, detect_structured(dm), dt, comm.world,
                           src=src, damp=damp, impl="kernel", comm=comm)
    st = seeded_state(dm, dev)
    reset_counts()
    out, _ = r.run(st, RUNNER_STEPS)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    split = ShardedFusedRunner(p, detect_structured(dm), dt, comm.world,
                               src=src, damp=damp, impl="kernel", comm=comm,
                               overlap=True)
    out_s, _ = split.run(st, RUNNER_STEPS)
    bitwise = torch.equal(out.u, out_s.u) and torch.equal(out.s, out_s.s)
    del split, out_s
    res = throughput.measure(p, src, damp, dt, state0, dm,
                             n_steps=BENCH_STEPS, runner=r)
    if comm.rank == 0:
        np.savez(path, u=out.u.cpu().numpy(), s=out.s.cpu().numpy())
        with open(path + ".json", "w") as f:
            json.dump({"counts": counts, "split_bitwise": bitwise,
                       "rate": res.dof_updates_per_sec,
                       "ms_step": 1e3 * res.seconds / res.n_steps,
                       "halo_bytes_per_step": r.halo_bytes_per_step(),
                       "backend": comm.backend}, f)


def sharded_bench(runner, impl, case, tag, **extra):
    """The bench record of a sharded runner already built on ``case``."""
    from seigen_tpu_torch.bench import throughput

    dm, p, src, damp, dt, state0 = case
    res = throughput.measure(p, src, damp, dt, state0, dm,
                             n_steps=BENCH_STEPS, runner=runner)
    rec = throughput.report(res, impl, "kernel", p.device)
    rec["detail"].update(
        shards=runner.P, fill_mode=getattr(runner, "fill_mode", "ppermute"),
        overlap=getattr(runner, "_split", None) is not None,
        halo_bytes_per_step=runner.halo_bytes_per_step(), **extra)
    print(json.dumps(rec), flush=True)
    log(f"[sharded] bench {tag}: {rec['value']:.4e} DOF-updates/s, "
        f"{1e3 * res.seconds / res.n_steps:.4f} ms a step")
    return rec


def phase_sharded(dev, case, st, out_k, check, merged_rec):
    """Phase 15 (see the module docstring); returns (launches, (kernel
    ms, plain ms), bounds) of the halo-plan kernels."""
    import os
    import tempfile

    import numpy as np
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.ops import upwind_kernels as uk
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.parallel import ShardedFusedRunner, \
        ShardedLaneRunner
    from seigen_tpu_torch.parallel.comm import spawn
    from seigen_tpu_torch.solver.lane_major import LaneMajorRunner

    t0 = time.perf_counter()
    # the kernels on halo plans and their lane ranges, small meshes
    for dim, degree in ((3, 3), (3, 2), (2, 3), (2, 2)):
        r = small_sharded_runner(dim, degree, dev)
        log(f"[sharded] {dim}D P{degree}: NC {r.plan.NC}, NCt "
            f"{r.plan.NCt}, h0 {r.plan.h0}, split {r._split}")
        compare_split(r, check, f"halo {dim}D P{degree}",
                      seed=50 + 10 * dim + degree)
    for dim in (3, 2):
        r = small_sharded_runner(dim, 1, dev, packed=True)
        log(f"[sharded] packed {dim}D P1: NC {r.plan.NC}, split {r._split}")
        compare_split(r, check, f"halo pk {dim}D P1", seed=70 + dim)
    small_halo_k3(dev, check)
    log(f"[sharded] halo-plan kernels agree ({time.perf_counter() - t0:.1f}"
        " s)")

    # one rank at full width: the fill modes and the split
    dm, p, src, damp, dt, _ = case
    ex = detect_structured(dm)
    runs = {}
    for mode, overlap in (("off", False), ("local", False), ("skip", False),
                          ("ppermute", False), ("ppermute", True)):
        tag = mode + (", split" if overlap else "")
        r = ShardedFusedRunner(p, ex, dt, 1, src=src, damp=damp,
                               fill_mode=mode, overlap=overlap,
                               impl="kernel")
        reset_counts()
        out, _ = r.run(st, RUNNER_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
        k = 3 * RUNNER_STEPS * (2 if r._split else 1)
        log(f"[sharded] 1 rank, fill {tag}: split {r._split}, "
            f"{k // RUNNER_STEPS} K1 + {k // RUNNER_STEPS} K2 a step")
        expect_counts(f"sharded {tag}", counts, merged_vel=k,
                      merged_stress=k)
        if mode == "off":
            if not (torch.equal(out.u, out_k.u)
                    and torch.equal(out.s, out_k.s)):
                raise AssertionError("fill off: not bitwise the "
                                     "MergedLaneRunner run")
            log("[sharded] fill off: bitwise equal to MergedLaneRunner")
        else:
            compare_states(f"sharded {tag}", out, out_k,
                           "vs MergedLaneRunner")
        runs[tag] = r
        if tag == "ppermute, split":
            launches = {"merged_vel[split]": counts["merged_vel"],
                        "merged_stress[split]": counts["merged_stress"]}

    # lane and upwind (Q) at one rank against their one-device runners
    lk_run = LaneMajorRunner(p, ex, dt, src=src, damp=damp, impl="kernel")
    ls_run = ShardedLaneRunner(p, ex, dt, 1, src=src, damp=damp,
                               impl="kernel")
    ref, _ = lk_run.run(st, RUNNER_STEPS)
    reset_counts()
    out, _ = ls_run.run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    expect_counts("sharded lane", read_counts(),
                  lane_vel=3 * RUNNER_STEPS, lane_stress=3 * RUNNER_STEPS)
    compare_states("sharded lane", out, ref, "vs LaneMajorRunner")
    up_ref = upwind_runner(case, "kernel", visco=True)
    up_sh = sharded_upwind_runner(case, visco=True)
    ref, _ = up_ref.run(st, RUNNER_STEPS)
    reset_counts()
    out, _ = up_sh.run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("sharded upwind Q", counts, upwind_rhs=4 * RUNNER_STEPS)
    compare_states("sharded upwind Q", out, ref, "vs UpwindLaneRunner")
    launches["upwind_rhs[halo]"] = counts["upwind_rhs"]

    # the halo-plan kernels at n=24 P3: every variant, one launch and the
    # split pair, against the plain version; then their times (the split
    # pair, one launch, the plain version); K3 on the halo plan likewise
    times, bounds = {}, {}
    r = runs["ppermute, split"]
    lo, hi = r._split
    x = compare_split(r, check, "halo n=24 P3", seed=24)
    for op in ("vel", "stress"):
        kern, plain, args, kw = variant_call(r, x, op, "plain")
        kname = f"merged_{op}[split]"

        def pair():
            o = kern(*args, lanes=(lo, hi, 0))
            return kern(*args, lanes=(lo, hi, 1), out=o)

        t_pair, t_one = time_ms(pair), time_ms(lambda: kern(*args))
        times[kname] = (t_pair, time_ms(lambda: plain(*args)))
        bounds[kname] = bound(r.d, r.plan, kname.split("[")[0])
        log(f"[sharded] {kname} at n=24 P3: interior + boundary "
            f"{t_pair:.4f} ms, one launch on the halo plan {t_one:.4f} ms, "
            f"bound {bounds[kname][0]:.4f} ms; plain {times[kname][1]:.4f} "
            "ms")
    xu = upwind_inputs(up_sh, 31)
    ua = upwind_args(up_sh, xu)
    got, ref = uk.UPWIND_KERNEL(*ua), uk.upwind_rhs_merged_ref(*ua)
    torch.cuda.synchronize()
    check("upwind_rhs[halo]", "halo n=24 P3 du", got[0], ref[0])
    check("upwind_rhs[halo]", "halo n=24 P3 ds", got[1], ref[1])
    check("upwind_rhs[halo]", "halo n=24 P3 traces",
          own_lanes(up_sh.plan, got[2]), own_lanes(up_sh.plan, ref[2]))
    del got, ref
    times["upwind_rhs[halo]"] = (time_ms(lambda: uk.UPWIND_KERNEL(*ua)),
                                 time_ms(lambda: uk.upwind_rhs_merged_ref(
                                     *ua)))
    bounds["upwind_rhs[halo]"] = bound(up_sh.d, up_sh.plan, "upwind_rhs")
    log(f"[sharded] upwind_rhs[halo] at n=24 P3: "
        f"{times['upwind_rhs[halo]'][0]:.4f} ms, bound "
        f"{bounds['upwind_rhs[halo]'][0]:.4f} ms")
    del lk_run, ls_run, up_ref, up_sh, x, xu

    # the benches: one shard beside merged (phase 5), lane_sharded beside
    # lane (LF4), fused_sharded_pk beside merged_pk at n=32 P1
    log(f"[sharded] bench merged (phase 5): {merged_rec['value']:.4e} "
        "DOF-updates/s")
    for tag, rr in runs.items():
        sharded_bench(rr, "fused_sharded", case, tag)
    runs.clear()
    lane_rec = throughput.main(n=24, degree=3, n_steps=BENCH_STEPS,
                               impl="lane", case=case)
    print(json.dumps(lane_rec), flush=True)
    log(f"[sharded] bench lane LF4: {lane_rec['value']:.4e} DOF-updates/s")
    sharded_bench(ShardedLaneRunner(p, ex, dt, 1, src=src, damp=damp,
                                    impl="kernel"), "lane_sharded", case,
                  "lane_sharded LF4")
    pk = throughput.setup_case(n=32, degree=1, device=dev)
    pk_rec = throughput.main(n=32, degree=1, n_steps=BENCH_STEPS,
                             impl="merged_pk", case=pk)
    print(json.dumps(pk_rec), flush=True)
    log(f"[sharded] bench merged_pk n=32 P1: {pk_rec['value']:.4e}")
    dm1, p1, src1, damp1, dt1, _ = pk
    for mode in ("off", "ppermute"):
        sharded_bench(ShardedFusedRunner(p1, detect_structured(dm1), dt1, 1,
                                         src=src1, damp=damp1, packed=True,
                                         fill_mode=mode, impl="kernel"),
                      "fused_sharded_pk", pk,
                      f"fused_sharded_pk n=32 P1, fill {mode}")
    del pk

    # two ranks: NCCL with two cards, else gloo on the one card
    n_dev = torch.cuda.device_count()
    backend = "nccl" if n_dev >= 2 else "gloo"
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "two.npz")
        spawn(sharded_rank, 2, device="cuda", backend=backend, args=(path,))
        got = np.load(path)
        with open(path + ".json") as f:
            rec = json.load(f)
    out2 = type(out_k)(u=torch.as_tensor(got["u"], device=dev),
                       s=torch.as_tensor(got["s"], device=dev))
    log(f"[sharded] 2 ranks ({backend}, {n_dev} card(s)): rank 0 "
        f"launches K1 {rec['counts']['merged_vel']} "
        f"K2 {rec['counts']['merged_stress']} in {RUNNER_STEPS} steps, "
        f"{rec['rate']:.4e} DOF-updates/s, {rec['ms_step']:.4f} ms a step, "
        f"halo {rec['halo_bytes_per_step']} B a step a rank "
        f"({time.perf_counter() - t1:.1f} s)")
    compare_states("sharded 2 ranks", out2, out_k, "vs MergedLaneRunner")
    if not rec["split_bitwise"]:
        raise AssertionError("2 ranks: the split run is not bitwise the "
                             "unsplit one")
    log("[sharded] 2 ranks: the split run is bitwise the unsplit one")
    return launches, times, bounds


def dd_shots(case, n_shots=1):
    """Phase 16's shots on a bench case: blobs as the bench's source on
    phase 14's receiver line (x from 0.4 to 0.6), t0 = 0, stacked."""
    import numpy as np

    from seigen_tpu_torch.solver import PointSource, build_sources
    from seigen_tpu_torch.solver.shots import stack_shots

    dm, p = case[0], case[1]
    h = float(dm.h.min())
    z = GRAD_RCV_LINE[0][2]
    return stack_shots([build_sources(dm, [PointSource(
        position=(float(x), 0.5, z), f0=0.25 / h, t0=0.0, radius=2 * h)],
        device=p.device) for x in np.linspace(0.4, 0.6, n_shots)])


def dd_engine(case, engine, packed, shots, comm=None):
    """The kernel gradient engine of phase 16 on ``case``: LaneDiffFwi,
    or with ``comm`` the domain-decomposed engine on its ranks."""
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.parallel import ShardedLaneDiffFwi, \
        ShardedMergedDiffFwi, ShardedUnstructuredDiffFwi
    from seigen_tpu_torch.solver.lane_diff import LaneDiffFwi

    dm, p, _, damp, dt, _ = case
    ex = None if engine == "lane_u" else detect_structured(dm)
    args = (dt, DD_STEPS, shots, grad_rcv(case), None)
    kw = dict(damp=damp, segment=DD_SEGMENT, impl="kernel")
    if comm is None:
        return LaneDiffFwi(p, dm, ex, *args, engine=engine, packed=packed,
                           **kw)
    if engine == "lane_u":
        return ShardedUnstructuredDiffFwi(p, dm, *args, comm.world,
                                          comm=comm, **kw)
    if engine == "merged":
        return ShardedMergedDiffFwi(p, dm, ex, *args, comm.world,
                                    comm=comm, packed=packed, **kw)
    return ShardedLaneDiffFwi(p, dm, ex, *args, comm.world, comm=comm, **kw)


def dd_vp(case):
    """The case's vp per element (the model a phase 16 gradient is taken
    at)."""
    import torch

    p = case[1]
    return torch.sqrt((p.lam + 2 * p.mu) * p.inv_rho)


def dd_cases(dev, case=None, scase=None):
    """{"case", "scase", "pcase"}: phase 16's bench cases (``case`` and
    ``scase``: the ones already built)."""
    from seigen_tpu_torch.bench import throughput

    return {"case": case or throughput.setup_case(n=24, degree=3,
                                                  device=dev),
            "scase": scase or throughput.setup_case(n=24, degree=3,
                                                    device=dev,
                                                    scramble=True),
            "pcase": throughput.setup_case(n=32, degree=1, device=dev)}


def sharded_e2_rank(comm, tmp):
    """One rank of phase 16's multi-rank runs; rank 0 writes every result
    into ``tmp``: lane_u_sharded (state, launches, bench), the general
    path, the domain-decomposed gradients (observed data from the files
    the parent wrote) and shot-DP's."""
    import os

    import numpy as np
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.parallel import ShardedUnstructuredRunner
    from seigen_tpu_torch.parallel.dryrun import run_e2

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = comm.device
    out = {}
    cases = dd_cases(dev)
    sdm, sp, ssrc, sdamp, sdt, sst0 = cases["scase"]
    r = ShardedUnstructuredRunner(sp, sdt, comm.world,
                                  centroids=sdm.coords.mean(axis=1),
                                  src=ssrc, damp=sdamp, impl="kernel",
                                  comm=comm)
    reset_counts()
    st, _ = r.run(seeded_state(sdm, dev, seed=8), RUNNER_STEPS)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    res = throughput.measure(sp, ssrc, sdamp, sdt, sst0, sdm,
                             n_steps=E2_BENCH_STEPS, runner=r)
    out["lane_u_sharded"] = {
        "counts": counts, "rate": res.dof_updates_per_sec,
        "ms_step": 1e3 * res.seconds / res.n_steps,
        "panel_bytes_per_step": r.halo_bytes_per_step(), "nb": r.nb,
        "lanes": r.d.E, "backend": comm.backend}
    if comm.rank == 0:
        np.savez(os.path.join(tmp, "lane_u.npz"), u=st.u.cpu().numpy(),
                 s=st.s.cpu().numpy())
    del r, st
    got, info = run_e2("general", comm, device=dev)
    out["general"] = {"info": info}
    if comm.rank == 0:
        np.savez(os.path.join(tmp, "general.npz"), **got)
    for tag, (cname, engine, packed) in DD_CASES.items():
        t0 = time.perf_counter()
        ldf = dd_engine(cases[cname], engine, packed,
                        dd_shots(cases[cname]), comm)
        ldf.observed = np.load(os.path.join(tmp, f"{tag}_obs.npy"))
        v, g = ldf.vg_factory(None)({"vp": dd_vp(cases[cname])})
        out[tag] = {"v": v, "seconds": time.perf_counter() - t0}
        if comm.rank == 0:
            np.save(os.path.join(tmp, f"{tag}_g.npy"),
                    g["vp"].cpu().numpy())
        del ldf
    t0 = time.perf_counter()
    ldf = dd_engine(cases["case"], "merged", False,
                    dd_shots(cases["case"], 2))
    ldf.observed = np.load(os.path.join(tmp, "shot_dp_obs.npy"))
    v, g = ldf.vg_factory_sharded(comm)(None)({"vp": dd_vp(cases["case"])})
    out["shot_dp"] = {"v": v, "seconds": time.perf_counter() - t0}
    if comm.rank == 0:
        np.save(os.path.join(tmp, "shot_dp_g.npy"), g["vp"].cpu().numpy())
        with open(os.path.join(tmp, "e2.json"), "w") as f:
            json.dump(out, f)


def compare_gradient(tag, v, g, v_ref, g_ref):
    """Phase 16's gradient bars: the misfit within DD_VALUE_REL, the vp
    gradient's cosine against the one-device engine's >= DD_MIN_COSINE."""
    import numpy as np

    g, g_ref = (np.asarray(x, np.float64).ravel() for x in (g, g_ref))
    cos = float(g @ g_ref / (np.linalg.norm(g) * np.linalg.norm(g_ref)))
    rel = abs(v - v_ref) / abs(v_ref)
    log(f"[sharded_e2] {tag}: misfit {v:.6e} (one device {v_ref:.6e}, rel "
        f"{rel:.3e}), vp gradient cosine {cos:.8f}, |g| "
        f"{np.abs(g_ref).max():.3e}")
    if not (np.isfinite(g).all() and cos >= DD_MIN_COSINE
            and rel <= DD_VALUE_REL and v_ref > 0):
        raise AssertionError(f"{tag}: gradient off (cosine {cos}, misfit "
                             f"rel {rel})")


def phase_sharded_e2(dev, case, scase, sst, check):
    """Phase 16 (see the module docstring); returns (launches, (kernel
    ms, plain ms), bounds) of K4 TRAC SEL / K5 SEL on a Morton block."""
    import os
    import tempfile

    import numpy as np
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.parallel import ShardedUnstructuredRunner
    from seigen_tpu_torch.parallel.comm import Comm, spawn
    from seigen_tpu_torch.parallel.dryrun import e2_close, run_e2
    from seigen_tpu_torch.solver.lane_unstructured import \
        UnstructuredLaneRunner

    t0 = time.perf_counter()
    sdm, sp, ssrc, sdamp, sdt, _ = scase
    kw = dict(centroids=sdm.coords.mean(axis=1), src=ssrc, damp=sdamp,
              impl="kernel")
    # the kernels at rank 0's shapes of a 2-rank layout (host plan only)
    r2 = ShardedUnstructuredRunner(sp, sdt, 2, comm=Comm(
        rank=0, world=2, device=dev), **kw)
    log(f"[sharded_e2] rank 0 of 2: {r2.d.E} lanes, {r2.nb} published "
        f"columns a rank, panel {r2._rows_pad} x {r2.nb} "
        f"({r2.halo_bytes_per_step()} B a step)")
    x = lane_inputs(r2, 160)
    times, bounds = {}, {}
    for kname, (base, _) in SHARDED_E2_MODES.items():
        mode = "SEL vel" if base == "lane_vel" else "SEL stress"
        kern, plain = lane_call(r2, x, mode)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        check(kname, f"shard 0 of 2 n=24 P3 {mode}", got, ref)
        times[kname] = (time_ms(kern), time_ms(plain))
        bounds[kname] = lane_bound(r2.d, mode)
        log(f"[sharded_e2] {kname}: kernel {times[kname][0]:.4f} ms, plain "
            f"{times[kname][1]:.4f} ms, bound {bounds[kname][0]:.4f} ms "
            f"({bounds[kname][1]})")
    del r2, x, got, ref

    # one rank: the main path's run against the one-device runner
    ref, _ = UnstructuredLaneRunner(sp, sdt, **kw).run(sst, RUNNER_STEPS)
    r1 = ShardedUnstructuredRunner(sp, sdt, 1, **kw)
    reset_counts()
    out, _ = r1.run(sst, RUNNER_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("lane_u_sharded 1 rank", counts,
                  lane_vel=3 * RUNNER_STEPS, lane_stress=3 * RUNNER_STEPS)
    compare_states("lane_u_sharded 1 rank", out, ref,
                   "vs UnstructuredLaneRunner")
    launches = {k: counts[base] for k, (base, _) in SHARDED_E2_MODES.items()}
    rec = throughput.main(n=24, degree=3, n_steps=BENCH_STEPS,
                          impl="lane_u", case=scase)
    print(json.dumps(rec), flush=True)
    log(f"[sharded_e2] bench lane_u: {rec['value']:.4e} DOF-updates/s")
    sharded_bench(r1, "lane_u_sharded", scase, "lane_u_sharded 1 rank")
    del r1, out
    log(f"[sharded_e2] one rank {time.perf_counter() - t0:.1f} s")

    # the one-device references of the multi-rank runs
    t1 = time.perf_counter()
    cases = dd_cases(dev, case, scase)
    n_dev = torch.cuda.device_count()
    backend = "nccl" if n_dev >= 2 else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        refs = {}
        for tag, (cname, engine, packed) in list(DD_CASES.items()) + [
                ("shot_dp", ("case", "merged", False))]:
            c = cases[cname]
            ldf = dd_engine(c, engine, packed,
                            dd_shots(c, 2 if tag == "shot_dp" else 1))
            vp = dd_vp(c)
            obs = ldf.synth({"vp": vp * DD_VP_SCALE})
            np.save(os.path.join(tmp, f"{tag}_obs.npy"), obs)
            ldf.observed = obs
            v, g = ldf.vg_factory(None)({"vp": vp})
            refs[tag] = (v, g["vp"].cpu().numpy())
            del ldf
        ref_general, _ = run_e2("general", None, device=dev)
        log(f"[sharded_e2] one-device references "
            f"{time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        spawn(sharded_e2_rank, 2, device="cuda", backend=backend,
              args=(tmp,))
        with open(os.path.join(tmp, "e2.json")) as f:
            rec = json.load(f)
        got = np.load(os.path.join(tmp, "lane_u.npz"))
        out2 = type(ref)(u=torch.as_tensor(got["u"], device=dev),
                         s=torch.as_tensor(got["s"], device=dev))
        lu = rec["lane_u_sharded"]
        log(f"[sharded_e2] 2 ranks ({backend}, {n_dev} card(s)), "
            f"lane_u_sharded: rank 0 {lu['lanes']} lanes, launches K4 "
            f"{lu['counts']['lane_vel']} K5 {lu['counts']['lane_stress']} "
            f"in {RUNNER_STEPS} steps, {lu['rate']:.4e} DOF-updates/s, "
            f"{lu['ms_step']:.4f} ms a step, panel {lu['nb']} columns, "
            f"{lu['panel_bytes_per_step']} B a step a rank "
            f"({time.perf_counter() - t1:.1f} s)")
        expect_counts("lane_u_sharded 2 ranks (rank 0)", lu["counts"],
                      lane_vel=3 * RUNNER_STEPS,
                      lane_stress=3 * RUNNER_STEPS)
        compare_states("lane_u_sharded 2 ranks", out2, ref,
                       "vs UnstructuredLaneRunner")
        err = e2_close(dict(np.load(os.path.join(tmp, "general.npz"))),
                       ref_general)
        log(f"[sharded_e2] general path, 2 ranks, f64: "
            f"{rec['general']['info']}; max rel. diff vs timestep.run "
            f"{err:.3e}")
        for tag, (v_ref, g_ref) in refs.items():
            g = np.load(os.path.join(tmp, f"{tag}_g.npy"))
            kind = "shot-DP" if tag == "shot_dp" else "DD"
            compare_gradient(f"{tag} {kind} gradient, 2 ranks "
                             f"({rec[tag]['seconds']:.1f} s)",
                             rec[tag]["v"], g, v_ref, g_ref)
    del out2, ref
    return launches, times, bounds


@contextlib.contextmanager
def numpy_setup():
    """The NumPy setup path for the block: ``native.available`` replaced,
    as tests/test_native.py forces it."""
    from seigen_tpu_torch.mesh import native

    keep = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = keep


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def fmt_secs(secs):
    return ", ".join(f"{t:.4f}" for t in secs)


def compare_meshes(tag, dm_nat, dm_np):
    """Integer maps and coordinates exactly equal, the geometry within
    |native - NumPy| <= NATIVE_RTOL |NumPy| + NATIVE_ATOL max|NumPy| (the
    absolute floor scales with the field: an entry that cancels to zero
    keeps a rounding error of the field's size, ~n at n cells an edge);
    returns the worst abs difference per field, and its share of the
    bound."""
    import numpy as np

    for name in ("nbr", "bc", "coords"):
        if not np.array_equal(getattr(dm_nat, name), getattr(dm_np, name)):
            raise AssertionError(f"[native] {tag}: {name} differs")
    worst = {}
    for name in NATIVE_GEOMETRY:
        a, b = getattr(dm_nat, name), getattr(dm_np, name)
        err = np.abs(a - b)
        tol = NATIVE_RTOL * np.abs(b) + NATIVE_ATOL * np.abs(b).max()
        worst[name] = (float(err.max()), float((err / tol).max()))
    if any(ratio > 1.0 for _, ratio in worst.values()):
        raise AssertionError(f"[native] {tag}: geometry beyond rtol "
                             f"{NATIVE_RTOL}, atol {NATIVE_ATOL} x max: "
                             f"{worst}")
    return worst


def native_meshes():
    """(a) build_discrete at n=24 and n=40 P3 on both paths, seconds."""
    from seigen_tpu_torch.mesh import box_mesh, build_discrete
    from seigen_tpu_torch.solver.damping import absorbing_bc_fn

    bc_fn = absorbing_bc_fn(((0.0, 1.0),) * 3, free_sides=[(2, "hi")])
    for n in NATIVE_SIZES:
        topo, t_mesh = timed(lambda: box_mesh(n, n, n))

        def build(numpy):
            with numpy_setup() if numpy else contextlib.nullcontext():
                return timed(lambda: build_discrete(topo, 3, bc_fn=bc_fn))

        # in turns at n=24 (NumPy, native, native, NumPy); once each above
        turns = (True, False, False, True) if n == 24 else (True, False)
        runs = [(numpy, *build(numpy)) for numpy in turns]
        secs = {k: [t for numpy, _, t in runs if numpy == (k == "numpy")]
                for k in ("numpy", "native")}
        worst = compare_meshes(f"n={n} P3", runs[1][1], runs[0][1])
        E = runs[0][1].num_elements
        log(f"[native] build_discrete n={n} P3 (E {E}): NumPy "
            f"{fmt_secs(secs['numpy'])} s, native {fmt_secs(secs['native'])}"
            f" s (native / NumPy {min(secs['native']) / min(secs['numpy']):.3f}"
            f"); box_mesh {t_mesh:.4f} s; nbr, bc, coords equal; worst "
            f"(|native - NumPy|, share of the bound) {worst}")


def native_plans(sdm):
    """(b) morton_order and make_plan on the scrambled case, both paths."""
    import numpy as np

    from seigen_tpu_torch.parallel.partition import make_plan, morton_order

    cent = sdm.coords.mean(axis=1)
    perm, t_nat = timed(lambda: morton_order(cent))
    with numpy_setup():
        perm_np, t_np = timed(lambda: morton_order(cent))
    if not np.array_equal(perm, perm_np):
        raise AssertionError("[native] morton_order differs")
    log(f"[native] morton_order on the scrambled n=24 P3 case "
        f"(E {sdm.num_elements}): NumPy {t_np:.4f} s, native {t_nat:.4f} "
        f"s; equal")
    plan, t_nat = timed(lambda: make_plan(sdm, NATIVE_SHARDS))
    with numpy_setup():
        plan_np, t_np = timed(lambda: make_plan(sdm, NATIVE_SHARDS))
    for f in dataclasses.fields(plan):
        a, b = getattr(plan, f.name), getattr(plan_np, f.name)
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b)
        if not same:
            raise AssertionError(f"[native] make_plan {f.name} differs")
    log(f"[native] make_plan(dm, {NATIVE_SHARDS}) on it: NumPy {t_np:.4f} "
        f"s, native {t_nat:.4f} s; every field equal (K {plan.n_rounds}, "
        f"H {plan.halo_max}, round_perms {plan.round_perms})")


def native_main_path(dev):
    """(c) setup_case at n=24 P3 both ways, in turns (NumPy, native,
    native, NumPy), the seconds to the first merged step; on the first case
    of each, 10 steps from one seeded state."""
    import torch

    from seigen_tpu_torch.bench import throughput
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner

    outs, secs = {}, {"numpy": [], "native": []}
    for label in ("numpy", "native", "native", "numpy"):
        with numpy_setup() if label == "numpy" else contextlib.nullcontext():
            t0 = time.perf_counter()
            case = throughput.setup_case(n=24, degree=3, device=dev)
            torch.cuda.synchronize()
            t_setup = time.perf_counter() - t0
            dm, p, src, damp, dt, state0 = case
            runner = MergedLaneRunner(p, detect_structured(dm), dt, src=src,
                                      damp=damp, impl="kernel")
            runner.run(state0, 1)
            torch.cuda.synchronize()
            secs[label].append((t_setup, time.perf_counter() - t0))
        if label in outs:
            continue
        reset_counts()
        outs[label], _ = runner.run(seeded_state(dm, dev), RUNNER_STEPS)
        torch.cuda.synchronize()
        expect_counts(f"[native] {label} case", read_counts(),
                      merged_vel=3 * RUNNER_STEPS,
                      merged_stress=3 * RUNNER_STEPS)
    for label, runs in secs.items():
        log(f"[native] setup_case n=24 P3 ({label}): "
            f"{fmt_secs(t for t, _ in runs)} s, first merged step done "
            f"{fmt_secs(t for _, t in runs)} s after the start")
    log(f"[native] {RUNNER_STEPS} steps on each case: 3 + 3 K1/K2 launches "
        f"a step")
    for name in ("u", "s"):
        a, b = getattr(outs["native"], name), getattr(outs["numpy"], name)
        rel = ((a - b).norm() / b.norm()).item()
        finite = bool(torch.isfinite(a).all())
        log(f"[native] {name}: rel L2 native case vs NumPy case {rel:.3e}, "
            f"finite {finite}")
        if not (finite and rel < NATIVE_MAX_REL):
            raise AssertionError(f"[native] state {name} off: rel {rel}")


def phase_native(dev, scase):
    """Phase 17: the native mesh-setup library on the setup path."""
    native_meshes()
    native_plans(scase[0])
    native_main_path(dev)


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
        from seigen_tpu_torch.mesh import native
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
    if not native.available():  # the host mesh library, on every setup
        raise RuntimeError(f"[build] the native mesh library is not "
                           f"available:\n{native.build_log()}")
    log(f"[build] {native.SRC.name}: g++ "
        f"{native.LIBRARY.build_seconds:.3f} s ({native.LIBRARY.path.name})")
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
    bench = {}
    for impl in ("kernel", "reference"):
        rec = bench[impl] = throughput.main(
            n=24, degree=3, n_steps=BENCH_STEPS, kernel_impl=impl, case=case)
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
    log(f"[cpml] phase {time.perf_counter() - t0:.1f} s")

    # 13. tools: the CLIs, the element-major wrappers, utils/, roofline
    t0 = time.perf_counter()
    phase_tools(dev, case, run_k, out_k, bench["kernel"])
    log(f"[tools] phase {time.perf_counter() - t0:.1f} s")

    # 14. gradients: the energy-conjugation engines over the kernels
    t0 = time.perf_counter()
    phase_gradients(dev, case, scase, smi)
    log(f"[grad] phase {time.perf_counter() - t0:.1f} s")

    # 15. sharded: the slab-sharded runners (parallel/), halo plans
    t0 = time.perf_counter()
    for have, new in zip((launches, times, bounds),
                         phase_sharded(dev, case, st, out_k, check,
                                       bench["kernel"])):
        have.update(new)
    log(f"[sharded] phase {time.perf_counter() - t0:.1f} s")

    # 16. sharded_e2: Morton blocks, the general path, sharded gradients
    t0 = time.perf_counter()
    for have, new in zip((launches, times, bounds),
                         phase_sharded_e2(dev, case, scase, sst, check)):
        have.update(new)
    log(f"[sharded_e2] phase {time.perf_counter() - t0:.1f} s")

    # 17. native: the C++ mesh-setup library against the NumPy setup
    t0 = time.perf_counter()
    phase_native(dev, scase)
    log(f"[native] phase {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    sources = dict(KERNELS)
    sources.update({m: (KERNELS[k][0], replaces)
                    for m, (k, replaces) in ANISO_MODES.items()})
    # the packed layout runs the packed tile kernel
    sources.update({m: ("seigen_tpu_torch/csrc/merged_tile.cuh", replaces)
                    for m, (_, replaces) in PACKED_MODES.items()})
    sources.update({m: (KERNELS[k][0], KERNELS[k][1])
                    for m, k in SHARDED_MODES.items()})
    sources.update({m: (KERNELS[k][0], replaces)
                    for m, (k, replaces) in SHARDED_E2_MODES.items()})
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
