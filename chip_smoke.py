#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (seigen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device   - require a CUDA device; print nvidia-smi's name and power limit.
2. build    - compile the merged operator kernels (K1 merged_vel, K2
              merged_stress) from seigen_tpu_torch/csrc with nvcc.
3. kernels  - every kernel variant (vel plain/axpy/inject with 1 and 2
              groups; stress plain/axpy+damp/inject with 1 and 2 groups)
              against its plain PyTorch version on the card in float32, on
              box_mesh(4, 4, 4) at P3 and P2.
4. runner   - the main path: MergedLaneRunner on the n=24 P3 explosive-
              source case (E = 82 944) for 10 steps from a numpy-seeded
              random state, kernels vs plain versions; launch counts,
              finiteness; then every variant again at these shapes, with
              each kernel's time beside its plain version's.
5. bench    - seigen_tpu_torch.bench.throughput.main (100 steps) with the
              kernels and with the plain versions on the same case.

Tolerance of a kernel against its plain version: |k - p| <= rtol*|p| +
atol*max|p| with rtol = 2e-4, atol = 2e-5.  The absolute floor is taken
relative to the output's largest magnitude because float32 rounding of
the ~1e3-1e4-sized operator terms leaves absolute errors of ~1e-4 in
outputs that happen to be near zero, for the plain version as much as for
the kernel.

Output: the JSON lines of phase 5, then the nvidia-smi line, one JSON line
describing the kernels, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

RTOL, ATOL = 2e-4, 2e-5
RUNNER_STEPS = 10
BENCH_STEPS = 100
TIMING_REPS = 20
SIDES = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
KERNEL_SOURCE = "seigen_tpu_torch/csrc/merged_kernels.cu"


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
        from seigen_tpu_torch.ops import merged_kernels as mk
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

    # 2. build
    t0 = time.perf_counter()
    secs = mk.VEL_KERNEL.build()
    mk.STRESS_KERNEL.build()
    log(f"[build] {KERNEL_SOURCE}: nvcc {secs:.1f} s "
        f"(phase {time.perf_counter() - t0:.1f} s)")
    for ln in mk.LIBRARY.ptxas_report().splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"  ptxas: {ln.strip()}")

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
    mk.VEL_KERNEL.launches = mk.STRESS_KERNEL.launches = 0
    out_k, _ = run_k.run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    launches = {"merged_vel": mk.VEL_KERNEL.launches,
                "merged_stress": mk.STRESS_KERNEL.launches}
    out_r, _ = run_r.run(st, RUNNER_STEPS)
    torch.cuda.synchronize()
    log(f"[runner] {RUNNER_STEPS} steps: launches {launches}")
    for name, n in launches.items():
        if n != 3 * RUNNER_STEPS:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{RUNNER_STEPS} steps, expected "
                                 f"{3 * RUNNER_STEPS}")
    for name in ("u", "s"):
        a, b = getattr(out_k, name), getattr(out_r, name)
        rel = ((a - b).norm() / b.norm()).item()
        finite = bool(torch.isfinite(a).all())
        nrm = a.norm().item()
        log(f"[runner] {name}: rel L2 kernel vs plain {rel:.3e}, norm "
            f"{nrm:.4e}, finite {finite}")
        if not (finite and nrm > 0 and rel < 1e-4):
            raise AssertionError(f"runner state {name} off: rel {rel}")

    # every variant at the main path's shapes, with kernel and plain times
    x = compare_variants(run_k, check, "n=24 P3", seed=24)
    times = {}
    for op, variant in (("vel", "plain"), ("stress", "plain")):
        kern, plain, args, kw = variant_call(run_k, x, op, variant)
        kname = "merged_vel" if op == "vel" else "merged_stress"
        times[kname] = (time_ms(lambda: kern(*args, **kw)),
                        time_ms(lambda: plain(*args, **kw)))
        log(f"[runner] {kname} ({variant}) at n=24 P3: kernel "
            f"{times[kname][0]:.4f} ms, plain {times[kname][1]:.4f} ms")
    log(f"[runner] phase {time.perf_counter() - t0:.1f} s")

    # 5. bench: kernels and plain versions on the same case
    t0 = time.perf_counter()
    for impl in ("kernel", "reference"):
        rec = throughput.main(n=24, degree=3, n_steps=BENCH_STEPS,
                              kernel_impl=impl, case=case)
        if not (np.isfinite(rec["value"]) and rec["value"] > 0):
            raise AssertionError(f"bench {impl}: bad rate {rec['value']}")
        print(json.dumps(rec), flush=True)
    log(f"[bench] phase {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    replaces = {"merged_vel": "seigen_tpu/ops/merged_kernels.py:542",
                "merged_stress": "seigen_tpu/ops/merged_kernels.py:582"}
    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": check.worst[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in replaces]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
