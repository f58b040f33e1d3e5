"""Step profile of a lane runner on one GPU: where the device time goes.

    python -m seigen_tpu_torch.bench.profile_step --impl upwind_lane
    python -m seigen_tpu_torch.bench.profile_step --impl merged
    python -m seigen_tpu_torch.bench.profile_step --impl merged_pk --degree 1 \
        --n 32                # and --impl merged at the same size
    python -m seigen_tpu_torch.bench.profile_step --impl fused
    python -m seigen_tpu_torch.bench.profile_step --impl lane --order 2
    python -m seigen_tpu_torch.bench.profile_step --impl lane_u
    python -m seigen_tpu_torch.bench.profile_step --impl merged --vti
    python -m seigen_tpu_torch.bench.profile_step --impl upwind_lane_u
    python -m seigen_tpu_torch.bench.profile_step --impl upwind_lane_u \
        --panel-emit          # or --no-fused-axpy: the glue stepper
    python -m seigen_tpu_torch.bench.profile_step --impl cpml
    python -m seigen_tpu_torch.bench.profile_step --impl pallas
    python -m seigen_tpu_torch.bench.profile_step --kernel-impl reference
    python -m seigen_tpu_torch.bench.profile_step --impl fused_sharded \
        --ranks 2             # rank 0 of 2 NCCL ranks, one card each

On the bench case (``throughput.setup_case``, n=24 P3 by default; impls
"lane_u" and "upwind_lane_u" on its scrambled variant), from a zero state
with the blob source and sponge (impl "cpml": CpmlLaneRunner, RK4 with a
C-PML of width 0.15 on the sponge's five sides in place of the sponge;
impl "pallas": the einsum LF4 step of timestep.run on the element-major
wrappers of ops/lane_kernels.py:make_pallas_ops, K4 SIG / K5 TR on the
card whatever ``--kernel-impl`` says):

- wall per step: host clock over ``--steps`` steps ending in
  ``torch.cuda.synchronize()``;
- host enqueue per step: host clock of a 5-step run before its
  synchronize (few enough launches that the launch queue never blocks);
- device busy per step, device idle share of the profiled device span and
  device time by kernel group (the port's operator kernels by name;
  PyTorch's gather/index, elementwise, copy/cat and matmul kernels as
  groups):
  ``torch.profiler`` over ``--profile-steps`` steps;
- peak device memory of one run (``max_memory_allocated``);
- copy bandwidth: a 1 GiB device-to-device copy, read + write bytes.

Prints one JSON line with the GPU's name and power limit.  With
``--ranks N`` a sharded impl runs on N NCCL ranks, one card each (the
shard count as ``throughput --ranks``), and rank 0 prints its own
profile; NCCL's kernels are the group "nccl".  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops.lane_kernels import make_pallas_ops
from ..ops.structured_exchange import detect_structured
from ..solver import timestep
from ..solver.lane_cpml import CpmlLaneRunner
from ..utils.profiling import device_profile
from .pml_ab import sides_for
from .throughput import (
    IMPLS,
    SCRAMBLED_IMPLS,
    SHARDED_IMPLS,
    add_upwind_u_arguments,
    add_vti_argument,
    gpu_name_and_power_limit,
    make_runner,
    scheme_name,
    setup_case,
    sharded_ranks,
    upwind_u_options,
)


def copy_bandwidth(device, n_bytes=1 << 30, reps=10) -> float:
    """Bytes/s of a device-to-device copy (each byte read and written)."""
    x = torch.empty(n_bytes // 4, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    y.copy_(x)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        y.copy_(x)
    stop.record()
    torch.cuda.synchronize(device)
    return 2 * n_bytes * reps / (start.elapsed_time(stop) * 1e-3)


def _template_args(name: str) -> list:
    """The template arguments of a kernel name, as strings."""
    return [a.strip() for a in
            name[name.index("<") + 1 : name.index(">")].split(",")]


def _is_true(arg: str) -> bool:
    return arg in ("true", "(bool)1")


def kernel_group(name: str) -> str:
    """The port's operator kernels by name: the tile kernels by their
    template arguments — ``merged_tile_kernel<DIM, NP, NFP, VEL, ANISO,
    V2>`` is K1 (VEL), K2, or with V2 K8 (VEL) or K9;
    ``merged_tile_pk_kernel<DIM, NP, NFP, VEL, V2>`` is K1 (VEL), K2, K8
    (VEL and V2; K11 too) or K9 (V2) on the packed P1 layout (the suffix
    "[pk]"); ``lane_vel_tile_kernel`` is K4, ``lane_stress_tile_kernel``
    K5; ``lane_upwind_tile_kernel<DIM, NP, NFP, AXPY>`` is K7 (AXPY) or
    K6; ``upwind_tile_kernel`` is K3 —, and K10; NCCL's kernels (the
    sharded runners' exchanges) and PyTorch's gather/index (the lane
    runners' trace exchanges), elementwise, copy and matmul kernels as
    groups; anything else as "other"."""
    if "lane_stress_tile_kernel" in name:
        return "lane_stress"
    if "lane_vel_tile_kernel" in name:
        return "lane_vel"
    if "merged_tile_kernel" in name or "merged_tile_pk_kernel" in name:
        args = _template_args(name)  # VEL the fourth, V2 the last
        op = "vel" if _is_true(args[3]) else "stress"
        pk = "[pk]" if "merged_tile_pk_kernel" in name else ""
        return (f"fused_{op}2" if _is_true(args[-1]) else f"merged_{op}") + pk
    if "lane_upwind_tile_kernel" in name:
        return ("lane_upwind_axpy" if _is_true(_template_args(name)[3])
                else "lane_upwind_rhs")
    if "upwind_tile_kernel" in name:
        return "upwind_rhs"
    if "trace_exchange_kernel" in name:
        return "trace_exchange"
    if name.startswith("nccl"):
        return "nccl"
    if "gather" in name or "index" in name.lower():
        return "pytorch gather/index"
    if "elementwise_kernel" in name:
        return "pytorch elementwise"
    if "copy" in name.lower():
        return "pytorch copy/cat"
    if "gemm" in name:
        return "pytorch matmul"
    return "other"


def _device_events(prof):
    """(name, start_us, end_us) of every kernel the profiler saw."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def profile(impl="upwind_lane", kernel_impl="kernel", n=24, degree=3,
            steps=50, profile_steps=10, device="cuda", order=4, vti=False,
            comm=None, **upwind_u) -> dict:
    """The profile record (see the module docstring); ``comm``: this
    rank's Comm for a sharded impl (default: one rank)."""
    if comm is not None:
        device = comm.device
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the step profile measures a CUDA device; none "
                           "is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dm, p, src, damp, dt, state0 = setup_case(
        n=n, degree=degree, device=device,
        scramble=(impl in SCRAMBLED_IMPLS))
    if impl == "cpml":
        runner = CpmlLaneRunner(p, dm, detect_structured(dm), dt,
                                sides_for(3), 0.15, 2.0,
                                f0=float(src.f0[0]), src=src,
                                impl=kernel_impl)
        carry = runner.init_carry(state0)

        def run(n):
            runner.run_lm(carry, n)
    elif impl == "pallas":
        vel, stress = make_pallas_ops(p)

        def run(n):
            timestep.run(p, state0, dt, n, src=src, damp=damp, vel_op=vel,
                         stress_op=stress)
    else:
        runner = make_runner(impl, dm, p, src, damp, dt, kernel_impl,
                             order=order, vti=vti, comm=comm, **upwind_u)
        ulm, slm = runner.to_lm_state(state0)

        def run(n):
            runner.run_lm(ulm, slm, n)

    def sync():
        torch.cuda.synchronize(device)

    run(5)  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    run(steps)
    sync()
    wall = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated(device)

    t0 = time.perf_counter()
    run(5)
    enqueue = (time.perf_counter() - t0) / 5
    sync()

    with device_profile() as prof:
        run(profile_steps)
        sync()
    ev = _device_events(prof)
    by_group: dict = {}
    for name, a, b in ev:
        g = kernel_group(name)
        by_group[g] = by_group.get(g, 0.0) + (b - a)
    busy = 0.0
    span = 0.0
    if ev:
        ev.sort(key=lambda x: x[1])
        span = max(b for _, _, b in ev) - ev[0][1]
        cur_a, cur_b = ev[0][1], ev[0][2]
        for _, a, b in ev[1:]:  # union of the kernel intervals
            if a > cur_b:
                busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy += cur_b - cur_a
    total = sum(by_group.values())
    groups = sorted(by_group.items(), key=lambda kv: -kv[1])
    name, limit = gpu_name_and_power_limit(torch.device(device).index or 0)
    return {
        "impl": impl,
        "kernel_impl": kernel_impl,
        "scheme": ("RK4" if impl == "cpml" else "LF4" if impl == "pallas"
                   else scheme_name(impl, order)),
        "vti": bool(vti),
        **upwind_u,
        "case": {"n": n, "degree": degree, "elements": dm.num_elements},
        "ranks": 1 if comm is None else comm.world,
        "gpu": name,
        "power_limit": limit,
        "wall_ms_per_step": wall * 1e3,
        "host_enqueue_ms_per_step": enqueue * 1e3,
        "device_busy_ms_per_step": busy * 1e-3 / profile_steps,
        "device_idle_share": (1.0 - busy / span) if span else None,
        "device_kernels_per_step": len(ev) / profile_steps,
        "device_ms_per_step_by_group": {
            k: v * 1e-3 / profile_steps for k, v in groups},
        "device_share_by_group": {k: v / total for k, v in groups},
        "peak_memory_mib": peak / 2**20,
        "copy_gb_per_s": copy_bandwidth(device) / 1e9,
    }


def _rank_profile(comm, args, kw):
    rec = profile(*args, comm=comm, **kw)
    if comm.rank == 0:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", default="upwind_lane",
                    choices=IMPLS + ("cpml", "pallas"))
    ap.add_argument("--kernel-impl", default="kernel",
                    choices=("kernel", "reference"))
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--profile-steps", type=int, default=10)
    ap.add_argument("--order", type=int, default=4, choices=(2, 4),
                    help="LF order of the lane and lane_u runners")
    ap.add_argument("--ranks", type=int, default=1,
                    help="sharded impls: spawn this many NCCL ranks")
    add_vti_argument(ap)
    add_upwind_u_arguments(ap)
    a = ap.parse_args()
    args = (a.impl, a.kernel_impl, a.n, a.degree, a.steps, a.profile_steps)
    kw = dict(order=a.order, vti=a.vti, **upwind_u_options(a))
    if a.ranks > 1:
        if a.impl not in SHARDED_IMPLS:
            raise SystemExit(f"--ranks needs a sharded impl {SHARDED_IMPLS}")
        from ..parallel.comm import spawn

        spawn(_rank_profile, sharded_ranks(a.n, a.ranks), device="cuda",
              backend="nccl", args=(args, kw))
    else:
        print(json.dumps(profile(*args, **kw)))
