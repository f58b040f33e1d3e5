"""Step profile of a lane runner on one GPU: where the device time goes.

    python -m seigen_tpu_torch.bench.profile_step --impl upwind_lane
    python -m seigen_tpu_torch.bench.profile_step --impl merged
    python -m seigen_tpu_torch.bench.profile_step --impl fused
    python -m seigen_tpu_torch.bench.profile_step --impl lane --order 2
    python -m seigen_tpu_torch.bench.profile_step --impl lane_u
    python -m seigen_tpu_torch.bench.profile_step --impl merged --vti
    python -m seigen_tpu_torch.bench.profile_step --impl upwind_lane_u
    python -m seigen_tpu_torch.bench.profile_step --impl upwind_lane_u \
        --panel-emit          # or --no-fused-axpy: the glue stepper
    python -m seigen_tpu_torch.bench.profile_step --kernel-impl reference

On the bench case (``throughput.setup_case``, n=24 P3 by default; impls
"lane_u" and "upwind_lane_u" on its scrambled variant), from a zero state
with the blob source and sponge:

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

Prints one JSON line with the GPU's name and power limit.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .throughput import (
    IMPLS,
    SCRAMBLED_IMPLS,
    add_upwind_u_arguments,
    add_vti_argument,
    gpu_name_and_power_limit,
    make_runner,
    scheme_name,
    setup_case,
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


OPERATOR_KERNELS = ("merged_vel_kernel", "merged_stress_kernel",
                    "lane_upwind_kernel", "upwind_rhs_kernel",
                    "lane_vel_kernel", "lane_stress_kernel",
                    "trace_exchange_kernel")


def _last_bool(name: str) -> bool:
    """The value of the last template argument of a kernel name, a bool."""
    head = name.split(">")[0].rstrip()
    return head.endswith("true") or head.endswith("(bool)1")


def kernel_group(name: str) -> str:
    """The port's operator kernels by name; PyTorch's gather/index (the
    lane runners' trace exchanges), elementwise, copy and matmul kernels
    as groups; anything else as "other"."""
    for k in OPERATOR_KERNELS:
        if k in name:
            if k == "lane_upwind_kernel":  # K7 is its AXPY = true instance
                return ("lane_upwind_axpy" if _last_bool(name)
                        else "lane_upwind_rhs")
            if k.startswith("merged_") and _last_bool(name):  # V2: K8/K9
                return ("fused_vel2" if k == "merged_vel_kernel"
                        else "fused_stress2")
            return k.removesuffix("_kernel")
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
            **upwind_u) -> dict:
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the step profile measures a CUDA device; none "
                           "is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dm, p, src, damp, dt, state0 = setup_case(
        n=n, degree=degree, device=device,
        scramble=(impl in SCRAMBLED_IMPLS))
    runner = make_runner(impl, dm, p, src, damp, dt, kernel_impl,
                         order=order, vti=vti, **upwind_u)
    ulm, slm = runner.to_lm_state(state0)

    def sync():
        torch.cuda.synchronize(device)

    runner.run_lm(ulm, slm, 5)  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    runner.run_lm(ulm, slm, steps)
    sync()
    wall = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated(device)

    t0 = time.perf_counter()
    runner.run_lm(ulm, slm, 5)
    enqueue = (time.perf_counter() - t0) / 5
    sync()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        runner.run_lm(ulm, slm, profile_steps)
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
        "scheme": scheme_name(impl, order),
        "vti": bool(vti),
        **upwind_u,
        "case": {"n": n, "degree": degree, "elements": dm.num_elements},
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


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", default="upwind_lane", choices=IMPLS)
    ap.add_argument("--kernel-impl", default="kernel",
                    choices=("kernel", "reference"))
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--profile-steps", type=int, default=10)
    ap.add_argument("--order", type=int, default=4, choices=(2, 4),
                    help="LF order of the lane and lane_u runners")
    add_vti_argument(ap)
    add_upwind_u_arguments(ap)
    a = ap.parse_args()
    opts = upwind_u_options(a)
    print(json.dumps(profile(a.impl, a.kernel_impl, a.n, a.degree, a.steps,
                             a.profile_steps, order=a.order, vti=a.vti,
                             **opts)))
