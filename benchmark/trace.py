"""Reduction of a ``torch.profiler`` trace to the benchmark's numbers.

Kernels are grouped by name (the port's operator kernels by their tile
template and its arguments; NCCL's kernels; PyTorch's gather/index,
elementwise, copy and matmul kernels), a group's time and the device's
busy time are the unions of their kernels' intervals, and the idle gaps
between kernels are labelled by the innermost host operation under way at
each gap's middle.  The grouping is a frozen copy of the port's
step-profile grouping.
"""

from __future__ import annotations

import numpy as np
import torch


def _targs(name: str) -> list:
    return [a.strip() for a in name[name.index("<") + 1:
                                    name.index(">")].split(",")]


def _true(a: str) -> bool:
    return a in ("true", "(bool)1")


def kernel_group(name: str) -> str:
    """K1 merged_vel / K2 merged_stress (K8/K9 fused_*2, "[pk]" packed),
    K4 lane_vel / K5 lane_stress, K6 lane_upwind_rhs / K7
    lane_upwind_axpy, K3 upwind_rhs, K10 trace_exchange; "nccl"; PyTorch's
    kernels by kind; "other"."""
    if "lane_stress_tile_kernel" in name:
        return "lane_stress"
    if "lane_vel_tile_kernel" in name:
        return "lane_vel"
    if "merged_tile_kernel" in name or "merged_tile_pk_kernel" in name:
        a = _targs(name)
        op = "vel" if _true(a[3]) else "stress"
        pk = "[pk]" if "merged_tile_pk_kernel" in name else ""
        return (f"fused_{op}2" if _true(a[-1]) else f"merged_{op}") + pk
    if "lane_upwind_tile_kernel" in name:
        return ("lane_upwind_axpy" if _true(_targs(name)[3])
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


def _union(iv):
    """Merged [start, end) intervals of a start-sorted list."""
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof, window_s: float, steps: int, n_gaps: int = 200) -> dict:
    """busy_s, group seconds per step, the breakdown's top device groups
    and the longest idle gaps by host operation."""
    dev, host = [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, *r))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((e.name, *r))
    spans: dict = {}  # a group's kernels may overlap (NCCL's streams)
    for name, a, b in dev:
        spans.setdefault(kernel_group(name), []).append((a, b))
    groups = {g: sum(b - a for a, b in _union(sorted(iv))) * 1e-6
              for g, iv in spans.items()}
    merged = _union(sorted((a, b) for _, a, b in dev))
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1],
                    0.5 * (merged[i + 1][0] + merged[i][1]))
                   for i in range(len(merged) - 1)), reverse=True)[:n_gaps]
    idle: dict = {}
    if host and gaps:
        names = [h[0] for h in host]
        hs = np.array([h[1] for h in host], dtype=np.float64)
        he = np.array([h[2] for h in host], dtype=np.float64)
        for length, mid in gaps:
            under = np.flatnonzero((hs <= mid) & (he >= mid))
            label = ("(python)" if not len(under)
                     else names[under[np.argmax(hs[under])]])
            idle[label] = idle.get(label, 0.0) + length * 1e-6
    top = sorted(groups.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy,
        "window_s": window_s,
        "steps": steps,
        "group_s_per_step": {k: v / steps for k, v in top},
        "breakdown": {
            "device_ops": [[k, v] for k, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:10]]},
    }
