"""Region timers, run reports and device traces.

Port of ``seigen_tpu/utils/profiling.py``: an accumulating wall-clock
region timer (which synchronises the device of the tensor it is given
before the clock stops), JSON run reports, and a ``torch.profiler`` trace
of the CPU and the CUDA device written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


class RegionTimer:
    """Accumulating wall-clock regions; .report() -> dict of seconds."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def region(self, name: str, sync: torch.Tensor | None = None):
        """Time the block; ``sync``: a tensor whose device (CUDA) is
        synchronised before the clock stops, so the region holds the
        device work it enqueued."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.device.type == "cuda":
                torch.cuda.synchronize(sync.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {"seconds": self.totals[name], "calls": self.counts[name]}
            for name in self.totals
        }


@contextlib.contextmanager
def device_profile():
    """``torch.profiler`` over the CPU and, where there is one, the CUDA
    device; yields the profiler (read it after the block)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block (``device_profile``) and write its Chrome trace
    into ``logdir`` as ``trace_<time>_<pid>.json``; yields the profiler.
    Synchronise the device inside the block so the trace holds its
    kernels."""
    os.makedirs(logdir, exist_ok=True)
    with device_profile() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
        ".json"))


def write_run_report(path: str, config: dict, timings: dict,
                     extra: dict | None = None):
    """Structured per-run JSON: config, timings and result pointers."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"config": config, "timings": timings}
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
