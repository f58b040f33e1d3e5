"""One run of one cell: set-up, warm-up, the measured window, the traced
numbers, the check against the reference, and the result line.

A run does, in order:

1. set-up: the inputs from the seed, the port's case (span "mesh") and
   runner (span "runner");
2. warm-up: the first chunk, from the zero state; ``setup_s`` ends when
   its seismograms reach the host;
3. the window: whole chunks of the runner's ``run(state, k, step0)`` until
   ``--seconds`` have passed; it ends at the host copy of the last chunk's
   seismograms.  The rate counts every step of the window over all of its
   time.  With ``--trace 1`` the first ``trace_chunks`` chunks run under
   ``torch.profiler``, and after the window a short lane-major run gives
   the host's enqueue time per step;
4. the peak device memory, then the program is freed and the reference
   follows the first chunk and the window's last (``check.py``).

A run drives one card from one process: this harness runs one-chip cells.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import counts
from .check import Reference, compare, verdict
from .inputs import make_inputs
from .layout import Layout
from .trace import reduce

FORBIDDEN = ("jax", "jaxlib", "flax", "seigen_tpu")
_ACTIVITIES = (torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is exactly a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _program(inp, traffic, device, spans):
    from .program import Program

    return Program(inp, traffic, device, spans)


def drive(name, seed, seconds, trace, layout, device, t_start,
          make_program=_program):
    """Everything up to the check; returns the run's record (with the
    chunks the check needs), the inputs, the cell and its run mix."""
    cell = layout.cell(name)
    cfg, traffic = layout.config(cell["config"]), layout.traffic(
        cell["traffic"])
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    inp = make_inputs(cfg, seed)
    spans = {}
    prog = make_program(inp, traffic, device, spans)
    k = int(traffic["chunk_steps"])
    st0 = prog.state0
    st1, seis0 = prog.run(st0, k, 0)  # warm-up: every shape the window uses
    _sync(device)
    gc.collect()  # set-up's garbage, not a pause inside the window
    setup_s = time.time() - t_start

    n_trace = int(traffic.get("trace_chunks", 2)) if trace else 0
    if n_trace:  # the profiler's own start-up stays out of the window
        with torch.profiler.profile(activities=_ACTIVITIES):
            torch.ones(1, device=device).add_(1)
            _sync(device)
    prof = None
    st, n, chunks = st1, k, 0
    traced_s = traced_end = None
    t0 = time.perf_counter()
    marks = [t0]  # each chunk's end: its seismograms on the host
    while True:
        if chunks == 0 and n_trace:
            prof = torch.profiler.profile(activities=_ACTIVITIES)
            prof.start()
        st_in, step_in = st, n
        st, seis = prog.run(st, k, n)
        n += k
        chunks += 1
        marks.append(time.perf_counter())
        if prof is not None and chunks == n_trace:
            _sync(device)
            traced_s = time.perf_counter() - t0
            prof.stop()  # the trace's processing: outside both timings
            traced_end = time.perf_counter()
        if time.perf_counter() - t0 >= seconds and chunks > n_trace:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = chunks * k

    rec = {"window_s": window_s, "steps": steps, "chunks": chunks,
           "chunk_s": np.diff(marks).tolist(),
           "setup_s": setup_s, "spans": spans,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if trace:
        rec["trace"] = reduce(prof, traced_s, n_trace * k)
        after = steps - n_trace * k
        rec["ms_per_step"] = (1e3 * (t0 + window_s - traced_end) / after
                              if after else None)
        m = int(traffic.get("enqueue_steps", 5))
        rec["enqueue_ms_per_step"] = 1e3 * prog.enqueue_probe(st, m, n) / m
    rec["shape"] = dict(dim=inp.vertices.shape[1], E=inp.E,
                        n_p=st0.u.shape[1], nf=inp.cells.shape[1],
                        n_fp=_n_fp(inp.vertices.shape[1], inp.degree))
    rec["chunks_kept"] = dict(start=(st0, st1, seis0, k, 0),
                              last=(st_in, st, seis, k, step_in))
    del prog
    return rec, inp, cell, traffic


def _n_fp(dim, degree):
    return math.comb(degree + dim - 1, dim - 1)


def finish(rec, inp, cell, traffic, layout, name, trace, device):
    """The check and the result line (a dict)."""
    chunks = rec.pop("chunks_kept")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = Reference(inp, traffic["scheme"], device)
    t1 = time.perf_counter()
    numbers = {}
    for label in ("start", "last"):
        st_in, st_out, seis, k, step0 = chunks[label]
        numbers.update(compare(ref, label, st_in, st_out, seis, k, step0))
    _sync(device)
    print(f"setup {rec['setup_s']:.3f} s (mesh {rec['spans']['mesh']:.3f}, "
          f"runner {rec['spans']['runner']:.3f}); window "
          f"{rec['window_s']:.3f} s, {rec['steps']} steps; reference set-up "
          f"{t1 - t0:.3f} s, steps {time.perf_counter() - t1:.3f} s",
          file=sys.stderr)
    c = rec["chunk_s"]
    print(f"chunk seconds: first {c[0]:.4f}, median {np.median(c):.4f}, "
          f"last {c[-1]:.4f}, min {min(c):.4f}, max {max(c):.4f}",
          file=sys.stderr)
    ok, failed, checks = verdict(numbers, cell.get("limits", {}))

    sh = rec["shape"]
    rate = counts.dof(sh["E"], sh["n_p"], sh["dim"]) * rec["steps"] \
        / rec["window_s"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": ok, "attempted": 2, "failed": failed}  # chunks checked
    if not trace:
        out["metrics"] = {
            traffic["rate_metric"]: {"value": rate,
                                     "unit": "DOF-updates/s"},
            "setup_s": {"value": rec["setup_s"], "unit": "s"}}
    else:
        tr = rec["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        ctx = SimpleNamespace(
            on_card=device.type == "cuda", spans=rec["spans"],
            shape=sh,
            scheme=traffic["scheme"], family=traffic.get("kernel_family"),
            group_ms={g: 1e3 * s for g, s in tr["group_s_per_step"].items()},
            busy_s=tr["busy_s"], window_s=tr["window_s"],
            enqueue_ms=rec["enqueue_ms_per_step"],
            ms_per_step=rec["ms_per_step"])
        metrics = {}
        for m in layout.per_layer(name, {traffic["rate_metric"],
                                         "setup_s"}):
            v = layout.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["metrics"] = metrics
        out["breakdown"] = tr["breakdown"]
    out["device"] = dev
    out["checks"] = checks
    return out


def run(name, seed, seconds, trace, layout=None, device="cuda",
        t_start=None, make_program=_program):
    """One run of cell ``name``; ``make_program(inputs, traffic, device,
    spans)`` builds the system under test (the port's, unless a test
    breaks it)."""
    layout = layout or Layout()
    t_start = time.time() if t_start is None else t_start
    chips = int(layout.cell(name)["chips"])
    if chips != 1:
        raise ValueError(f"{name} asks for {chips} chips; this harness "
                         "runs one-chip cells")
    rec, inp, cell, traffic = drive(name, seed, seconds, trace, layout,
                                    device, t_start, make_program)
    return finish(rec, inp, cell, traffic, layout, name, trace,
                  torch.device(device))
