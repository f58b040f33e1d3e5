"""The system under test: the port's set-up and runners, driven as the
explosive-source CLI drives them (``run(state, k, step0)`` chunks, the
seismograms on the host once a chunk).

The only module of the benchmark that imports the port, and only its
public set-up and runner API (``mesh``, ``ops``, ``solver``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from seigen_tpu_torch.mesh import MeshTopology, build_discrete
from seigen_tpu_torch.ops import Material, build_params, \
    build_upwind_data, n_sig_for
from seigen_tpu_torch.ops.structured_exchange import detect_structured
from seigen_tpu_torch.solver import PointSource, State, absorbing_bc_fn, \
    build_receivers, build_sources, sponge_mask

from .inputs import Inputs


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port's case and runner for one cell; ``spans`` gets the
    seconds of its set-up layers ("mesh", "runner")."""

    def __init__(self, inp: Inputs, traffic: dict, device, spans: dict,
                 dtype=torch.float32):
        self.device = torch.device(device)
        t0 = time.perf_counter()
        topo = MeshTopology(
            vertices=inp.vertices, cells=inp.cells, extents=inp.extents,
            structure=None if inp.grid is None else (inp.grid, 6))
        dm = build_discrete(topo, inp.degree, bc_fn=absorbing_bc_fn(
            inp.extents, list(inp.free_sides)))
        mat = Material(rho=inp.rho, vp=inp.vp, vs=inp.vs)
        kw = dict(dtype=dtype, device=self.device)
        p = build_params(dm, mat, **kw)
        src = build_sources(dm, [PointSource(
            position=inp.source, f0=inp.f0, radius=inp.radius)], **kw)
        rcv = build_receivers(dm, inp.receivers, **kw)
        damp = torch.as_tensor(sponge_mask(
            dm, list(inp.absorb_sides), width=inp.sponge_width),
            device=self.device).to(dtype)
        w = (build_upwind_data(dm, mat, **kw)
             if traffic["runner"] == "upwind" else None)
        _sync(self.device)
        spans["mesh"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.runner = self._runner(traffic, dm, p, src, rcv, damp, w,
                                   inp.dt)
        _sync(self.device)
        spans["runner"] = time.perf_counter() - t0
        E, n_p, dim = dm.num_elements, dm.re.n_p, dm.dim
        self.state0 = State(
            u=torch.zeros((E, n_p, dim), **kw),
            s=torch.zeros((E, n_p, n_sig_for(dim)), **kw))

    @staticmethod
    def _runner(traffic, dm, p, src, rcv, damp, w, dt):
        kw = dict(src=src, damp=damp, receivers=rcv)
        kind = traffic["runner"]
        if kind == "lane_u":
            from seigen_tpu_torch.solver.lane_unstructured import \
                UnstructuredLaneRunner

            return UnstructuredLaneRunner(
                p, dt, order=4, centroids=np.asarray(dm.coords.mean(axis=1)),
                **kw)
        ex = detect_structured(dm)
        if ex is None:
            raise ValueError(f"runner {kind!r} needs a structured mesh")
        if kind == "merged":
            from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner

            return MergedLaneRunner(p, ex, dt, packed="auto", **kw)
        if kind == "upwind":
            from seigen_tpu_torch.solver.lane_upwind import UpwindLaneRunner

            return UpwindLaneRunner(p, ex, w, dt, **kw)
        raise ValueError(f"unknown runner {kind!r}")

    def run(self, state, k: int, step0: int):
        """One chunk: (State, seismograms numpy (k, R, dim))."""
        return self.runner.run(state, k, step0=step0)

    def enqueue_probe(self, state, steps: int, step0: int) -> float:
        """Host seconds of a ``steps``-step lane-major run before its
        synchronise (the launch queue never fills at this length)."""
        ulm, slm = self.runner.to_lm_state(state)
        _sync(self.device)
        t0 = time.perf_counter()
        self.runner.run_lm(ulm, slm, steps, step0)
        t = time.perf_counter() - t0
        _sync(self.device)
        return t
