"""Where the benchmark finds a cell, its configuration, its run mix and
its per-layer metrics: one file each, by the name ``BENCHMARK.json``
gives.

    benchmark/workloads/<cell>.json   config, traffic, chips, why, limits
    benchmark/configs/<config>.json   the deployment: mesh, model, physics
    benchmark/traffic/<traffic>.json  the run mix: runner, scheme, chunks
    benchmark/metrics/<metric>.py     read(ctx) -> number or None

A later cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


class Layout:
    def __init__(self, bench_dir: Path | str = BENCH_DIR):
        self.dir = Path(bench_dir)

    def _json(self, kind: str, name: str) -> dict:
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r} "
                                    f"({path})")
        return json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def benchmark(self) -> dict:
        """BENCHMARK.json beside the benchmark's folder ({} if absent)."""
        path = self.dir.parent / "BENCHMARK.json"
        return json.loads(path.read_text()) if path.is_file() else {}

    def per_layer(self, cell: str, reported: set) -> list:
        """The per-layer metrics of ``cell``: those that list it, and those
        without a list whose end-to-end metric the cell reports."""
        out = []
        for m in self.benchmark().get("per_layer", []):
            cells = m.get("workloads")
            if (cell in cells) if cells is not None else (
                    m["moves"] in reported):
                out.append(m)
        return out

    def reader(self, metric: str):
        """``read(ctx)`` of ``metrics/<metric>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
