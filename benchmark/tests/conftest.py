"""Fixtures of the benchmark's CPU tests: one torch thread, and a tiny
copy of the benchmark's data (box 4 x 4 x 4, P2, 5-step chunks)
in which the harness runs on the CPU with the port's plain versions."""

import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    """A benchmark folder whose cells are the real ones at a tiny size."""
    root = tmp_path_factory.mktemp("bench")
    d = root / "benchmark"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / sub, d / sub)
    for f in (d / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["mesh"]["n"], c["degree"] = [4, 4, 4], 2
        f.write_text(json.dumps(c))
    for f in (d / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["chunk_steps"] = 5
        f.write_text(json.dumps(t))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    return d


def card():
    """Skip unless a CUDA device is present (decided inside a test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
