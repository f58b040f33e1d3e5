"""The command's refusals: no result without a card, and none from the
benchmark's files alone."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CMD = [sys.executable, "-m", "benchmark.run", "--workload",
       "layered-n40-p3.merged-lf4", "--seed", "3000000000", "--seconds",
       "1", "--trace", "0"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run")
    out = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
