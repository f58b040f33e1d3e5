"""Command-line programs of the port, run as modules:

    python -m seigen_tpu_torch.cli.explosive_source --dim 3 --n 24 --degree 3
    python -m seigen_tpu_torch.cli.eigenmode2d --sizes 4,8,16 --min-order 2.8
    python -m seigen_tpu_torch.cli.eigenmode3d --degrees 1,2 --sizes 2,4
    python -m seigen_tpu_torch.cli.topography --vtk out/topo.pvd
    python -m seigen_tpu_torch.cli.precision_study

Each ``main(argv=None) -> int`` runs on the CUDA device; ``--cpu`` asks
for the CPU.  Without ``--cpu`` and without a CUDA device a program exits
non-zero: nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def pick_device(cpu: bool) -> torch.device:
    """The run's device: the CPU when asked for, else the first CUDA
    device; SystemExit when there is none.  TF32 products are switched
    off on the card: every operator runs in FP32 (or FP64)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port's programs run on the "
                         "card; pass --cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def run_dtype(f64: bool) -> torch.dtype:
    return torch.float64 if f64 else torch.float32
