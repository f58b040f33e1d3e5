"""Receiver (seismogram) sampling.

Port of ``seigen_tpu/solver/receivers.py``: each receiver is located once at
setup into (element, basis-weight) pairs; per-step sampling is a tiny gather
+ dot, and the stacked per-step samples are the (n_steps, R, C) seismogram.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.discrete import DiscreteMesh


@dataclass(frozen=True)
class ReceiverData:
    elems: torch.Tensor  # (R,) int64
    weights: torch.Tensor  # (R, n_p) basis values at receiver points


def build_receivers(
    dm: DiscreteMesh, points: np.ndarray, dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> ReceiverData | None:
    if points is None or len(points) == 0:
        return None
    elems, xi = dm.locate_points(np.asarray(points, dtype=np.float64))
    phi = dm.re.eval_basis(xi)  # (R, n_p)
    return ReceiverData(
        elems=torch.as_tensor(elems, device=device),
        weights=torch.as_tensor(phi, device=device).to(dtype),
    )


def sample(rcv: ReceiverData, field: torch.Tensor) -> torch.Tensor:
    """(R, C) samples of a nodal field (E, n_p, C)."""
    vals = field[rcv.elems]  # (R, n_p, C)
    return torch.einsum("ri,ric->rc", rcv.weights, vals)


def line(start, end, n) -> np.ndarray:
    """n receiver points on the segment [start, end] (inclusive)."""
    start, end = np.asarray(start, float), np.asarray(end, float)
    t = np.linspace(0.0, 1.0, n)[:, None]
    return start[None] * (1 - t) + end[None] * t


def grid(x_range, y_range, nx, ny, z) -> np.ndarray:
    """nx*ny points on the z=const plane over x_range x y_range (3D areal
    acquisition, a seismic-survey patch)."""
    xs = np.linspace(*x_range, nx)
    ys = np.linspace(*y_range, ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    return np.stack(
        [X.ravel(), Y.ravel(), np.full(X.size, float(z))], axis=1)
