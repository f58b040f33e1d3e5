"""Element locality ordering along a Morton (Z-order) curve.

Port of ``seigen_tpu/parallel/partition.py:morton_order`` (its NumPy
bit-interleave; the port has no ``mesh/native`` C++ twin).  The rest of that
module (the multi-chip partition and halo plan) is not ported yet.
"""

from __future__ import annotations

import numpy as np


def morton_order(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting points along a Morton (Z-order) curve."""
    p = points - points.min(axis=0)
    scale = p.max(axis=0)
    scale[scale == 0] = 1.0
    q = np.minimum((p / scale * (2**bits - 1)).astype(np.uint64), 2**bits - 1)
    dim = points.shape[1]
    code = np.zeros(len(points), dtype=np.uint64)
    for b in range(bits):
        for d in range(dim):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * dim + d
            )
    return np.argsort(code, kind="stable")
