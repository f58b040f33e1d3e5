"""Domain-decomposed FWI gradients on unstructured meshes.

Port of ``seigen_tpu/parallel/unstructured_diff_sharded.py``:
``LaneDiffFwi(engine="lane_u")`` with its runner a
``ShardedUnstructuredRunner`` (K4 TRAC SEL / K5 SEL on a Morton block a
rank, one all-gathered trace panel per operator, forward and backward);
the scaffold is parallel/dd_diff_base.py.
"""

from __future__ import annotations

import numpy as np

from .dd_diff_base import DomainDecomposedFwi
from .unstructured_sharded import ShardedUnstructuredRunner


class ShardedUnstructuredDiffFwi(DomainDecomposedFwi):
    """Morton-block sharded FWI value-and-gradient on arbitrary conforming
    meshes."""

    def __init__(self, p0, dm, dt: float, n_steps: int, shots, receivers,
                 observed, n_shards: int, *, order: int = 4, damp=None,
                 segment: int | None = None, impl: str | None = None,
                 comm=None):
        super().__init__(p0, dm, None, dt, n_steps, shots, receivers,
                         observed, n_shards, engine="lane_u", comm=comm,
                         order=order, damp=damp, segment=segment, impl=impl)

    def _sharded_runner(self, pf, dm, ex, dt, order, damp, impl, packed):
        return ShardedUnstructuredRunner(
            pf, dt, self.n_shards, order=order, damp=damp, impl=impl,
            centroids=np.asarray(dm.coords.mean(axis=1)), comm=self.comm)
