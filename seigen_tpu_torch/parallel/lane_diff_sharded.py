"""Domain-decomposed FWI gradients on the slab-sharded lane operators.

Port of ``seigen_tpu/parallel/lane_diff_sharded.py``: ``LaneDiffFwi
(engine="lane")`` with its runner a ``ShardedLaneRunner`` (K4 SIG / K5 TR
on a slab a rank, halo planes by the ring exchange); the scaffold is
parallel/dd_diff_base.py.
"""

from __future__ import annotations

from .dd_diff_base import DomainDecomposedFwi
from .lane_sharded import ShardedLaneRunner


class ShardedLaneDiffFwi(DomainDecomposedFwi):
    """Slab-sharded FWI value-and-gradient on the lane operators
    (structured meshes, n_shards | G0)."""

    def __init__(self, p0, dm, ex, dt: float, n_steps: int, shots,
                 receivers, observed, n_shards: int, *, order: int = 4,
                 damp=None, segment: int | None = None,
                 impl: str | None = None, comm=None):
        super().__init__(p0, dm, ex, dt, n_steps, shots, receivers,
                         observed, n_shards, engine="lane", comm=comm,
                         order=order, damp=damp, segment=segment, impl=impl)

    def _sharded_runner(self, pf, dm, ex, dt, order, damp, impl, packed):
        return ShardedLaneRunner(pf, ex, dt, self.n_shards, order=order,
                                 damp=damp, impl=impl, comm=self.comm)
