"""Domain-decomposed FWI gradients on the slab-sharded merged operators.

Port of ``seigen_tpu/parallel/merged_diff_sharded.py``: ``LaneDiffFwi
(engine="merged")`` with its runner a ``ShardedFusedRunner`` (K1/K2, with
``packed`` the P1 K1pk/K2pk; each application seeds its input's own-face
traces and fills the halo trace lanes before the kernel); the scaffold is
parallel/dd_diff_base.py.
"""

from __future__ import annotations

from .dd_diff_base import DomainDecomposedFwi
from .fused_sharded import ShardedFusedRunner


class ShardedMergedDiffFwi(DomainDecomposedFwi):
    """Slab-sharded FWI value-and-gradient on the merged operators (LF4,
    structured meshes, n_shards | G0)."""

    def __init__(self, p0, dm, ex, dt: float, n_steps: int, shots,
                 receivers, observed, n_shards: int, *, damp=None,
                 segment: int | None = None, impl: str | None = None,
                 packed: bool | str = False, comm=None):
        super().__init__(p0, dm, ex, dt, n_steps, shots, receivers,
                         observed, n_shards, engine="merged", comm=comm,
                         damp=damp, segment=segment, impl=impl,
                         packed=packed)

    def _sharded_runner(self, pf, dm, ex, dt, order, damp, impl, packed):
        return ShardedFusedRunner(pf, ex, dt, self.n_shards, damp=damp,
                                  impl=impl, packed=packed, comm=self.comm)
