"""Slab-sharded upwind-RK4 (+ viscoelastic) runner.

Port of ``seigen_tpu/parallel/upwind_sharded.py:ShardedUpwindRunner``.  The
slab decomposition, the halo trace plan, the fill and the source and
receiver handling are ``ShardedFusedRunner``'s (``SlabRunner``, on a plan
with pay = 2*dim payload rows a face: velocity and traction); the step is
``UpwindLaneRunner.step_with``'s RK4 on K3 (``upwind_rhs_merged``), with
the halo filled before every stage's operator — four fills a step, the
one-device data flow plus the plane exchange.  The trace carry across
stages stays linear, so a stage input's halo lanes are refilled from the
neighbour's stage input.  Viscoelastic memory variables are elementwise
and shard with the state.  No overlap split: K3 runs one launch a stage.
"""

from __future__ import annotations

from ..ops.structured_exchange import StructuredExchange
from ..ops.upwind import UpwindData
from ..ops.viscoelastic import ViscoData
from ..solver.lane_upwind import UpwindLaneRunner
from ..solver.receivers import ReceiverData
from ..solver.source import SourceData
from . import comm as _comm
from .fused_sharded import SlabRunner


class ShardedUpwindRunner(SlabRunner, UpwindLaneRunner):
    """RK4 + Godunov flux on a slab of the sharded merged layout (rank
    ``comm.rank`` of ``n_shards``; n_shards | G0).  Arguments as
    UpwindLaneRunner's, with ``n_shards``, ``fill_mode`` and ``comm`` as
    ShardedFusedRunner's."""

    _fills_per_step = 4  # one before each RK4 stage's operator

    def __init__(self, p, ex: StructuredExchange, w: UpwindData, dt: float,
                 n_shards: int, src: SourceData | None = None, damp=None,
                 receivers: ReceiverData | None = None,
                 fill_mode: str = "auto", visco: ViscoData | None = None,
                 impl: str | None = None, comm: _comm.Comm | None = None):
        self._slab_setup(ex, n_shards, comm, fill_mode, False, p.device)
        super().__init__(p, ex, w, dt, src=src, damp=damp,
                         receivers=receivers, impl=impl, visco=visco)
        op = self._rhs_op

        def rhs(plan, d, uwg, ulm, slm, trs, mask, **kw):
            return op(plan, d, uwg, ulm, slm, self._fill(trs), mask, **kw)

        self._rhs_op = rhs

    def run_xi(self, *args, **kwargs):
        """Refused: the one-device runner's chunk loop over standard-layout
        xi would read this rank's slab only; the JAX runner has no such
        method either."""
        raise NotImplementedError("ShardedUpwindRunner runs from a State "
                                  "(run, run_lm); it has no run_xi")
