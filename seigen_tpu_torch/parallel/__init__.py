"""The sharded paths: one process a rank, slabs of a structured mesh, halo
planes over ``torch.distributed`` (``comm``).

``ShardedFusedRunner`` (merged LF4, K1/K2 and packed K1pk/K2pk, with the
halo trace lanes and the interior/boundary overlap), ``ShardedLaneRunner``
(lane-major LF2/LF4 on K4/K5) and ``ShardedUpwindRunner`` (upwind RK4 on
K3, viscoelastic Q).  The JAX package's general unstructured path
(``make_plan``, ``make_sharded_run``) is not ported yet.
"""

from .fused_sharded import ShardedFusedRunner
from .lane_sharded import ShardedLaneRunner
from .partition import morton_order
from .upwind_sharded import ShardedUpwindRunner

__all__ = [
    "ShardedFusedRunner",
    "ShardedLaneRunner",
    "ShardedUpwindRunner",
    "morton_order",
]
