"""The sharded paths: one process a rank, ``torch.distributed`` between
them (``comm``).

Slab-sharded structured meshes: ``ShardedFusedRunner`` (merged LF4, K1/K2
and packed K1pk/K2pk, with the halo trace lanes and the interior/boundary
overlap), ``ShardedLaneRunner`` (lane-major LF2/LF4 on K4/K5) and
``ShardedUpwindRunner`` (upwind RK4 on K3, viscoelastic Q).  Any conforming
mesh: ``ShardedUnstructuredRunner`` (Morton blocks, K4/K5 SEL over
all-gathered trace panels) and the general einsum path (``run_distributed``
over ``make_plan``).  The domain-decomposed FWI gradients:
``ShardedLaneDiffFwi``, ``ShardedMergedDiffFwi``,
``ShardedUnstructuredDiffFwi`` (dd_diff_base.py).
"""

from .dist_ops import (
    make_sharded_run,
    run_distributed,
    shard_params,
    shard_receivers,
    shard_sources,
    shard_state,
    unshard_field,
)
from .fused_sharded import ShardedFusedRunner
from .lane_diff_sharded import ShardedLaneDiffFwi
from .lane_sharded import ShardedLaneRunner
from .merged_diff_sharded import ShardedMergedDiffFwi
from .partition import Plan, make_plan, morton_order
from .unstructured_diff_sharded import ShardedUnstructuredDiffFwi
from .unstructured_sharded import ShardedUnstructuredRunner
from .upwind_sharded import ShardedUpwindRunner

__all__ = [
    "Plan",
    "ShardedFusedRunner",
    "ShardedLaneDiffFwi",
    "ShardedLaneRunner",
    "ShardedMergedDiffFwi",
    "ShardedUnstructuredDiffFwi",
    "ShardedUnstructuredRunner",
    "ShardedUpwindRunner",
    "make_plan",
    "make_sharded_run",
    "morton_order",
    "run_distributed",
    "shard_params",
    "shard_receivers",
    "shard_sources",
    "shard_state",
    "unshard_field",
]
