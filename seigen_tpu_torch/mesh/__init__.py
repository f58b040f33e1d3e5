from .structured import MeshTopology, rect_mesh, box_mesh
from .discrete import (
    DiscreteMesh,
    build_discrete,
    BC_INTERIOR,
    BC_FREE,
    BC_ABSORB,
    BC_RIGID,
)

__all__ = [
    "MeshTopology",
    "rect_mesh",
    "box_mesh",
    "DiscreteMesh",
    "build_discrete",
    "BC_INTERIOR",
    "BC_FREE",
    "BC_ABSORB",
    "BC_RIGID",
]
