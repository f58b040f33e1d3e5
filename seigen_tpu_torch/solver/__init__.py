from .damping import absorbing_bc_fn, sponge_mask
from .receivers import ReceiverData, build_receivers, line, sample
from .source import PointSource, SourceData, build_sources, ricker
from .timestep import State, cfl_dt, make_step, run

__all__ = [
    "absorbing_bc_fn",
    "sponge_mask",
    "ReceiverData",
    "build_receivers",
    "line",
    "sample",
    "PointSource",
    "SourceData",
    "build_sources",
    "ricker",
    "State",
    "cfl_dt",
    "make_step",
    "run",
]
