from .analytic import PlaneWave
from .damping import absorbing_bc_fn, sponge_mask
from .errors import convergence_order, interpolate, l2_error, l2_norm
from .receivers import ReceiverData, build_receivers, line, sample
from .rk4 import make_rk4_step, run_rk4, run_rk4_visco
from .simulation import ElasticSimulation, SimConfig
from .source import PointSource, SourceData, build_sources, ricker
from .timestep import State, cfl_dt, make_step, run, staggered_init

__all__ = [
    "PlaneWave",
    "absorbing_bc_fn",
    "sponge_mask",
    "convergence_order",
    "interpolate",
    "l2_error",
    "l2_norm",
    "ReceiverData",
    "build_receivers",
    "line",
    "sample",
    "make_rk4_step",
    "run_rk4",
    "run_rk4_visco",
    "ElasticSimulation",
    "SimConfig",
    "PointSource",
    "SourceData",
    "build_sources",
    "ricker",
    "State",
    "cfl_dt",
    "make_step",
    "run",
    "staggered_init",
]
