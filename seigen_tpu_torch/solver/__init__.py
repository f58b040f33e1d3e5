from .analytic import ExplosionGreens3D, ForceGreens3D, MomentGreens3D, \
    PlaneWave
from .damping import absorbing_bc_fn, sponge_mask
from .errors import convergence_order, interpolate, l2_error, l2_norm
from .lane_cpml import CpmlLaneRunner
from .lane_fused import FusedLaneRunner
from .pml import CpmlState, cpml_init, cpml_profiles, make_cpml_rhs, \
    run_cpml
from .receivers import ReceiverData, build_receivers, grid, line, sample
from .rk4 import make_rk4_step, run_rk4, run_rk4_visco
from .simulation import ElasticSimulation, SimConfig
from .source import PointSource, SourceData, build_sources, \
    kinematic_rupture, ricker
from .timestep import State, cfl_dt, make_step, run, staggered_init

__all__ = [
    "ExplosionGreens3D",
    "ForceGreens3D",
    "MomentGreens3D",
    "PlaneWave",
    "absorbing_bc_fn",
    "sponge_mask",
    "convergence_order",
    "interpolate",
    "l2_error",
    "l2_norm",
    "FusedLaneRunner",
    "CpmlLaneRunner",
    "CpmlState",
    "cpml_init",
    "cpml_profiles",
    "make_cpml_rhs",
    "run_cpml",
    "ReceiverData",
    "build_receivers",
    "grid",
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
    "kinematic_rupture",
    "ricker",
    "State",
    "cfl_dt",
    "make_step",
    "run",
    "staggered_init",
]
