from .curvilinear import CurviParams, build_curvi, curved_coords, \
    make_curvi_ops
from .elastic import (
    ElasticParams,
    Material,
    apply_stress_op,
    apply_vel_op,
    build_params,
    n_sig_for,
    params_from_numpy,
    voigt_map,
)
from .upwind import (
    UpwindData,
    apply_coupled_upwind,
    build_upwind_data,
    upwind_data_from_numpy,
)
from .viscoelastic import ViscoData, build_visco, visco_from_numpy

__all__ = [
    "CurviParams",
    "build_curvi",
    "curved_coords",
    "make_curvi_ops",
    "ElasticParams",
    "Material",
    "apply_stress_op",
    "apply_vel_op",
    "build_params",
    "n_sig_for",
    "params_from_numpy",
    "voigt_map",
    "UpwindData",
    "apply_coupled_upwind",
    "build_upwind_data",
    "upwind_data_from_numpy",
    "ViscoData",
    "build_visco",
    "visco_from_numpy",
]
