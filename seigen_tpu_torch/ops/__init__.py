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

__all__ = [
    "ElasticParams",
    "Material",
    "apply_stress_op",
    "apply_vel_op",
    "build_params",
    "n_sig_for",
    "params_from_numpy",
    "voigt_map",
]
