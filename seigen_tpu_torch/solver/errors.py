"""Quadrature-exact L2 errors vs analytic solutions (host-side, f64).

Port of ``seigen_tpu/solver/errors.py`` (NumPy, copied): integrate
|f_h - f_exact|^2 with the reference quadrature on every element.  Nodal
fields may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

import numpy as np

from ..mesh.discrete import DiscreteMesh


def _host(x) -> np.ndarray:
    """float64 numpy copy of an array or tensor."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def l2_error(dm: DiscreteMesh, nodal: np.ndarray, exact_fn, t: float) -> float:
    """L2 norm of (nodal DG field - exact_fn(x, t)) over the mesh.

    nodal: (E, n_p, C); exact_fn(points (..., dim), t) -> (..., C).
    """
    re = dm.re
    nodal = _host(nodal)
    xq = np.einsum("qi,eid->eqd", re.Vq, dm.coords)  # (E, nq, dim)
    fh = np.einsum("qi,eic->eqc", re.Vq, nodal)  # (E, nq, C)
    fe = exact_fn(xq, t)
    diff2 = np.sum((fh - fe) ** 2, axis=-1)  # (E, nq)
    return float(np.sqrt(np.einsum("e,q,eq->", dm.detJ, re.qw, diff2)))


def l2_norm(dm: DiscreteMesh, nodal: np.ndarray) -> float:
    C = nodal.shape[-1]
    zero = lambda x, t: np.zeros(x.shape[:-1] + (C,))
    return l2_error(dm, nodal, zero, 0.0)


def interpolate(dm: DiscreteMesh, fn, t: float = 0.0) -> np.ndarray:
    """Nodal interpolant of fn(x, t) -> (E, n_p, C) (for initial conditions)."""
    vals = fn(dm.coords, t)
    return np.asarray(vals, dtype=np.float64)


def convergence_order(hs, errs) -> float:
    """Least-squares slope of log(err) vs log(h)."""
    hs, errs = np.asarray(hs, float), np.asarray(errs, float)
    return float(np.polyfit(np.log(hs), np.log(errs), 1)[0])
