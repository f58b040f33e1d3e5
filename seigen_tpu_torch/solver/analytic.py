"""Analytic solutions for verification: travelling elastic plane waves.

Port of ``seigen_tpu/solver/analytic.py:PlaneWave`` (NumPy, copied).  The
family of travelling plane P/S waves on periodic domains is exact for the
first-order system in 2D and 3D, so the convergence order of a scheme can be
measured against it for any polynomial degree.

Derivation: with u = A d cos(k.x - w t), w = c |k| and the first-order system
  rho du/dt = div(sigma),   dsigma/dt = lam div(u) I + 2 mu sym(grad u)
one finds sigma = -(A/w) [lam (d.k) I + mu (d k^T + k d^T)] cos(k.x - w t),
which satisfies the momentum equation iff c^2 = vp^2 (d || k) or vs^2 (d _|_ k).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.elastic import Material, voigt_map


@dataclass(frozen=True)
class PlaneWave:
    """Travelling elastic plane wave, exact on periodic boxes."""

    mat: Material  # homogeneous material
    k: np.ndarray  # (dim,) wave vector (2*pi*integers/L for periodicity)
    mode: str = "S"  # "P" or "S"
    polarization: np.ndarray | None = None  # required for 3D S-waves
    amplitude: float = 1.0

    def __post_init__(self):
        k = np.asarray(self.k, dtype=np.float64)
        object.__setattr__(self, "k", k)
        khat = k / np.linalg.norm(k)
        if self.mode == "P":
            d = khat
            c = float(np.asarray(self.mat.vp))
        elif self.mode == "S":
            if self.polarization is not None:
                d = np.asarray(self.polarization, dtype=np.float64)
                d = d - (d @ khat) * khat
                if np.linalg.norm(d) < 1e-12:
                    raise ValueError("polarization parallel to k")
                d = d / np.linalg.norm(d)
            elif len(k) == 2:
                d = np.array([-khat[1], khat[0]])
            else:
                raise ValueError("3D S-wave needs a polarization")
            c = float(np.asarray(self.mat.vs))
        else:
            raise ValueError(self.mode)
        object.__setattr__(self, "_d", d)
        object.__setattr__(self, "_c", c)
        object.__setattr__(self, "_w", c * np.linalg.norm(k))

    @property
    def omega(self) -> float:
        return self._w

    @property
    def period(self) -> float:
        return 2.0 * np.pi / self._w

    def u(self, x: np.ndarray, t: float) -> np.ndarray:
        """Velocity at points x (..., dim)."""
        theta = x @ self.k - self._w * t
        return self.amplitude * np.cos(theta)[..., None] * self._d

    def sigma(self, x: np.ndarray, t: float) -> np.ndarray:
        """Stress (Voigt) at points x (..., dim)."""
        dim = x.shape[-1]
        lam = float(np.asarray(self.mat.lam))
        mu = float(np.asarray(self.mat.mu))
        d, k = self._d, self.k
        C = lam * (d @ k) * np.eye(dim) + mu * (
            np.outer(d, k) + np.outer(k, d)
        )
        V = voigt_map(dim)
        n_sig = 3 if dim == 2 else 6
        voigt = np.zeros(n_sig)
        for c in range(dim):
            for dd in range(dim):
                voigt[V[c, dd]] = C[c, dd]
        theta = x @ k - self._w * t
        return (-self.amplitude / self._w) * np.cos(theta)[..., None] * voigt
