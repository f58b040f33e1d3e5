"""Analytic solutions for verification: travelling elastic plane waves and
the full-space Green's functions of the point sources.

Port of ``seigen_tpu/solver/analytic.py`` (NumPy, copied).  The family of
travelling plane P/S waves on periodic domains is exact for the first-order
system in 2D and 3D, so the convergence order of a scheme can be measured
against it for any polynomial degree; the closed-form 3D full-space
solutions of the explosive, force and moment-tensor point sources
(``ExplosionGreens3D``, ``ForceGreens3D``, ``MomentGreens3D``) hold the
source stack (projection, mollification, wavelet timing, amplitude) to the
continuum.

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


def _mollifier_quad(position, radius, quad_n):
    """Quadrature points/weights over the Gaussian mollifier of std
    ``radius`` (quad_n per axis over +-4 radius), or the point itself."""
    pos = np.asarray(position, dtype=np.float64)
    if radius is None:
        return pos[None], np.ones(1)
    r = float(radius)
    g1 = np.linspace(-4.0 * r, 4.0 * r, quad_n)
    X = np.stack(np.meshgrid(g1, g1, g1, indexing="ij"), -1).reshape(-1, 3)
    w = np.exp(-np.sum(X**2, axis=1) / (2.0 * r * r))
    return pos[None] + X, w / w.sum()


@dataclass(frozen=True)
class ExplosionGreens3D:
    """Exact full-space velocity for the explosive point source (3D).

    The waveform-level Green's-function oracle the eigenmode family can't
    provide: it validates the SOURCE stack (projection, mollification,
    wavelet timing, amplitude) against the continuum, not just the
    operators.  The reference anchored sources on qualitative checks
    (SURVEY.md §4.4); a closed-form comparison is beyond-parity.

    Derivation, in this code's own conventions (solver/source.py injects
    d(sigma)/dt += a w(t) g(x) I with w the Ricker and g a normalized
    Gaussian of std ``radius``): purely dilatational motion v = grad(psi)
    reduces the velocity-stress system to the scalar wave equation

        psi_tt = vp^2 lap(psi) + (a / rho) w(t) g(x),

    whose retarded point solution (g = delta) is
    psi = (a / (4 pi rho vp^2)) w(t - r/vp) / r, so the radial velocity is

        v_r(r, t) = -(a / (4 pi rho vp^2)) [ w(tau)/r^2 + w'(tau)/(vp r) ],
        tau = t - r / vp.

    (The sign is this convention's: injecting POSITIVE isotropic stress is
    a tensile transient whose first motion is inward; seismological
    explosion conventions that build the moment as a stress GLUT carry the
    opposite sign.)  The mollified field superposes the point kernel over
    a quadrature grid of g — exact in the continuum, so a discrete-vs-
    analytic comparison isolates pure discretization error even at
    receivers a few mollification radii from the source.
    """

    mat: Material
    position: np.ndarray  # (3,) source position
    f0: float  # Ricker peak frequency
    t0: float  # wavelet delay
    amplitude: float = 1.0
    radius: float | None = None  # Gaussian mollification stddev
    quad_n: int = 15  # per-axis quadrature points over the Gaussian

    def _quad(self):
        return _mollifier_quad(self.position, self.radius, self.quad_n)

    def _wavelet(self, t):
        """Ricker w(t) and its time derivative."""
        z = np.pi * self.f0 * (t - self.t0)
        e = np.exp(-(z**2))
        w = (1.0 - 2.0 * z**2) * e
        dw = -2.0 * np.pi * self.f0 * z * (3.0 - 2.0 * z**2) * e
        return w, dw

    def velocity(self, x: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Exact velocity at receivers x (R, 3), times t (T,) -> (T, R, 3)."""
        x = np.asarray(x, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        xq, qw = self._quad()  # (J, 3), (J,)
        d = x[:, None, :] - xq[None, :, :]  # (R, J, 3)
        r = np.linalg.norm(d, axis=-1)  # (R, J)
        if np.any(r < 1e-12):
            raise ValueError("receiver coincides with a source point")
        rhat = d / r[..., None]
        vp = float(np.asarray(self.mat.vp))
        rho = float(np.asarray(self.mat.rho))
        tau = t[:, None, None] - r[None] / vp  # (T, R, J)
        w, dw = self._wavelet(tau)
        amp = -self.amplitude / (4.0 * np.pi * rho * vp**2)
        vr = amp * (w / r[None] ** 2 + dw / (vp * r[None]))  # (T, R, J)
        return np.einsum("trj,j,rjd->trd", vr, qw, rhat)

    def pressure(self, x: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Exact pressure -tr(sigma)/3 at receivers (R, 3), times (T,).

        Away from the source, tr(sigma-dot) = (3 lam + 2 mu) div(v) and
        div(v) = lap(psi) = psi_tt / vp^2, so

            p(r, t) = -(a (lam + 2 mu/3) / (4 pi rho vp^4)) w'(tau) / r

        — a pure far-field (1/r) signal, which makes it the cleanest
        amplitude check of the radiated wave."""
        x = np.asarray(x, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        xq, qw = self._quad()
        r = np.linalg.norm(x[:, None, :] - xq[None, :, :], axis=-1)
        if np.any(r < 1e-12):
            raise ValueError("receiver coincides with a source point")
        vp = float(np.asarray(self.mat.vp))
        rho = float(np.asarray(self.mat.rho))
        lam = float(np.asarray(self.mat.lam))
        mu = float(np.asarray(self.mat.mu))
        tau = t[:, None, None] - r[None] / vp
        _, dw = self._wavelet(tau)
        amp = -self.amplitude * (lam + 2.0 * mu / 3.0) / (
            4.0 * np.pi * rho * vp**4)
        return np.einsum("trj,j->tr", amp * dw / r[None], qw)[..., None]


def _ricker_family(f0, t0, t):
    """Ricker w, its derivative dw, and antiderivatives W = int w,
    W2 = int W — all closed form because w is proportional to the second
    derivative of a Gaussian:

        z = pi f0 (t - t0),  w = (1 - 2 z^2) e^{-z^2}
        dw = -2 pi f0 z (3 - 2 z^2) e^{-z^2}
        W  = (t - t0) e^{-z^2}              (W(-inf) = 0)
        W2 = -e^{-z^2} / (2 pi^2 f0^2)      (W2(-inf) = 0)
    """
    p = np.pi * f0
    z = p * (t - t0)
    e = np.exp(-(z**2))
    w = (1.0 - 2.0 * z**2) * e
    dw = -2.0 * p * z * (3.0 - 2.0 * z**2) * e
    W = (t - t0) * e
    W2 = -e / (2.0 * p * p)
    return w, dw, W, W2


class _PointGreens3D:
    """Shared quadrature/superposition scaffold for the full-space
    closed-form solutions (Gaussian mollification handled exactly by
    superposing the point kernel, as in ExplosionGreens3D)."""

    def _quad(self):
        return _mollifier_quad(self.position, self.radius, self.quad_n)

    def velocity(self, x: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Exact velocity at receivers x (R, 3), times t (T,) -> (T, R, 3)."""
        x = np.asarray(x, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        xq, qw = self._quad()
        d = x[:, None, :] - xq[None, :, :]  # (R, J, 3)
        r = np.linalg.norm(d, axis=-1)
        if np.any(r < 1e-12):
            raise ValueError("receiver coincides with a source point")
        gam = d / r[..., None]  # (R, J, 3) direction cosines
        v = self._point_velocity(gam, r, t)  # (T, R, J, 3)
        return np.einsum("trjd,j->trd", v, qw)


@dataclass(frozen=True)
class ForceGreens3D(_PointGreens3D):
    """Stokes solution: full-space velocity of a directed point force.

    Validates ``PointSource(kind="force")`` (solver/source.py adds
    f = a w(t) g(x) dhat to the momentum equation — the standard
    body-force convention, so the textbook Stokes solution applies with
    F(t) = a w(t) dhat).  The solver state is VELOCITY, i.e. the time
    derivative of the Stokes displacement; with the Ricker's closed-form
    antiderivative W the near-field integral int tau dF/dt(t - tau) dtau
    over [r/vp, r/vs] integrates by parts to closed form.  Standard
    reference for the displacement form: Aki & Richards eq. 4.23
    (re-derived; the reduction checks live in tests/test_greens.py).
    """

    mat: Material
    position: np.ndarray
    direction: np.ndarray  # unit force direction
    f0: float
    t0: float
    amplitude: float = 1.0
    radius: float | None = None
    quad_n: int = 15

    def _point_velocity(self, gam, r, t):
        a_, b_ = (float(np.asarray(self.mat.vp)),
                  float(np.asarray(self.mat.vs)))
        rho = float(np.asarray(self.mat.rho))
        dh = np.asarray(self.direction, dtype=np.float64)
        dh = dh / np.linalg.norm(dh)
        gF = gam @ dh  # (R, J) gamma . dhat
        tt = t[:, None, None]
        wa, dwa, Wa, _ = _ricker_family(self.f0, self.t0, tt - r / a_)
        wb, dwb, Wb, _ = _ricker_family(self.f0, self.t0, tt - r / b_)
        # velocity = d/dt of the Stokes displacement, so every time
        # function is differentiated once: the near-field integral
        # becomes int tau w'(t - tau) dtau (by parts, below) and the
        # far-field terms carry w' (not w)
        I = (r / a_) * wa - (r / b_) * wb + Wa - Wb  # (T, R, J)
        near = (3.0 * gF[..., None] * gam - dh) / r[..., None] ** 3
        farP = gF[..., None] * gam / (a_ * a_ * r[..., None])
        farS = (dh - gF[..., None] * gam) / (b_ * b_ * r[..., None])
        c = self.amplitude / (4.0 * np.pi * rho)
        return c * (near * I[..., None] + farP * dwa[..., None]
                    + farS * dwb[..., None])


@dataclass(frozen=True)
class MomentGreens3D(_PointGreens3D):
    """Full-space velocity of a general moment-tensor point source.

    Validates ``PointSource(kind="moment")`` / ``kind="explosive"``
    quantitatively for BOTH radiated wave types (P and S, with the near
    and intermediate fields) — the standard moment-tensor solution (Aki &
    Richards eq. 4.29 form) mapped to this code's convention: injecting
    d(sigma)/dt += a w(t) g(x) Mhat is the NEGATIVE of the seismological
    stress-glut moment rate, i.e. dM/dt = -a w(t) Mhat (the explosion
    special case and its sign are derived from first principles in
    ExplosionGreens3D; tests assert this class reduces to it EXACTLY for
    Mhat = I, which pins every P-term coefficient, and the solver-match
    tests pin the S terms).

    ``moment`` is the 3x3 symmetric unit tensor Mhat (not Voigt).
    """

    mat: Material
    position: np.ndarray
    moment: np.ndarray  # (3, 3) symmetric
    f0: float
    t0: float
    amplitude: float = 1.0
    radius: float | None = None
    quad_n: int = 15

    def _point_velocity(self, gam, r, t):
        a_, b_ = (float(np.asarray(self.mat.vp)),
                  float(np.asarray(self.mat.vs)))
        rho = float(np.asarray(self.mat.rho))
        M = np.asarray(self.moment, dtype=np.float64)
        if M.shape != (3, 3) or not np.allclose(M, M.T):
            raise ValueError("moment must be a symmetric 3x3 tensor")
        # radiation contractions
        gMg = np.einsum("rjp,pq,rjq->rj", gam, M, gam)  # (R, J)
        Mg = np.einsum("pq,rjq->rjp", M, gam)  # (R, J, 3)
        trM = np.trace(M)
        tt = t[:, None, None]
        wa, dwa, Wa, W2a = _ricker_family(self.f0, self.t0, tt - r / a_)
        wb, dwb, Wb, W2b = _ricker_family(self.f0, self.t0, tt - r / b_)
        # M(t) = -a W(t) Mhat; velocity needs
        #   near: d/dt int tau M(t - tau) dtau = closed form via (W, W2)
        #   intermediate: dM/dt = -a w;  far: d2M/dt2 = -a dw
        I = (r / a_) * Wa - (r / b_) * Wb + W2a - W2b  # (T, R, J)
        g = gam
        AN = (15.0 * gMg[..., None] * g - 6.0 * Mg
              - 3.0 * trM * g) / r[..., None] ** 4
        AIP = (6.0 * gMg[..., None] * g - 2.0 * Mg - trM * g) / (
            a_ * a_ * r[..., None] ** 2)
        AIS = -(6.0 * gMg[..., None] * g - 3.0 * Mg - trM * g) / (
            b_ * b_ * r[..., None] ** 2)
        AFP = gMg[..., None] * g / (a_**3 * r[..., None])
        AFS = -(gMg[..., None] * g - Mg) / (b_**3 * r[..., None])
        c = -self.amplitude / (4.0 * np.pi * rho)
        return c * (AN * I[..., None]
                    + (AIP * wa[..., None] + AIS * wb[..., None])
                    + (AFP * dwa[..., None] + AFS * dwb[..., None]))
