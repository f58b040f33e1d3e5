"""Point sources with Ricker wavelets (SURVEY.md §4.4, binding per [D]).

A point source delta(x - xs) * a * r(t) is projected onto the DG space once at
setup: within the containing element, the nodal contribution of the delta is
Minv_ref @ phi(xi_s) / detJ (the reference's time-dependent Expression feeding
the RHS forms becomes a precomputed injection vector + a traced wavelet).
Injection on device is a single index-add into the first operator stage.

Port of ``seigen_tpu/solver/source.py``: host setup unchanged (NumPy f64),
device data as torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.discrete import DiscreteMesh
from ..ops.elastic import n_sig_for


def ricker(t, f0, t0):
    """Ricker wavelet r(t) = (1 - 2 pi^2 f0^2 tau^2) exp(-pi^2 f0^2 tau^2)."""
    tau = (np.pi * f0 * (t - t0)) ** 2
    exp = torch.exp if isinstance(tau, torch.Tensor) else np.exp
    return (1.0 - 2.0 * tau) * exp(-tau)


@dataclass(frozen=True)
class PointSource:
    """An explosive (isotropic moment) or directed force point source.

    ``radius`` mollifies the delta into a normalized Gaussian of that
    standard deviation (recommended: ~1-2 element sizes).  A raw delta
    (radius=None) excites unresolved wavenumbers whose spurious central-flux
    DG branches propagate super-physically (strong precursors); the
    reference mitigates the same way (SURVEY.md §4.4 "narrow Gaussian /
    single-element footprint").
    """

    position: tuple
    f0: float  # Ricker peak frequency
    t0: float | None = None  # delay; default 1.2/f0 (quasi-zero onset)
    amplitude: float = 1.0
    # "explosive": isotropic moment into the stress trace;
    # "force": directed body force (velocity equation);
    # "moment": general moment tensor (Voigt) into the stress equation —
    #           double-couple / CMT-style sources; explosive == moment with
    #           M = I.
    kind: str = "explosive"
    direction: tuple | None = None  # for kind="force"
    moment: tuple | None = None  # Voigt M for kind="moment"
    radius: float | None = None  # Gaussian mollification stddev

    @property
    def delay(self) -> float:
        return self.t0 if self.t0 is not None else 1.2 / self.f0


@dataclass(frozen=True)
class SourceData:
    """Device tensors for S point-source entries."""

    elems: torch.Tensor  # (S,) int64
    vec_u: torch.Tensor  # (S, n_p, dim) velocity-equation injection vectors
    vec_s: torch.Tensor  # (S, n_p, n_sig) stress-equation injection vectors
    f0: torch.Tensor  # (S,)
    t0: torch.Tensor  # (S,)
    amp: torch.Tensor  # (S,)


def build_sources(
    dm: DiscreteMesh,
    sources: list[PointSource],
    dtype: torch.dtype = torch.float32,
    mat=None,
    device: torch.device | str = "cuda",
) -> SourceData | None:
    """Project point sources onto the DG space (host-side setup).

    ``mat`` (a Material) is required only when a "force" source is present,
    to fold 1/rho into the velocity-equation injection vector.
    """
    if not sources:
        return None
    dim = dm.dim
    n_sig = n_sig_for(dim)
    re = dm.re

    # One (element, n_p) injection block per touched element per source.
    ent_elems, ent_base, ent_src = [], [], []
    for i, s in enumerate(sources):
        pos = np.asarray(s.position, dtype=np.float64)
        if s.radius is None:
            # delta: L(phi_i) = phi_i(xs); coeffs = Minv phi / detJ
            elems, xi = dm.locate_points(pos[None])
            phi = re.eval_basis(xi)[0]
            base = re.Minv @ phi / dm.detJ[elems[0]]
            ent_elems.append([int(elems[0])])
            ent_base.append(base[None])
            ent_src.append([i])
        else:
            # mollified: project normalized Gaussian g onto the DG space:
            # coeffs_e = Minv_ref @ (sum_q w_q phi(x_q) g(x_q)); discrete
            # renormalization preserves the total injected moment exactly.
            r = float(s.radius)
            cent = dm.coords.mean(axis=1)  # (E, dim)
            near = np.where(
                np.linalg.norm(cent - pos, axis=1) < 5.0 * r + dm.h.max()
            )[0]
            if len(near) == 0:
                raise ValueError(f"source {i} outside mesh")
            xq = np.einsum("qi,eid->eqd", re.Vq, dm.coords[near])
            g = np.exp(
                -np.sum((xq - pos) ** 2, axis=-1) / (2.0 * r * r)
            )  # (K, nq)
            integral = np.einsum("e,q,eq->", dm.detJ[near], re.qw, g)
            if integral <= 0:
                raise ValueError(f"source {i} mollifier vanished")
            g /= integral
            # nodal projection coeffs: Minv_ref @ (V_q^T diag(w) g_e)
            b = np.einsum("q,qi,eq->ei", re.qw, re.Vq, g)  # (K, n_p)
            coeffs = b @ re.Minv.T  # detJ cancels: Minv_phys = Minv_ref/detJ
            for k, e in enumerate(near):
                ent_elems.append([int(e)])
                ent_base.append(coeffs[k][None])
                ent_src.append([i])

    elems = np.concatenate([np.asarray(e) for e in ent_elems])
    base = np.concatenate(ent_base, axis=0)  # (K, n_p)
    src_id = np.concatenate([np.asarray(sid) for sid in ent_src])

    K = len(elems)
    vec_u = np.zeros((K, re.n_p, dim))
    vec_s = np.zeros((K, re.n_p, n_sig))
    for k in range(K):
        s = sources[src_id[k]]
        if s.kind == "explosive":
            # isotropic moment: inject into the stress trace (s_xx, s_yy[, s_zz])
            vec_s[k, :, :dim] = base[k][:, None]
        elif s.kind == "moment":
            M = np.asarray(s.moment, dtype=np.float64)
            if M.shape != (n_sig,):
                raise ValueError(
                    f"moment must be Voigt ({n_sig},), got {M.shape}")
            vec_s[k] = base[k][:, None] * M[None, :]
        elif s.kind == "force":
            if mat is None:
                raise ValueError("force sources require the material (rho)")
            d = np.asarray(s.direction, dtype=np.float64)
            d = d / np.linalg.norm(d)
            # rho du/dt = ... + f  =>  du/dt += f / rho
            rho_e = np.broadcast_to(
                np.asarray(mat.rho, dtype=np.float64), (dm.num_elements,)
            )[elems[k]]
            vec_u[k] = base[k][:, None] * d[None, :] / rho_e
        else:
            raise ValueError(s.kind)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    return SourceData(
        elems=dev(elems, torch.int64),
        vec_u=dev(vec_u),
        vec_s=dev(vec_s),
        f0=dev([sources[j].f0 for j in src_id]),
        t0=dev([sources[j].delay for j in src_id]),
        amp=dev([sources[j].amplitude for j in src_id]),
    )


def kinematic_rupture(
    a,
    b,
    n_sub: int,
    moment,
    f0: float,
    rupture_velocity: float,
    hypocenter=None,
    radius: float | None = None,
    amplitude: float = 1.0,
) -> list:
    """A finite-fault kinematic rupture as time-shifted moment sources.

    Discretizes the fault segment [a, b] into ``n_sub`` subfault point
    sources with a shared Voigt moment tensor; each fires a Ricker with
    onset delayed by (distance from hypocenter) / rupture_velocity, the
    standard Haskell-type kinematic description.  Each subfault is one
    PointSource, so the rupture runs through the multi-source machinery.

    ``hypocenter`` defaults to ``a`` (unilateral rupture; pick the segment
    midpoint for a bilateral one).  The per-subfault amplitude is
    ``amplitude / n_sub`` so the total moment is rupture-length-invariant.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    hypo = a if hypocenter is None else np.asarray(hypocenter,
                                                  dtype=np.float64)
    if rupture_velocity <= 0:
        raise ValueError("rupture_velocity must be positive")
    srcs = []
    base_delay = 1.2 / f0
    for k in range(n_sub):
        x = a + (b - a) * (k / max(n_sub - 1, 1))
        t0 = base_delay + float(np.linalg.norm(x - hypo)) / rupture_velocity
        srcs.append(PointSource(
            position=tuple(x), f0=f0, t0=t0,
            amplitude=amplitude / n_sub, kind="moment",
            moment=tuple(moment), radius=radius,
        ))
    return srcs


def inject_stress(src: SourceData | None, ds: torch.Tensor, t):
    """Add stress-equation source contributions at time t."""
    if src is None:
        return ds
    r = src.amp * ricker(t, src.f0, src.t0)  # (S,)
    return ds.index_add(0, src.elems, src.vec_s * r[:, None, None])


def inject_velocity(src: SourceData | None, du: torch.Tensor, t):
    if src is None:
        return du
    r = src.amp * ricker(t, src.f0, src.t0)
    return du.index_add(0, src.elems, src.vec_u * r[:, None, None])
