"""Viscoelastic attenuation: generalized-Maxwell (memory-variable) Q.

Port of ``seigen_tpu/ops/viscoelastic.py``.  The anelastic stress is
carried by L relaxation mechanisms with memory variables xi_l obeying

    d xi_l / dt = omega_l (Y_l * (C eps_dot) - xi_l)
    d sigma / dt = C eps_dot - sum_l xi_l

where C eps_dot is the unrelaxed elastic stress rate (the stress operator)
and the anelastic coefficients Y_l are least-squares fit so that the
model's Q(omega) ~ target Q over a frequency band.  Q is parametrized per
element by (Q_kappa, Q_mu) acting on the isotropic / deviatoric parts of
the stress rate.

Everything here is elementwise (no spatial coupling), so it stays plain
PyTorch beside the RK4 stage arithmetic; it pairs with the RK4/upwind path
(co-located state in time).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .elastic import ElasticParams


def fit_anelastic_unit(f_min: float, f_max: float, L: int = 3):
    """Fit unit-Q^-1 anelastic coefficients over [f_min, f_max].

    The generalized Maxwell body gives (low-loss approximation)

        Q^-1(w) ~ sum_l Y_l * (w w_l) / (w^2 + w_l^2)

    linear in Y, so it is fit once for Q^-1 = 1 and Y scaled by the actual
    Q^-1 per element.  Returns (omegas (L,), y_unit (L,)): relaxation
    angular frequencies (log-spaced across the band) and unit coefficients.
    """
    if L < 1:
        raise ValueError("need at least one mechanism")
    w_l = 2 * np.pi * np.logspace(np.log10(f_min), np.log10(f_max), L)
    wk = 2 * np.pi * np.logspace(
        np.log10(f_min), np.log10(f_max), max(2 * L - 1, L))
    A = (wk[:, None] * w_l[None, :]) / (wk[:, None] ** 2 + w_l[None, :] ** 2)
    y, *_ = np.linalg.lstsq(A, np.ones(len(wk)), rcond=None)
    return w_l, y


def model_q_inv(omegas, y, freqs):
    """Q^-1(f) of the fitted model (for tests/diagnostics)."""
    w = 2 * np.pi * np.asarray(freqs)[:, None]
    return (y[None, :] * (w * omegas[None, :])
            / (w**2 + omegas[None, :] ** 2)).sum(axis=1)


@dataclass(frozen=True)
class ViscoData:
    """Per-element anelastic data: omegas (L,), y_* (E, L)."""

    omegas: torch.Tensor
    y_kappa: torch.Tensor
    y_mu: torch.Tensor
    L: int


def visco_from_numpy(arrays: dict, device, dtype) -> ViscoData:
    """ViscoData from host arrays keyed by field name (omegas, y_kappa,
    y_mu; L follows from the shapes), e.g. another package's ViscoData."""
    t = {k: torch.as_tensor(np.array(arrays[k]), device=device).to(dtype)
         for k in ("omegas", "y_kappa", "y_mu")}
    return ViscoData(**t, L=int(t["omegas"].shape[0]))


def build_visco(p: ElasticParams, q_kappa, q_mu, f_min: float, f_max: float,
                L: int = 3) -> ViscoData:
    """Anelastic data for per-element (Q_kappa, Q_mu) over [f_min, f_max],
    on p's device and dtype.  Pass np.inf entries for purely elastic
    elements (Y -> 0)."""
    E = p.Ginv.shape[0]
    w_l, y1 = fit_anelastic_unit(f_min, f_max, L)
    qk = np.broadcast_to(np.asarray(q_kappa, dtype=np.float64), (E,))
    qm = np.broadcast_to(np.asarray(q_mu, dtype=np.float64), (E,))
    return visco_from_numpy(
        dict(omegas=w_l, y_kappa=np.outer(1.0 / qk, y1),
             y_mu=np.outer(1.0 / qm, y1)), p.device, p.dtype)


def split_iso_dev(ds: torch.Tensor, dim: int):
    """Voigt (E, n_p, n_sig) stress rate -> isotropic + deviatoric parts."""
    iso_scalar = ds[..., :dim].mean(dim=-1)  # (E, n_p)
    iso = torch.cat(
        [iso_scalar[..., None].expand(*iso_scalar.shape, dim),
         torch.zeros_like(ds[..., dim:])], dim=-1)
    return iso, ds - iso


def anelastic_rates(v: ViscoData, ds_el: torch.Tensor, xi: torch.Tensor,
                    dim: int):
    """(d xi, sum_l xi_l) given the unrelaxed elastic stress rate.

    xi: (E, n_p, n_sig, L).  d xi_l = omega_l (Y_l ds_parts - xi_l).
    """
    iso, dev = split_iso_dev(ds_el, dim)
    target = (iso[..., None] * v.y_kappa[:, None, None, :]
              + dev[..., None] * v.y_mu[:, None, None, :])
    dxi = v.omegas * (target - xi)
    return dxi, xi.sum(dim=-1)


def anelastic_rates_lm(ds_el, xi, yk, ym, omegas, dim: int, n_sig: int,
                       npp: int):
    """Lane-major twin of :func:`anelastic_rates`.

    ds_el (n_sig*npp, L) unrelaxed elastic stress rate; xi (L_mem,
    n_sig*npp, L) memory variables; yk/ym (L_mem, 1, L) anelastic
    coefficients in lane layout; omegas (L_mem,).  Returns (dxi, xi_sum).
    Point sources enter the RELAXED balance after this (solver/rk4.py):
    they bypass the anelastic target.
    """
    xi_sum = xi.sum(dim=0)
    iso_scalar = sum(
        ds_el[c * npp : (c + 1) * npp] for c in range(dim)) / dim
    iso = torch.cat(
        [iso_scalar] * dim
        + [torch.zeros(((n_sig - dim) * npp, ds_el.shape[1]),
                       dtype=ds_el.dtype, device=ds_el.device)], dim=0)
    dev = ds_el - iso
    target = iso[None] * yk + dev[None] * ym
    dxi = omegas[:, None, None] * (target - xi)
    return dxi, xi_sum
