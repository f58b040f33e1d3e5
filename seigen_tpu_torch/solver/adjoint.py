"""Adjoint / FWI slice: differentiable misfits and material gradients.

Port of ``seigen_tpu/solver/adjoint.py``.  The forward solver is a Python
loop of pure operator applications over an ``ElasticParams`` whose material
tensors (lam, mu, inv_rho) are ordinary tensors, so the whole simulation is
reverse-mode differentiable by ``torch.autograd``.  This module adds what a
full-waveform inversion (FWI) loop needs on top:

- ``run_segmented``: the forward loop split into ``torch.utils.checkpoint``
  chunks (timestep.scan_steps), trading recompute for O(segment +
  n_steps/segment) stored states instead of O(n_steps);
- ``with_material``: re-assemble ElasticParams from (vp, vs, rho) element
  tensors with differentiable tensor operations (geometry untouched), so
  gradients flow to the geophysical parametrization;
- ``seismogram_misfit`` / ``make_fwi_gradient``: 0.5 * ||seis - obs||^2 at
  the receivers and its value and gradient with respect to chosen material
  fields; ``make_visco_fwi_gradient`` the same for per-element Q^-1 through
  the viscoelastic upwind-RK4 loop.

These are the einsum gradients (the oracle of solver/lane_diff.py, whose
engines run the CUDA kernels forwards and, by energy conjugation,
backwards).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.elastic import ElasticParams, apply_stress_op, apply_vel_op
from .receivers import ReceiverData
from .source import SourceData
from .timestep import State, run


def run_segmented(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    segment: int | None = None,
    order: int = 4,
    src: SourceData | None = None,
    damp: torch.Tensor | None = None,
    receivers: ReceiverData | None = None,
    step0: int = 0,
    vel_op=None,
    stress_op=None,
):
    """solver.timestep.run with checkpointed segments (the JAX package's
    name for it).

    ``segment`` must divide n_steps; None runs one plain (fully stored)
    loop.  Returns (final State, seismograms (n_steps, R, dim) or None).
    ``vel_op``/``stress_op`` override the einsum operators, e.g. with
    ops.structured_exchange.make_structured_ops' roll exchange."""
    return run(p, state0, dt, n_steps, order=order, src=src, damp=damp,
               receivers=receivers, step0=step0,
               vel_op=vel_op or apply_vel_op,
               stress_op=stress_op or apply_stress_op, segment=segment)


def lame_rows(vp, vs, rho):
    """THE geophysical parametrization, in one place: (vp, vs, rho) ->
    (lam, mu, 1/rho).  Used by every gradient engine and with_material."""
    mu = rho * vs * vs
    lam = rho * (vp * vp - 2.0 * vs * vs)
    return lam, mu, 1.0 / rho


def theta_of_params(p: ElasticParams) -> dict:
    """Inverse map: ElasticParams material tensors -> {vp, vs, rho}."""
    return {
        "vp": torch.sqrt((p.lam + 2 * p.mu) * p.inv_rho),
        "vs": torch.sqrt(p.mu * p.inv_rho),
        "rho": 1.0 / p.inv_rho,
    }


def to_like(x, like: torch.Tensor) -> torch.Tensor:
    """x (a tensor, keeping its autograd history, or array-like) on
    ``like``'s device and dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.array(x), device=like.device, dtype=like.dtype)


def with_material(p: ElasticParams, vp=None, vs=None, rho=None
                  ) -> ElasticParams:
    """Re-assemble params from per-element (vp, vs, rho) with tensor ops.

    Geometry, connectivity and flux coefficients are reused; only the
    material tensors change, so gradients flow to the given fields (lam =
    rho (vp^2 - 2 vs^2), mu = rho vs^2).  Absent fields keep p's values."""
    base = theta_of_params(p)
    rho = base["rho"] if rho is None else to_like(rho, p.Ginv)
    vs = base["vs"] if vs is None else to_like(vs, p.Ginv)
    vp = base["vp"] if vp is None else to_like(vp, p.Ginv)
    lam, mu, inv_rho = lame_rows(vp, vs, rho)
    return dataclasses.replace(p, lam=lam, mu=mu, inv_rho=inv_rho)


def seismogram_misfit(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    src: SourceData,
    receivers: ReceiverData,
    observed: torch.Tensor,
    order: int = 4,
    damp: torch.Tensor | None = None,
    segment: int | None = None,
    vel_op=None,
    stress_op=None,
) -> torch.Tensor:
    """0.5 * sum((seis - observed)^2) over (n_steps, R, dim)."""
    _, seis = run_segmented(
        p, state0, dt, n_steps, segment=segment, order=order, src=src,
        damp=damp, receivers=receivers, vel_op=vel_op, stress_op=stress_op)
    r = seis - to_like(observed, seis)
    return 0.5 * torch.sum(r * r)


def value_and_grad(loss, theta: dict):
    """(loss(theta) as a float, {field: d loss / d theta[field]}) with
    theta's tensors detached copies that require grad."""
    th = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    val = loss(th)
    keys = list(th)
    grads = torch.autograd.grad(val, [th[k] for k in keys],
                                allow_unused=True)
    return float(val.detach()), {
        k: (torch.zeros_like(th[k]) if g is None else g)
        for k, g in zip(keys, grads)}


def make_fwi_gradient(
    p0: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    src: SourceData,
    receivers: ReceiverData,
    observed,
    fields: tuple = ("vp", "vs"),
    order: int = 4,
    damp: torch.Tensor | None = None,
    segment: int | None = None,
    vel_op=None,
    stress_op=None,
):
    """theta -> (misfit, grads) for theta = {field: (E,) tensor}, and
    ``init_theta()`` (p0's values of ``fields``).

    ``fields`` from {"vp", "vs", "rho"}; unlisted fields stay at p0's
    values.  The gradient is ``torch.autograd.grad`` through the einsum
    loop (``vel_op``/``stress_op``: e.g. the structured roll exchange)."""
    obs = to_like(observed, p0.Ginv)

    def vg(theta: dict):
        def loss(th):
            return seismogram_misfit(
                with_material(p0, **th), state0, dt, n_steps, src,
                receivers, obs, order=order, damp=damp, segment=segment,
                vel_op=vel_op, stress_op=stress_op)

        return value_and_grad(loss, {k: to_like(v, p0.Ginv)
                                     for k, v in theta.items()})

    def init_theta():
        full = theta_of_params(p0)
        return {k: full[k].detach().clone() for k in fields}

    return vg, init_theta


def make_visco_fwi_gradient(
    p: ElasticParams,
    w,
    state0: State,
    dt: float,
    n_steps: int,
    src: SourceData,
    receivers: ReceiverData,
    observed,
    f_band: tuple,
    L: int = 3,
    q0: float = 50.0,
    damp: torch.Tensor | None = None,
    segment: int | None = None,
):
    """Attenuation FWI: theta -> (misfit, grads) for per-element Q^-1
    fields, theta = {"qinv_kappa": (E,), "qinv_mu": (E,)}.

    Inverts INVERSE quality factors (the anelastic coefficients are linear
    in Q^-1: y = qinv x y_unit, ops/viscoelastic.py build_visco); the
    ViscoData is rebuilt differentiably inside the loss and the gradient
    rides reverse mode through the viscoelastic upwind-RK4 loop
    (solver/rk4.py run_rk4_visco), checkpointed in ``segment`` chunks.
    The elastic material stays at ``p``'s values.

    ``value_and_grad(theta, src_=None, observed_=None)``: the optional
    per-call overrides let a multi-shot loop reuse one closure."""
    from ..ops.viscoelastic import ViscoData, fit_anelastic_unit
    from .rk4 import run_rk4_visco

    w_l, y1 = fit_anelastic_unit(float(f_band[0]), float(f_band[1]), L)
    omegas = to_like(w_l, p.Ginv)
    y_unit = to_like(y1, p.Ginv)
    E = p.Ginv.shape[0]

    def value_and_grad_(theta: dict, src_=None, observed_=None):
        s = src if src_ is None else src_
        obs = to_like(observed if observed_ is None else observed_, p.Ginv)

        def loss(th):
            v = ViscoData(omegas=omegas,
                          y_kappa=torch.outer(th["qinv_kappa"], y_unit),
                          y_mu=torch.outer(th["qinv_mu"], y_unit), L=L)
            _, _, seis = run_rk4_visco(
                p, w, v, state0, dt, n_steps, src=s, damp=damp,
                receivers=receivers, segment=segment)
            res = seis - obs
            return 0.5 * torch.sum(res * res)

        return value_and_grad(loss, {k: to_like(v, p.Ginv)
                                     for k, v in theta.items()})

    def init_theta():
        q = torch.full((E,), 1.0 / q0, dtype=p.dtype, device=p.device)
        return {"qinv_kappa": q, "qinv_mu": q.clone()}

    return value_and_grad_, init_theta
