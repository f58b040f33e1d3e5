"""Explicit staggered leapfrog time stepping (LF2 / LF4).

Port of ``seigen_tpu/solver/timestep.py``.  The whole step — 6 operator
applications (LF4), source injection, sponge damping — is one function,
and ``run`` is a Python loop over steps (PyTorch runs eagerly).

Staggering: u lives at integer steps t = n dt, sigma at half steps
t = (n + 1/2) dt.  Each update evaluates the counterpart field at its
midpoint; the O(dt^3) modified-equation correction makes LF4 4th order:

  uh1   = Au(s)                    # s at t+dt/2
  stemp = As(uh1); uh2 = Au(stemp)
  u'    = u + dt*uh1 + dt^3/24 * uh2
  sh1   = As(u') [+ stress source at t+dt]
  utemp = Au(sh1); sh2 = As(utemp)
  s'    = s + dt*sh1 + dt^3/24 * sh2
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.elastic import ElasticParams, apply_stress_op, apply_vel_op
from .receivers import ReceiverData, sample
from .source import SourceData, inject_stress, inject_velocity


@dataclass(frozen=True)
class State:
    u: torch.Tensor  # (E, n_p, dim) velocity at t = n dt
    s: torch.Tensor  # (E, n_p, n_sig) stress at t = (n + 1/2) dt


def compose_lf_step(vel, stress, inject_u, inject_s, post, dt, order: int):
    """THE LF2/LF4 physics, in exactly one place.

    Every runner builds its own (vel, stress, inject_u, inject_s, post)
    closures over its own data layout and composes the step here.

      vel(s) / stress(u): the discrete operators Mu^-1 Lu / Ms^-1 Ls
      inject_u(du, t) / inject_s(ds, t): add source terms to a stage RHS
      post(u, s) -> (u, s): after-update hook (sponge damping)
      dt: scalar of the run dtype; t passed to step is the START time of
          the step (u at t, sigma at t + dt/2).
    """
    if order not in (2, 4):
        raise ValueError("order must be 2 or 4 (reference parity: LF2/LF4)")
    c3 = dt**3 / 24.0

    def step(u, s, t):
        # --- velocity update: t -> t + dt, using sigma at t + dt/2 ---
        uh1 = inject_u(vel(s), t + 0.5 * dt)
        if order == 4:
            u = u + dt * uh1 + c3 * vel(stress(uh1))
        else:
            u = u + dt * uh1
        # --- stress update: t + dt/2 -> t + 3 dt/2, using u at t + dt ---
        sh1 = inject_s(stress(u), t + dt)
        if order == 4:
            s = s + dt * sh1 + c3 * stress(vel(sh1))
        else:
            s = s + dt * sh1
        return post(u, s)

    return step


def compose_lf_step_traced(vel, stress, vel_axpy, stress_axpy,
                           inject_u, inject_s, post_u,
                           vel_src=None, stress_src=None):
    """The LF4 stage sequence for TRACE-CARRYING fused operators — the same
    math as compose_lf_step(order=4), with the axpy updates folded into the
    final operator of each half-step and every operator emitting the face
    traces of its output.

      vel(s, tr_t) -> (uh, tr_u)        tr_t: traction traces of s
      stress(u, tr_u) -> (sh, tr_t)
      vel_axpy(s, tr_t, u, uh1) -> (u + dt*uh1 + c3*vel(s), traces)
      stress_axpy(u, tr_u, s, sh1) -> (damp*(s + dt*sh1 + c3*stress(u)), tr)
      inject_u(field, tr, t) / inject_s: source injection into a stage RHS
        AND its emitted traces (the trace arrays must stay consistent)
      post_u(u): end-of-step velocity damping (the stress damp is folded
        into stress_axpy; u must be damped AFTER its traces feed sh1)
      vel_src(s, tr, t) / stress_src(u, tr, t): OPTIONAL source-fused
        stage operators used at the two injection sites INSTEAD of
        vel/stress + inject (kernel-fused dense-pattern injection — the
        emitted traces already contain the source, so the inject_*
        callbacks are bypassed)

    The step carry is (u, s, tr_t): the traction traces of s ride across
    steps so the first stage never re-extracts them.
    """

    def step(u, s, tr_t, t, dt):
        if vel_src is not None:
            uh1, tru1 = vel_src(s, tr_t, t + 0.5 * dt)
        else:
            uh1, tru1 = vel(s, tr_t)
            uh1, tru1 = inject_u(uh1, tru1, t + 0.5 * dt)
        st, trt_st = stress(uh1, tru1)
        unew, tru_new = vel_axpy(st, trt_st, u, uh1)

        if stress_src is not None:
            sh1, trt_sh1 = stress_src(unew, tru_new, t + dt)
        else:
            sh1, trt_sh1 = stress(unew, tru_new)
            sh1, trt_sh1 = inject_s(sh1, trt_sh1, t + dt)
        ut, tru_ut = vel(sh1, trt_sh1)
        snew, trt_new = stress_axpy(ut, tru_ut, s, sh1)
        return post_u(unew), snew, trt_new

    return step


def inject_columns(arr: torch.Tensor, lanes: torch.Tensor,
                   patch: torch.Tensor) -> torch.Tensor:
    """arr[:, lanes[k]] += patch[:, k] (point-source injection); repeated
    lanes accumulate.  Returns a new tensor."""
    return arr.index_add(1, lanes, patch)


def damp_post(damp: torch.Tensor | None):
    """Standard-layout (E, n_p, C) sponge-damping post hook."""
    if damp is None:
        return lambda u, s: (u, s)
    return lambda u, s: (u * damp[:, :, None], s * damp[:, :, None])


def numpy_dtype(dtype: torch.dtype):
    """The NumPy scalar type of a run dtype: host-side times and wavelet
    values are computed in it, as the run computes them on the device."""
    return np.float64 if dtype == torch.float64 else np.float32


def make_step(
    p: ElasticParams,
    dt: float,
    order: int = 4,
    src: SourceData | None = None,
    damp: torch.Tensor | None = None,
    vel_op=apply_vel_op,
    stress_op=apply_stress_op,
):
    """Build the single-timestep function (State, t) -> State.

    ``vel_op``/``stress_op``: (p, field) operators replacing the isotropic
    einsum ones (e.g. ops/anisotropic.py:make_aniso_stress_op)."""
    dt = numpy_dtype(p.dtype)(dt)
    lf = compose_lf_step(
        vel=lambda s: vel_op(p, s),
        stress=lambda u: stress_op(p, u),
        inject_u=lambda du, t: inject_velocity(src, du, t),
        inject_s=lambda ds, t: inject_stress(src, ds, t),
        post=damp_post(damp),
        dt=dt,
        order=order,
    )

    def step(state: State, t) -> State:
        u, s = lf(state.u, state.s, t)
        return State(u=u, s=s)

    return step


def staggered_init(p: ElasticParams, u0: torch.Tensor, s0: torch.Tensor,
                   dt: float, order: int = 4, vel_op=apply_vel_op,
                   stress_op=apply_stress_op) -> State:
    """Build a staggered State from co-located (u, sigma) at t = 0.

    The leapfrog scheme stores sigma at t = dt/2; advancing it there with a
    discrete Taylor series (s' = As u, s'' = As Au s, s''' = As Au As u)
    keeps the initialization error at the scheme's own order and, because
    it uses the discrete operators, makes runs with different dt share
    exactly the same t = 0 data.
    """
    h = 0.5 * numpy_dtype(p.dtype)(dt)
    s = s0 + h * stress_op(p, u0)
    if order == 4:
        s2 = stress_op(p, vel_op(p, s0))
        s3 = stress_op(p, vel_op(p, stress_op(p, u0)))
        s = s + (h**2 / 2.0) * s2 + (h**3 / 6.0) * s3
    return State(u=u0, s=s)


def run(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    order: int = 4,
    src: SourceData | None = None,
    damp: torch.Tensor | None = None,
    receivers: ReceiverData | None = None,
    step0: int = 0,
    vel_op=apply_vel_op,
    stress_op=apply_stress_op,
):
    """Run n_steps; returns (final State, seismograms tensor or None).

    Seismograms: (n_steps, R, dim) velocity samples, taken after each full
    step.
    ``step0``: global index of the first step (keeps time-dependent
    sources in phase on resume).  Step k starts at t = k*dt, computed in
    the run dtype.
    """
    step = make_step(p, dt, order=order, src=src, damp=damp, vel_op=vel_op,
                     stress_op=stress_op)
    npdt = numpy_dtype(p.dtype)
    dt_ = npdt(dt)
    state = state0
    seis = []
    for n in range(step0, step0 + n_steps):
        state = step(state, npdt(n) * dt_)
        if receivers is not None:
            seis.append(sample(receivers, state.u))
    return state, (torch.stack(seis) if seis else None)


def cfl_dt(h_min: float, vp_max: float, degree: int, cfl: float = 0.5) -> float:
    """Stability-bound timestep dt = cfl * h_min / (vp_max * (2q + 1)).

    The bound was derived empirically by bisection in the JAX package
    (results/cfl_study.json): in this normalization LF2 is stable to
    cfl ~0.75-0.85 and LF4 to ~2.0-2.6 across P1-P4 in 2D/3D.
    """
    return cfl * h_min / (vp_max * (2 * degree + 1))
