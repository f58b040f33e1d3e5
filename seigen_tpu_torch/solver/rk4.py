"""Classic RK4 time integration for the upwind-flux coupled operator.

Port of ``seigen_tpu/solver/rk4.py``: the Godunov flux (ops/upwind.py)
couples u and sigma traces in both equations, so the staggered leapfrog
cannot be used; classic RK4 (4 coupled operator evaluations per step,
co-located state in time) is the standard pairing.  Sources are evaluated
at the RK stage times; receivers and damping mirror solver/timestep.py.
These einsum steppers are the oracle of the lane-major upwind runner
(solver/lane_upwind.py) and the eigenmode path (periodic meshes, which the
lane runner does not take).  ``run_rk4``/``run_rk4_visco`` are Python
loops over steps.
"""

from __future__ import annotations

import torch

from ..ops.elastic import ElasticParams
from ..ops.upwind import UpwindData, apply_coupled_upwind
from .receivers import ReceiverData, sample
from .source import SourceData, ricker
from .timestep import State, numpy_dtype, scan_steps


def _gather(p: ElasticParams, field: torch.Tensor) -> torch.Tensor:
    flat = field.reshape((-1,) + field.shape[2:])
    return flat[p.nbr].reshape(field.shape[0], p.n_faces * p.n_fp, -1)


def _add_sources(src: SourceData | None, du, ds, t):
    """Stage RHS + point sources at time t (the momentum / stress balance)."""
    if src is None:
        return du, ds
    r = src.amp * ricker(t, src.f0, src.t0)
    return (du.index_add(0, src.elems, src.vec_u * r[:, None, None]),
            ds.index_add(0, src.elems, src.vec_s * r[:, None, None]))


def rk4_update(rhs, carry, t, h):
    """One classic RK4 update of ``carry`` from time t over a step h:
    ``rhs(*carry, t)`` returns the rates of the carry's entries; None
    entries (of the carry) pass through.  The stage ladder of the lane
    upwind runners (solver/lane_upwind.py, solver/lane_upwind_u.py)."""
    h2 = 0.5 * h

    def stage(a, k):
        return [None if x is None else x + a * kx for x, kx in zip(carry, k)]

    k1 = rhs(*carry, t)
    k2 = rhs(*stage(h2, k1), t + h2)
    k3 = rhs(*stage(h2, k2), t + h2)
    k4 = rhs(*stage(h, k3), t + h)
    w = h / 6.0
    return [None if x is None else x + w * (a + 2 * b + 2 * c + e)
            for x, a, b, c, e in zip(carry, k1, k2, k3, k4)]


def make_rk4_step(p: ElasticParams, w: UpwindData, dt: float,
                  src: SourceData | None = None,
                  damp: torch.Tensor | None = None):
    """(State, t) -> State with classic RK4 + upwind fluxes.

    State semantics: sigma is CO-LOCATED with u in time (no staggering);
    initialize both at t = 0.
    """
    dt_ = numpy_dtype(p.dtype)(dt)

    def rhs(u, s, t):
        du, ds = apply_coupled_upwind(p, w, u, s, _gather(p, u),
                                      _gather(p, s))
        return _add_sources(src, du, ds, t)

    def step(state: State, t) -> State:
        u, s = state.u, state.s
        k1u, k1s = rhs(u, s, t)
        k2u, k2s = rhs(u + 0.5 * dt_ * k1u, s + 0.5 * dt_ * k1s,
                       t + 0.5 * dt_)
        k3u, k3s = rhs(u + 0.5 * dt_ * k2u, s + 0.5 * dt_ * k2s,
                       t + 0.5 * dt_)
        k4u, k4s = rhs(u + dt_ * k3u, s + dt_ * k3s, t + dt_)
        u = u + (dt_ / 6.0) * (k1u + 2 * k2u + 2 * k3u + k4u)
        s = s + (dt_ / 6.0) * (k1s + 2 * k2s + 2 * k3s + k4s)
        if damp is not None:
            u = u * damp[:, :, None]
            s = s * damp[:, :, None]
        return State(u=u, s=s)

    return step


def make_rk4_step_visco(p: ElasticParams, w: UpwindData, v, dt: float,
                        src: SourceData | None = None,
                        damp: torch.Tensor | None = None):
    """Viscoelastic RK4 step: (State, xi, t) -> (State, xi) with memory
    variables xi (E, n_p, n_sig, L) (ops/viscoelastic.py).  Point sources
    inject into the momentum/stress balance AFTER the anelastic target is
    computed (not into the constitutive strain rate), so they bypass it."""
    from ..ops.viscoelastic import anelastic_rates

    dt_ = numpy_dtype(p.dtype)(dt)

    def rhs(u, s, xi, t):
        du, ds_el = apply_coupled_upwind(p, w, u, s, _gather(p, u),
                                         _gather(p, s))
        dxi, xi_sum = anelastic_rates(v, ds_el, xi, p.dim)
        du, ds = _add_sources(src, du, ds_el - xi_sum, t)
        return du, ds, dxi

    def step(state: State, xi, t):
        u, s = state.u, state.s
        k1 = rhs(u, s, xi, t)
        k2 = rhs(u + 0.5 * dt_ * k1[0], s + 0.5 * dt_ * k1[1],
                 xi + 0.5 * dt_ * k1[2], t + 0.5 * dt_)
        k3 = rhs(u + 0.5 * dt_ * k2[0], s + 0.5 * dt_ * k2[1],
                 xi + 0.5 * dt_ * k2[2], t + 0.5 * dt_)
        k4 = rhs(u + dt_ * k3[0], s + dt_ * k3[1], xi + dt_ * k3[2],
                 t + dt_)
        u = u + (dt_ / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        s = s + (dt_ / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        xi = xi + (dt_ / 6.0) * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
        if damp is not None:
            u = u * damp[:, :, None]
            s = s * damp[:, :, None]
            xi = xi * damp[:, :, None, None]
        return State(u=u, s=s), xi

    return step


def run_rk4_visco(p: ElasticParams, w: UpwindData, v, state0: State,
                  dt: float, n_steps: int, xi0: torch.Tensor | None = None,
                  src: SourceData | None = None,
                  damp: torch.Tensor | None = None,
                  receivers: ReceiverData | None = None,
                  segment: int | None = None):
    """Viscoelastic run; returns (final State, final xi, seismograms tensor
    (n_steps, R, dim) or None).  Step k starts at t = k*dt in the run
    dtype.

    ``segment`` (must divide n_steps) runs the steps in checkpointed
    chunks (timestep.scan_steps) — what reverse mode needs at scale, since
    the carry includes the (E, n_p, n_sig, L) memory variables (Q-FWI
    gradients, solver/adjoint.py make_visco_fwi_gradient)."""
    step = make_rk4_step_visco(p, w, v, dt, src=src, damp=damp)
    npdt = numpy_dtype(p.dtype)
    dt_ = npdt(dt)
    if xi0 is None:
        xi0 = torch.zeros(state0.s.shape + (v.L,), dtype=state0.s.dtype,
                          device=state0.s.device)
    record = (None if receivers is None
              else lambda c: sample(receivers, c[0].u))
    (state, xi), seis = scan_steps(
        lambda c, t: step(c[0], c[1], t), (state0, xi0),
        [npdt(n) * dt_ for n in range(n_steps)], record, segment)
    return state, xi, seis


def run_rk4(p: ElasticParams, w: UpwindData, state0: State, dt: float,
            n_steps: int, src: SourceData | None = None,
            damp: torch.Tensor | None = None,
            receivers: ReceiverData | None = None):
    """Run n_steps of RK4+upwind; returns (final State, seismograms tensor
    (n_steps, R, dim) or None).  Step k starts at t = k*dt in the run
    dtype."""
    step = make_rk4_step(p, w, dt, src=src, damp=damp)
    npdt = numpy_dtype(p.dtype)
    dt_ = npdt(dt)
    return scan_steps(step, state0, [npdt(n) * dt_ for n in range(n_steps)],
                      None if receivers is None
                      else lambda st: sample(receivers, st.u))
