"""C-PML absorbing layers: profiles + the einsum RK4 method-of-lines stepper.

Port of ``seigen_tpu/solver/pml.py``.  A graded C-PML absorbs broadband at
all angles, where first-order characteristic BCs reflect at oblique
incidence and a Cerjan sponge (solver/damping.py) reflects at its
interface.

Formulation (unsplit convolutional PML, kappa = 1): per PML-active
direction d, memory fields augment each DG spatial derivative,

    udot   = (1/rho) sum_d (V_d(sigma) + psi_v[d])
    psidot_v[d] = -(d_d + alpha_d) psi_v[d] - d_d V_d(sigma)
    sdot   = C : gtilde,   gtilde[d, c] = G_d(u)[c] + psi_s[d][c]
    psidot_s[d] = -(d_d + alpha_d) psi_s[d] - d_d G_d(u)

with the EXACT direction-split DG operators V_d / G_d of ops/cpml.py (in
the interior d_d = 0, so psi stays identically zero and the RHS reduces to
the plain central-flux operators).  The memory ODEs are plain additions to
the state, so classical RK4 integrates everything together; ``run_cpml`` is
a Python loop over steps.  The staggered LF4 scheme is not used: its cubic
correction stages have no consistent place for the convolution update.

This is the oracle of the lane runner (solver/lane_cpml.py), which gets
the same split operators from the K1/K2 kernels.

Profiles (Komatitsch & Martin 2007): polynomial grading
d(x) = d0 (xi)^p_exp with d0 = -(p_exp+1) vp ln(R0) / (2 W), and
alpha(x) = pi f0 (1 - xi) from pi*f0 at the interface to 0 at the outer
boundary (shifts the pole off DC, stabilizing grazing incidence).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.discrete import DiscreteMesh
from ..ops.cpml import apply_grad_op_split, apply_vel_op_split, \
    hooke_pointwise
from ..ops.elastic import ElasticParams
from .receivers import ReceiverData, sample
from .source import SourceData, inject_stress, inject_velocity
from .timestep import numpy_dtype


@dataclass(frozen=True)
class CpmlState:
    """Wavefield + per-direction C-PML memory fields."""

    u: torch.Tensor  # (E, n_p, dim)
    s: torch.Tensor  # (E, n_p, n_sig)
    pv: torch.Tensor  # (E, dim, n_p, dim)  memory for V_d(sigma)
    ps: torch.Tensor  # (E, dim, n_p, dim)  memory for G_d(u)

    def fields(self):
        return self.u, self.s, self.pv, self.ps


def cpml_init(p: ElasticParams, u0, s0) -> CpmlState:
    """Zero-memory C-PML state from co-located (u, sigma) at t=0."""
    u0, s0 = torch.as_tensor(u0), torch.as_tensor(s0)
    z = u0.new_zeros((u0.shape[0], p.dim, p.n_p, p.dim))
    return CpmlState(u=u0, s=s0, pv=z, ps=z)


def cpml_profiles(
    dm: DiscreteMesh,
    sides: list[tuple[int, str]],
    width: float,
    vp_max: float,
    f0: float = 2.0,
    R0: float = 1e-4,
    p_exp: float = 2.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-node damping/shift profiles (d, alpha), each (E, n_p, dim).

    sides: (axis, "lo"|"hi") pairs naming domain sides backed by a PML of
    the given physical width (measured inward from the domain extent).
    Directions never named get d = alpha = 0 everywhere (psi stays exactly
    0 there).
    """
    coords = dm.coords  # (E, n_p, dim)
    d = np.zeros(coords.shape, dtype=np.float64)
    a = np.zeros(coords.shape, dtype=np.float64)
    d0 = -(p_exp + 1.0) * vp_max * np.log(R0) / (2.0 * width)
    for ax, side in sides:
        lo, hi = dm.topology.extents[ax]
        x = coords[..., ax]
        if side == "lo":
            xi = np.clip((lo + width - x) / width, 0.0, 1.0)
        else:
            xi = np.clip((x - (hi - width)) / width, 0.0, 1.0)
        d[..., ax] = np.maximum(d[..., ax], d0 * xi**p_exp)
        a[..., ax] = np.maximum(a[..., ax], np.pi * f0 * (1.0 - xi) * (xi > 0))
    return d, a


def make_cpml_rhs(
    p: ElasticParams,
    dprof: np.ndarray,
    aprof: np.ndarray,
    src: SourceData | None = None,
):
    """RHS closure (t, CpmlState) -> CpmlState of rates."""

    def dev(a):  # (E, n_p, dim) -> (E, dim, n_p, 1) against psi
        return torch.as_tensor(np.transpose(a, (0, 2, 1))[..., None],
                               device=p.device).to(p.dtype)

    dd = dev(dprof)
    decay = dev(dprof + aprof)

    def rhs(t, st: CpmlState) -> CpmlState:
        Vd = apply_vel_op_split(p, st.s)  # (E, dim, n_p, dim)
        Gd = apply_grad_op_split(p, st.u)
        udot = p.inv_rho[:, None, None] * torch.sum(Vd + st.pv, dim=1)
        sdot = hooke_pointwise(p, Gd + st.ps)
        return CpmlState(
            u=inject_velocity(src, udot, t),
            s=inject_stress(src, sdot, t),
            pv=-decay * st.pv - dd * Vd,
            ps=-decay * st.ps - dd * Gd,
        )

    return rhs


def run_cpml(
    p: ElasticParams,
    state0: CpmlState,
    dt: float,
    n_steps: int,
    rhs,
    receivers: ReceiverData | None = None,
    step0: int = 0,
):
    """Classical RK4 over n_steps; returns (final CpmlState, seismograms
    tensor (n_steps, R, dim) or None).  Step k starts at t = k*dt in the run
    dtype."""
    npdt = numpy_dtype(p.dtype)
    dt_ = npdt(dt)

    def ax(st, k, c):
        return CpmlState(*(x + c * y for x, y in zip(st.fields(),
                                                     k.fields())))

    st, seis = state0, []
    for n in range(step0, step0 + n_steps):
        t = npdt(n) * dt_
        k1 = rhs(t, st)
        k2 = rhs(t + 0.5 * dt_, ax(st, k1, 0.5 * dt_))
        k3 = rhs(t + 0.5 * dt_, ax(st, k2, 0.5 * dt_))
        k4 = rhs(t + dt_, ax(st, k3, dt_))
        st = CpmlState(*(
            x + (dt_ / 6.0) * (a + 2 * b + 2 * c + d)
            for x, a, b, c, d in zip(st.fields(), k1.fields(), k2.fields(),
                                     k3.fields(), k4.fields())))
        if receivers is not None:
            seis.append(sample(receivers, st.u))
    return st, (torch.stack(seis) if seis else None)
