"""v2 exchange-fused LF operators — CUDA kernels K8/K9 and their plain twins.

Port of ``seigen_tpu/ops/fused_kernels.py:vel2_op`` / ``stress2_op`` (the
v2 lane pipeline).  An operator reads the traces of its input
that the trace exchange (solver/lane_fused.py) has already put in CONSUMER
order — signed neighbour tractions for the velocity operator, neighbour
velocities for the stress operator, the own value on boundary faces — at
its own lane, and emits the face traces of its output (tractions for a
stress output) for the next exchange.

Layout (the JAX package's, so arrays compare row for row):
  state arrays (C*npp, E), lanes class-major, no padding;
  trace arrays (dim*ftpp, E), component-major rows c*ftpp + f*n_fp + k,
  pad rows ftp..ftpp of each component zero.
On packed P1 operator data (n_par = 2, ops/fused_kernels.py) a lane holds
two elements: state rows c*npp + par*4 + i and trace rows
c*ftpp + par*ftq + f*n_fp + k, ftq = nf*n_fp.

The physics is that of the merged operators, written once in
ops/merged_kernels.py:vel_body / stress_body; the kernels are the V2
instantiations of K1/K2's tile kernel (csrc/merged_kernels.cu,
csrc/merged_tile.cuh); on the packed layout both run the packed tile
kernel, which reads the parities' 1/rho rows at stride ``irho_par`` = 1
(the P1 pack probe's K11: 4).
``vel2_op``/``stress2_op`` launch K8/K9 for CUDA tensors and run
``vel2_op_ref``/``stress2_op_ref`` for CPU tensors.  Launch counts: ``VEL2_KERNEL.launches``,
``STRESS2_KERNEL.launches``, ``STRESS2_KERNEL.launches_c`` (general Hooke
law) and ``launches_pk`` of both (packed layout).  Source injection happens outside these operators (the v2 runner
scatters it into the field and the traces).
"""

from __future__ import annotations

import torch

from .fused_kernels import FusedOpData
from .merged_kernels import MergedKernel, stress_body, vel_body


def exchanged_rows(d: FusedOpData, tr):
    """(dim*ftpp, E) consumer-order traces -> (dim, ftp, E) (packed: rows
    par*ftq + f*n_fp + k of each component)."""
    return tr.reshape(d.dim, d.ftpp, -1)[:, : d.ftp]


def emit_components(d: FusedOpData, tr):
    """(C, ftp, E) face-node traces -> (C*ftpp, E) component-major rows,
    pad rows 0."""
    C, E = tr.shape[0], tr.shape[-1]
    out = tr.new_zeros((C, d.ftpp, E))
    out[:, : d.ftp] = tr
    return out.reshape(C * d.ftpp, E)


def vel2_op_ref(d: FusedOpData, sig_lm, tr, axpy=None, dt=0.0, c3=0.0):
    """Plain version of K8 (see vel2_op)."""
    return vel_body(d, sig_lm, lambda t_own: exchanged_rows(d, tr),
                    lambda t: emit_components(d, t), axpy, dt, c3)


def stress2_op_ref(d: FusedOpData, u_lm, tr, axpy=None, dt=0.0, c3=0.0):
    """Plain version of K9 (see stress2_op)."""
    return stress_body(d, u_lm, lambda own: exchanged_rows(d, tr),
                       lambda t: emit_components(d, t), axpy, dt, c3)


class FusedKernel(MergedKernel):
    """ctypes binding of K8 or K9: the v2 layout of a merged operator
    kernel, with its own launch counts."""

    def __call__(self, d: FusedOpData, field, tr, axpy=None, damp=None,
                 dt=0.0, c3=0.0):
        return self.launch(d, field, tr, d.dim * d.ftpp, d.ftpp, axpy=axpy,
                           damp=damp, dt=dt, c3=c3)


VEL2_KERNEL = FusedKernel("seigen_fused_vel2", "fused_vel2", vel=True)
STRESS2_KERNEL = FusedKernel("seigen_fused_stress2", "fused_stress2",
                             vel=False)


def vel2_op(d: FusedOpData, sig_lm, tr, axpy=None, dt=0.0, c3=0.0):
    """v2 velocity operator (K8): sig_lm (n_sig*npp, E), tr (dim*ftpp, E)
    signed neighbour tractions in consumer order.  Returns (out
    (dim*npp, E), velocity traces of out (dim*ftpp, E)).

    axpy: None or (u, uh1) -> out = u + dt*uh1 + c3*du.

    CUDA tensors launch K8; CPU tensors run vel2_op_ref.
    """
    if sig_lm.device.type == "cuda":
        return VEL2_KERNEL(d, sig_lm, tr, axpy=axpy, dt=dt, c3=c3)
    return vel2_op_ref(d, sig_lm, tr, axpy=axpy, dt=dt, c3=c3)


def stress2_op(d: FusedOpData, u_lm, tr, axpy=None, dt=0.0, c3=0.0):
    """v2 stress operator (K9): u_lm (dim*npp, E), tr (dim*ftpp, E)
    neighbour velocity traces in consumer order; axpy (s, sh1) also folds
    d.damp: out = damp*(s + dt*sh1 + c3*ds).  Emits traction traces.
    Operator data with a ``C`` section takes the general Hooke law.

    CUDA tensors launch K9; CPU tensors run stress2_op_ref.
    """
    if u_lm.device.type == "cuda":
        damp = d.damp if axpy is not None else None
        return STRESS2_KERNEL(d, u_lm, tr, axpy=axpy, damp=damp, dt=dt,
                              c3=c3)
    return stress2_op_ref(d, u_lm, tr, axpy=axpy, dt=dt, c3=c3)
