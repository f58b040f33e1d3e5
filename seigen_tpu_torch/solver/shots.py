"""Ensemble-of-shots batching: the forward solve over several sources.

Port of ``seigen_tpu/solver/shots.py``.  Shots are independent seismic
experiments sharing the mesh and the material; a stacked ``SourceData``
carries them on a leading shot axis.  ``shard_shots`` gives each rank of a
process group its contiguous share of the shots (data parallelism: no
traffic while they run).
``run_shots`` solves them in one batched loop (``batch="vmap"``: the
per-shot step under ``torch.func.vmap``, the state and the seismograms
with a leading shot axis) or one shot after the other (``"map"``,
``"host"``); the three give the same numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.elastic import ElasticParams, apply_stress_op, apply_vel_op
from .adjoint import run_segmented
from .receivers import ReceiverData, sample
from .source import SourceData
from .timestep import State, make_step, numpy_dtype, scan_steps

_FIELDS = tuple(f.name for f in dataclasses.fields(SourceData))


def pad_shot(s: SourceData, K: int) -> SourceData:
    """Pad a shot's source entries to K with zero-amplitude entries
    (element 0, zero vectors — injecting exactly nothing)."""
    k = s.elems.shape[0]
    if k == K:
        return s
    pad = K - k

    def pz(x):
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

    return SourceData(
        elems=pz(s.elems), vec_u=pz(s.vec_u), vec_s=pz(s.vec_s),
        # padded wavelets get f0 = 1 (ricker divides by f0), amp = 0
        f0=torch.cat([s.f0, s.f0.new_ones((pad,))]),
        t0=pz(s.t0), amp=pz(s.amp))


def stack_shots(shots: list[SourceData]) -> SourceData:
    """Stack per-shot SourceData into one with a leading shot axis; shots
    with different entry counts are zero-amplitude padded to the
    largest."""
    K = max(s.elems.shape[0] for s in shots)
    shots = [pad_shot(s, K) for s in shots]
    return SourceData(**{f: torch.stack([getattr(s, f) for s in shots])
                         for f in _FIELDS})


def shot_at(shots: SourceData, i: int) -> SourceData:
    """Shot ``i`` of a stacked SourceData."""
    return SourceData(**{f: getattr(shots, f)[i] for f in _FIELDS})


def shard_shots(shots: SourceData, comm=None) -> SourceData:
    """The contiguous n_shots/P shots of rank r of ``comm`` (default: the
    process group's), P its rank count: the port's layout of the shot
    axis over a "shot" mesh axis.  n_shots must be a multiple of P."""
    from ..parallel.comm import current

    comm = comm if comm is not None else current(shots.elems.device)
    S, P = shots.elems.shape[0], comm.world
    if S % P:
        raise ValueError(f"n_shots {S} not divisible by {P} ranks")
    k = S // P
    return SourceData(**{f: getattr(shots, f)[comm.rank * k :
                                              (comm.rank + 1) * k]
                         for f in _FIELDS})


def run_shots(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    shots: SourceData,
    receivers: ReceiverData | None = None,
    order: int = 4,
    damp: torch.Tensor | None = None,
    segment: int | None = None,
    vel_op=None,
    stress_op=None,
    batch: str = "vmap",
):
    """Forward solve over the leading shot axis of ``shots``.

    Returns (final States with a leading shot axis, seismograms (S,
    n_steps, R, dim) or None).  ``state0`` is shared by the shots.
    ``batch``: "vmap" runs every shot in one loop (the per-shot step under
    torch.func.vmap; memory grows with the shot count); "map" and "host"
    run the shots one after the other."""
    S = shots.elems.shape[0]
    if batch in ("map", "host"):
        outs = [run_segmented(
            p, state0, dt, n_steps, segment=segment, order=order,
            src=shot_at(shots, i), damp=damp, receivers=receivers,
            vel_op=vel_op, stress_op=stress_op) for i in range(S)]
        final = State(u=torch.stack([o[0].u for o in outs]),
                      s=torch.stack([o[0].s for o in outs]))
        seis = (torch.stack([o[1] for o in outs])
                if outs[0][1] is not None else None)
        return final, seis
    if batch != "vmap":
        raise ValueError(f"batch must be vmap, map or host: {batch!r}")
    vo, so = vel_op or apply_vel_op, stress_op or apply_stress_op

    def one(u, s, t, *src):
        st = make_step(p, dt, order=order, src=SourceData(*src), damp=damp,
                       vel_op=vo, stress_op=so)(State(u=u, s=s), t)
        return st.u, st.s

    vstep = torch.func.vmap(one, in_dims=(0, 0, None) + (0,) * len(_FIELDS))
    src = tuple(getattr(shots, f) for f in _FIELDS)
    record = None
    if receivers is not None:
        vsample = torch.func.vmap(lambda u: sample(receivers, u))
        record = lambda c: vsample(c[0])  # noqa: E731
    npdt = numpy_dtype(p.dtype)
    dt_ = npdt(dt)
    (u, s), seis = scan_steps(
        lambda c, t: vstep(c[0], c[1], t, *src),
        (state0.u.expand((S,) + state0.u.shape),
         state0.s.expand((S,) + state0.s.shape)),
        [npdt(k) * dt_ for k in range(n_steps)], record, segment)
    return State(u=u, s=s), (None if seis is None else seis.transpose(0, 1))


def shots_misfit(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    shots: SourceData,
    receivers: ReceiverData,
    observed: torch.Tensor,
    order: int = 4,
    damp: torch.Tensor | None = None,
    segment: int | None = None,
    batch: str = "vmap",
) -> torch.Tensor:
    """0.5 * sum over shots of ||seis_s - observed_s||^2."""
    _, seis = run_shots(
        p, state0, dt, n_steps, shots, receivers=receivers, order=order,
        damp=damp, segment=segment, batch=batch)
    r = seis - observed
    return 0.5 * torch.sum(r * r)
