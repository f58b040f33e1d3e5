"""The general sharded path: the einsum step on a block of elements a rank,
the halo ghosts by ``Comm.permute`` rounds.

Port of ``seigen_tpu/parallel/dist_ops.py``.  ``partition.make_plan``
orders the elements along a Morton curve and cuts them into one block a
rank (the last padded with inert self-connected elements); its ``nbr_local``
points every face node into [the block's flat nodes | K*H ghosts].  Before
each operator a rank gathers the face nodes its neighbours need
(``send_idx``), and K rounds of ``Comm.permute`` (the JAX package's
``lax.ppermute``) bring theirs: the pool the einsum operators
(ops/elastic.py, ``pool=``) gather from.  No kernel runs here: this path is
the oracle of the sharded paths on any conforming mesh, as it is in the
JAX package.

Receivers sum their partial samples over the ranks (JAX's per-step
``psum``); sources live on the rank of their element, amplitude 0
elsewhere.  ``run_distributed`` returns the global State and the
seismograms on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.elastic import ElasticParams, Material, apply_stress_op, \
    apply_vel_op, build_params
from ..solver.receivers import ReceiverData
from ..solver.source import SourceData, inject_stress, inject_velocity
from ..solver.timestep import State, compose_lf_step, damp_post, \
    numpy_dtype
from . import comm as _comm
from .partition import Plan, make_plan

# the element-axis fields of ElasticParams (nbr is the plan's)
_ELEM_FIELDS = ("Ginv", "Fscale", "normals", "inv_rho", "lam", "mu",
                "beta_t", "delta_u")


def _permute_pad(arr: np.ndarray, plan: Plan, pad_value=0.0) -> np.ndarray:
    """The element permutation, then the padding rows."""
    out = arr[plan.perm]
    if plan.E_pad > plan.E:
        pad = np.full((plan.E_pad - plan.E,) + arr.shape[1:], pad_value,
                      dtype=arr.dtype)
        out = np.concatenate([out, pad], axis=0)
    return out


def _rows(plan: Plan, rank: int) -> slice:
    return slice(rank * plan.block, (rank + 1) * plan.block)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def shard_params(dense: ElasticParams, plan: Plan, rank: int,
                 device=None) -> ElasticParams:
    """Rank ``rank``'s block of a dense ElasticParams: its elements
    permuted and padded (zero geometry and material), ``nbr`` the plan's
    halo-remapped local index."""
    device = torch.device(device) if device is not None else dense.device
    rows = _rows(plan, rank)

    def pp(x):
        a = _permute_pad(_host(x), plan)[rows]
        return torch.as_tensor(a, device=device).to(dense.dtype)

    return dataclasses.replace(
        dense, Dr=dense.Dr.to(device), LIFT=dense.LIFT.to(device),
        nbr=torch.as_tensor(plan.nbr_local[rows], device=device).to(
            torch.int64),
        **{f: pp(getattr(dense, f)) for f in _ELEM_FIELDS})


def shard_state(state: State, plan: Plan, rank: int, device=None) -> State:
    """Rank ``rank``'s block of a global State."""
    rows = _rows(plan, rank)

    def pp(x):
        return torch.as_tensor(_permute_pad(_host(x), plan)[rows],
                               device=device or x.device).to(x.dtype)

    return State(u=pp(state.u), s=pp(state.s))


def unshard_field(arr, plan: Plan) -> torch.Tensor:
    """The padded, permuted (E_pad, ...) field of every block in rank
    order -> (E, ...) in the mesh's element order."""
    a = arr[: plan.E]
    out = torch.empty_like(a)
    out[torch.as_tensor(plan.perm, device=a.device)] = a
    return out


def _new_elem(plan: Plan, elems) -> np.ndarray:
    inv = np.full(plan.E, -1, dtype=np.int64)
    inv[plan.perm] = np.arange(plan.E)
    return inv[_host(elems)]


def shard_sources(src: SourceData | None, plan: Plan) -> SourceData | None:
    """Per-shard source entries stacked on a leading (P,) axis, each
    shard's padded to the largest count with zeros (amplitude 0)."""
    if src is None:
        return None
    P_ = plan.n_shards
    new_e = _new_elem(plan, src.elems)
    shard, local = new_e // plan.block, new_e % plan.block
    S_max = max(int(np.bincount(shard, minlength=P_).max()), 1)
    slot = np.zeros(len(new_e), dtype=np.int64)
    fill = np.zeros(P_, dtype=np.int64)
    for k, q in enumerate(shard):
        slot[k] = fill[q]
        fill[q] += 1
    K = len(new_e)

    def pack(x):
        v = np.broadcast_to(_host(x), (K,) + tuple(x.shape[1:]))
        out = np.zeros((P_, S_max) + v.shape[1:], dtype=v.dtype)
        out[shard, slot] = v
        return torch.as_tensor(out, device=x.device)

    elems = np.zeros((P_, S_max), dtype=np.int64)
    elems[shard, slot] = local
    return SourceData(elems=torch.as_tensor(elems, device=src.elems.device),
                      vec_u=pack(src.vec_u), vec_s=pack(src.vec_s),
                      f0=pack(src.f0), t0=pack(src.t0), amp=pack(src.amp))


def shard_receivers(rcv: ReceiverData | None, plan: Plan):
    """(P, R) local element ids and (P, R, n_p) weights, zero on the
    shards that do not hold the receiver."""
    if rcv is None:
        return None
    new_e = _new_elem(plan, rcv.elems)
    shard, local = new_e // plan.block, new_e % plan.block
    R = len(new_e)
    w = _host(rcv.weights)
    elems = np.zeros((plan.n_shards, R), dtype=np.int64)
    ws = np.zeros((plan.n_shards,) + w.shape, dtype=w.dtype)
    elems[shard, np.arange(R)] = local
    ws[shard, np.arange(R)] = w
    dev = rcv.weights.device
    return ReceiverData(elems=torch.as_tensor(elems, device=dev),
                        weights=torch.as_tensor(ws, device=dev))


def _halo_pool(flat, send_idx, plan: Plan, comm: _comm.Comm):
    """[local flat nodes | ghosts] of one field: K permute rounds."""
    if plan.n_rounds == 0:
        return flat
    ghosts = [comm.permute(flat[send_idx[k]], plan.round_perms[k])
              for k in range(plan.n_rounds)]
    return torch.cat([flat] + ghosts, dim=0)


def _at(data, rank):
    """Row ``rank`` of a shard-stacked SourceData / ReceiverData."""
    if data is None:
        return None
    return type(data)(**{f.name: getattr(data, f.name)[rank]
                         for f in dataclasses.fields(data)})


def make_sharded_run(plan: Plan, params: ElasticParams, dt: float,
                     n_steps: int, order: int = 4,
                     src: SourceData | None = None, damp=None,
                     receivers: ReceiverData | None = None,
                     comm: _comm.Comm | None = None, step0: int = 0):
    """``call(state) -> (final state, seismograms (n_steps, R, dim) or
    None)`` on this rank's block.  ``params`` and ``state`` are the rank's
    block (shard_params, shard_state), ``damp`` its (block, n_p) rows
    (padding 1.0), ``src``/``receivers`` the shard-stacked ones
    (shard_sources, shard_receivers).  ``step0``: the global index of the
    first step (a resumed run keeps its sources in phase)."""
    comm = comm if comm is not None else _comm.current(params.device)
    if comm.world != plan.n_shards:
        raise ValueError(f"a plan of {plan.n_shards} shards on a comm of "
                         f"{comm.world} ranks")
    p = params
    send_idx = torch.as_tensor(plan.send_idx[comm.rank].astype(np.int64),
                               device=p.device)
    src_l, rcv_l = _at(src, comm.rank), _at(receivers, comm.rank)

    def vel(s):
        pool = _halo_pool(s.reshape(-1, p.n_sig), send_idx, plan, comm)
        return apply_vel_op(p, s, pool=pool)

    def stress(u):
        pool = _halo_pool(u.reshape(-1, p.dim), send_idx, plan, comm)
        return apply_stress_op(p, u, pool=pool)

    npdt = numpy_dtype(p.dtype)
    dt_ = npdt(dt)
    step = compose_lf_step(
        vel=vel, stress=stress,
        inject_u=lambda du, t: inject_velocity(src_l, du, t),
        inject_s=lambda ds, t: inject_stress(src_l, ds, t),
        post=damp_post(damp), dt=dt_, order=order)

    def call(state: State):
        u, s = state.u, state.s
        parts = []
        for n in range(step0, step0 + n_steps):
            u, s = step(u, s, npdt(n) * dt_)
            if rcv_l is not None:
                parts.append(torch.einsum("ri,ric->rc", rcv_l.weights,
                                          u[rcv_l.elems]))
        # one sum over the ranks for the whole run: the same numbers as
        # JAX's psum of every step's partial samples
        seis = (comm.all_reduce_sum(torch.stack(parts)) if parts
                else None)
        return State(u=u, s=s), seis

    return call


def run_distributed(dm, mat: Material, state0: State, dt: float,
                    n_steps: int, comm: _comm.Comm | None = None,
                    order: int = 4, sources: SourceData | None = None,
                    damp=None, receivers: ReceiverData | None = None,
                    dtype=torch.float32, step0: int = 0,
                    plan: Plan | None = None):
    """Partition, shard, run on this process's ranks (``comm``, default
    the process group's); returns (the final State in the mesh's element
    order, seismograms numpy or None, the plan) on every rank.  ``plan``:
    one made earlier for the same mesh and rank count (a chunked run)."""
    comm = comm if comm is not None else _comm.current(state0.u.device)
    dev = comm.device
    plan = plan if plan is not None else make_plan(dm, comm.world)
    dense = build_params(dm, mat, dtype=dtype, device="cpu")
    p = shard_params(dense, plan, comm.rank, device=dev)
    st = shard_state(State(u=state0.u.to(dtype), s=state0.s.to(dtype)),
                     plan, comm.rank, device=dev)
    rows = _rows(plan, comm.rank)
    damp_r = (None if damp is None else torch.as_tensor(
        _permute_pad(_host(damp), plan, 1.0)[rows], device=dev).to(dtype))

    def place(data):
        if data is None:
            return None
        return type(data)(**{
            f.name: getattr(data, f.name).to(dev).to(
                dtype if getattr(data, f.name).is_floating_point()
                else torch.int64) for f in dataclasses.fields(data)})

    call = make_sharded_run(plan, p, dt, n_steps, order=order,
                            src=place(shard_sources(sources, plan)),
                            damp=damp_r,
                            receivers=place(shard_receivers(receivers,
                                                            plan)),
                            comm=comm, step0=step0)
    fin, seis = call(st)
    u, s = (unshard_field(torch.cat(comm.all_gather(x)), plan)
            for x in (fin.u, fin.s))
    return State(u=u, s=s), (None if seis is None
                             else seis.cpu().numpy()), plan
