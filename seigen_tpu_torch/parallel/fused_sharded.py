"""Slab-sharded merged LF4 runner: the multi-GPU form of the main path.

Port of ``seigen_tpu/parallel/fused_sharded.py:ShardedFusedRunner``.  The
structured supercell grid is cut into ``n_shards`` slabs along its outer
axis (``n_shards | G0``); rank r holds slab r — every class, G0/P planes
of supercells — in the class-major lane layout of ``MergedLaneRunner``,
and steps it with the same merged operators (K1/K2, packed K1pk/K2pk).
The only traffic between ranks is one trace-plane exchange per operator:
each rank sends the first and last supercell planes of the producer trace
rows whose links cross the slab boundary (``_halo_g``) to its ring
neighbours, which land in the Grest halo lanes that the plan reserves on
both sides of every class's trace lanes (``build_merged_plan(G0loc=,
halo=True)``).  The operators then read across the boundary through
their ordinary links.

``overlap`` (off by default): each operator runs as two launches over
lane ranges (``split_lanes``): the interior lanes, whose links read no
halo lane, take the traces before the fill and launch first; the halo
exchange runs on NCCL's streams meanwhile; the boundary lanes launch
after the receive.  The result is bitwise that of one launch.  It is
opt-in because it has not won reproducibly: on one H100 it only adds
launches, and on NCCL ranks, where the host's launching of the exchange
sets the pace, its gain or loss changed sign from run to run (PERF.md,
§6).

``fill_mode`` (as the JAX runner's): ``auto`` (``off`` at one shard,
``ppermute`` otherwise), ``off`` (no halo lanes: exactly the one-device
layout; one shard only), ``ppermute`` (the exchange), ``local`` (the
plane copies without the exchange; one shard only), ``skip`` (halo lanes
reserved, never filled; one shard only: every link that reads them is
boundary-masked there).

Every rank builds the same host plan (NumPy, deterministic) and keeps its
slab.  Sources and receivers live on the rank whose slab holds their
element; ``run`` returns the global State and the seismograms in the
caller's receiver order on every rank.  The processes and their
``Comm`` come from ``parallel/comm.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.merged_kernels import build_merged_plan, split_lanes
from ..ops.structured_exchange import StructuredExchange
from ..solver.lane_fused import _canonical_shift, derive_pairing
from ..solver.lane_merged import MergedLaneRunner
from ..solver.receivers import ReceiverData
from ..solver.source import SourceData
from ..solver.timestep import State
from . import comm as _comm

FILL_MODES = ("off", "ppermute", "local", "skip")


def slab_perm(ex: StructuredExchange, E: int, n_shards: int):
    """Dense slab order (the JAX runner's ``_compute_perm``): element e_new
    = ((shard*m + cls)*G0loc + g0l)*Grest + rest, so shard r owns the
    E/n_shards elements from r*E/n_shards on, class-major within.
    Returns (old_of_new, new_of_old)."""
    base_grid, scale, m0 = ex.base_grid, ex.scale, ex.m0
    G0loc = ex.grid[0] // n_shards
    idx = np.arange(E)
    t = idx % m0
    c = idx // m0
    cs = []
    for g in reversed(base_grid):
        cs.append(c % g)
        c = c // g
    cs = cs[::-1]
    sup = [ci // scale for ci in cs]
    sub = [ci % scale for ci in cs]
    k = np.zeros_like(t)
    for s in sub:
        k = k * scale + s
    cls = k * m0 + t
    rest = np.zeros_like(t)
    for g, ci in zip(ex.grid[1:], sup[1:]):
        rest = rest * g + ci
    shard, g0l = sup[0] // G0loc, sup[0] % G0loc
    Grest = int(np.prod(ex.grid[1:]))
    new_of_old = ((shard * ex.m + cls) * G0loc + g0l) * Grest + rest
    old_of_new = np.empty(E, dtype=np.int64)
    old_of_new[new_of_old] = np.arange(E)
    return old_of_new, new_of_old


def halo_groups(ex: StructuredExchange, n_par: int = 1):
    """(left, right): the trace row blocks g = f2*n_par + producer parity
    (rtq rows each) whose links leave the slab along axis 0 towards lower
    (left) or higher (right) supercells — the only rows a halo fill ships
    (the JAX runner's ``_halo_g``)."""
    f2x, _ = derive_pairing(ex)
    gl, gr = set(), set()
    for t in range(ex.m):
        for f in range(ex.n_faces):
            off = _canonical_shift(ex, t, f)
            blk = int(f2x[t, f]) * n_par + int(ex.nbr_class[t, f]) % n_par
            if off[0] < 0:
                gl.add(blk)
            elif off[0] > 0:
                gr.add(blk)
    return tuple(sorted(gl)), tuple(sorted(gr))


def _subset(data, keep):
    """A SourceData or ReceiverData restricted to the entries ``keep``."""
    if not keep.any():
        return None
    k = torch.as_tensor(np.nonzero(keep)[0], device=data.elems.device)
    return type(data)(**{f: getattr(data, f)[k]
                         for f in data.__dataclass_fields__})


def gather_seismograms(comm, rcv_ranks, seis, n_steps, C, like):
    """Every rank's (n_steps, R_rank, C) samples (None: it holds no
    receiver) -> (n_steps, R, C) in the caller's receiver order, on every
    rank; ``rcv_ranks[r]``: the receivers rank r holds, ``like``: a tensor
    of the run's dtype and device."""
    R_max = max(len(i) for i in rcv_ranks)
    pad = like.new_zeros((n_steps, R_max, C))
    if seis is not None:
        pad[:, : seis.shape[1]] = seis
    parts = comm.all_gather(pad)
    out = pad.new_empty((n_steps, sum(map(len, rcv_ranks)), C))
    for r, idx in enumerate(rcv_ranks):
        out[:, torch.as_tensor(idx, device=out.device)] = (
            parts[r][:, : len(idx)])
    return out


def _n_groups(src):
    """Distinct (f0, t0) wavelet groups of a SourceData (None: 0)."""
    if src is None:
        return 0
    K = src.elems.shape[0]
    f0, t0 = (np.broadcast_to(x.detach().cpu().numpy().astype(np.float64),
                              (K,)) for x in (src.f0, src.t0))
    return len({(round(float(a), 12), round(float(b), 12))
                for a, b in zip(f0, t0)})


class SlabRunner:
    """The slab machinery of the sharded merged-layout runners, mixed in
    before a one-device runner (MergedLaneRunner, UpwindLaneRunner): the
    slab's lanes, the halo plan, the fill, sources and receivers of the
    slab, the gathered results."""

    def _slab_setup(self, ex, n_shards, comm, fill_mode, overlap,
                    device):
        if fill_mode == "auto":
            fill_mode = "off" if n_shards == 1 else "ppermute"
        if fill_mode not in FILL_MODES:
            raise ValueError(f"unknown fill_mode {fill_mode!r}")
        if fill_mode != "ppermute" and n_shards > 1:
            raise ValueError(
                f"fill_mode={fill_mode!r} is exact only at n_shards==1")
        G0 = ex.grid[0]
        if G0 % n_shards:
            raise ValueError(
                f"slab sharding needs n_shards | G0 ({n_shards} vs {G0})")
        self.comm = comm if comm is not None else _comm.current(device)
        if self.comm.world != n_shards:
            raise ValueError(f"{n_shards} shards on a comm of "
                             f"{self.comm.world} ranks")
        self.fill_mode, self.overlap = fill_mode, overlap
        self.P = n_shards
        self.G0loc = G0 // n_shards
        self.Grest = int(np.prod(ex.grid[1:]))
        self.NCloc = self.G0loc * self.Grest

    # --- the slab's lanes and plan ---
    def _lanes(self, ex, E):
        old, new = slab_perm(ex, E, self.P)
        self._g_old_of_new, self._g_new_of_old = old, new
        El, r = E // self.P, self.comm.rank
        local = np.full(E, -1, dtype=np.int64)
        local[old[r * El : (r + 1) * El]] = np.arange(El)
        self._shard_of_old = new // El
        return (self.NCloc, old[r * El : (r + 1) * El], local,
                lambda g: g.reshape(self.P, -1)[r])

    def _build_plan(self, ex, d, pay):
        halo = self.fill_mode != "off"
        plan = build_merged_plan(ex, d, pay=pay, n_par=d.n_par,
                                 G0loc=self.G0loc, halo=halo)
        if plan is None:
            raise ValueError("mesh does not satisfy the merged-operator "
                             "constraints (see build_merged_plan)")
        self._halo_g = halo_groups(ex, d.n_par) if halo else ((), ())
        self._split = split_lanes(plan) if self.overlap else None
        dev = d.geo.device
        # the fill as two flat index vectors into the trace array: what
        # this rank sends (its first plane of the rows crossing right,
        # then its last plane of those crossing left) and where the
        # received planes go (the right halo, then the left one)
        rl, rr = (np.concatenate(
            [np.arange(g * plan.rtq, (g + 1) * plan.rtq) for g in gs]
            or [np.zeros(0, np.int64)]) for gs in self._halo_g)
        h0, NC, G = plan.h0, plan.NC, self.Grest

        def flat(rows, lane):  # (rows, class, G lanes from lane)
            lanes = np.arange(plan.m)[:, None] * plan.NCt + lane + np.arange(
                G)[None, :]
            return (rows[:, None, None] * plan.Lt + lanes[None]).reshape(-1)

        self._halo_idx = tuple(torch.as_tensor(np.concatenate(x), device=dev)
                               for x in ((flat(rr, h0), flat(rl, h0 + NC - G)),
                                         (flat(rr, h0 + NC), flat(rl, 0))))
        self._n_first = len(rr) * plan.m * G
        # the elements of every rank's lanes, per parity, rank-major (the
        # gathers; the JAX runner's _pairs_old)
        El = len(self._g_old_of_new) // self.P
        idx = np.arange(len(self._g_old_of_new)).reshape(
            self.P, ex.m, El // ex.m)
        self._gpairs = [torch.as_tensor(
            self._g_old_of_new[idx[:, par :: d.n_par].reshape(-1)],
            device=dev) for par in range(d.n_par)]
        return plan

    # --- sources and receivers of the slab ---
    def _build_sources(self, src, n_groups=None):
        keep = (None if src is None else
                self._new_of_old[src.elems.cpu().numpy()] >= 0)
        super()._build_sources(
            None if src is None else _subset(src, keep),
            n_groups=_n_groups(src))

    def _build_receivers(self, receivers):
        self._rcv_ranks = None
        if receivers is None:
            return super()._build_receivers(None)
        shard = self._shard_of_old[receivers.elems.cpu().numpy()]
        self._rcv_ranks = [np.nonzero(shard == r)[0] for r in range(self.P)]
        super()._build_receivers(
            _subset(receivers, shard == self.comm.rank))

    # --- halo fill ---
    def _fill_start(self, tr):
        """Cut the planes this rank sends (one gather) and start their
        exchange; returns (the pending exchange, the buffer it receives
        into), (None, the planes themselves) where they come back to this
        rank (fill "local", or a ring of one rank), or None when there is
        nothing to fill."""
        if self.fill_mode in ("off", "skip"):
            return None
        planes = tr.reshape(-1).index_select(0, self._halo_idx[0])
        if self.fill_mode == "local" or self.comm.world == 1:
            return None, planes
        n = self._n_first
        got = torch.empty_like(planes)  # from the right, then the left
        return self.comm.ring_exchange_start(
            planes[:n], planes[n:], into=(got[n:], got[:n])), got

    def _fill_finish(self, pending, tr):
        """Write the received planes into the halo lanes of tr (one
        scatter, in place: no operator reads those lanes before the
        fill); returns tr."""
        if pending is None:
            return tr
        exchange, got = pending
        if exchange is not None:
            exchange.wait()
        tr.reshape(-1).index_copy_(0, self._halo_idx[1], got)
        return tr

    def _fill(self, tr):
        return self._fill_finish(self._fill_start(tr), tr)

    def _halo_op(self, op):
        """A merged operator op(plan, d, field, trs, mask, **kw) that
        fills the halo first — with the overlap split, as an interior
        launch on the unfilled traces, the exchange, and a boundary
        launch into the same outputs."""
        if self.plan.h0 == 0:
            return op

        def run(plan, d, field, trs, mask, **kw):
            if self._split is None:
                return op(plan, d, field, self._fill(trs), mask, **kw)
            lo, hi = self._split
            pending = self._fill_start(trs)
            out = op(plan, d, field, trs, mask, lanes=(lo, hi, 0), **kw)
            return op(plan, d, field, self._fill_finish(pending, trs), mask,
                      lanes=(lo, hi, 1), out=out, **kw)

        return run

    # --- global state ---
    def from_lm_state(self, ulm, slm):
        """The global State from every rank's slab (on every rank)."""
        d = self.d
        u, s = (torch.cat(self.comm.all_gather(x), dim=1)
                for x in (ulm, slm))
        return State(
            u=self._from_lm(u, d.dim, self._gpairs),
            s=self._from_lm(s, d.n_sig, self._gpairs))

    def run_lm(self, ulm, slm, n_steps: int, step0: int = 0, **kw):
        """n_steps on this rank's slab; returns (ulm, slm, the global
        seismograms (n_steps, R, dim) or None)."""
        ulm, slm, seis = super().run_lm(ulm, slm, n_steps, step0, **kw)
        if self._rcv_ranks is None:
            return ulm, slm, None
        return ulm, slm, gather_seismograms(self.comm, self._rcv_ranks, seis,
                                            n_steps, self.d.dim, ulm)

    def run(self, state0, n_steps: int, step0: int = 0):
        """n_steps from a global State; returns (the global State,
        seismograms numpy array or None) on every rank."""
        ulm, slm = self.to_lm_state(state0)
        ulm, slm, seis = self.run_lm(ulm, slm, n_steps, step0)
        return self.from_lm_state(ulm, slm), (
            None if seis is None else seis.cpu().numpy())

    def halo_bytes_per_step(self):
        """Bytes a rank sends its neighbours in a step (both planes of
        every fill; 0 when the fill is off or skipped)."""
        if self.fill_mode in ("off", "skip"):
            return 0
        return (self._fills_per_step * len(self._halo_idx[0])
                * torch.finfo(self.dtype).bits // 8)


class ShardedFusedRunner(SlabRunner, MergedLaneRunner):
    """Slab-sharded merged runner (LF4, structured meshes, n_shards | G0;
    rank ``comm.rank`` of ``n_shards``): MergedLaneRunner on a slab with a
    halo trace plan.  ``comm``: this rank's ``parallel.comm.Comm``
    (default: the process group's, or one rank).  ``overlap``: the
    interior/boundary split (see the module docstring).  ``packed``,
    ``stiffness``, ``impl``: as MergedLaneRunner's."""

    _fills_per_step = 6  # one before each operator of the LF4 step

    def __init__(self, p, ex: StructuredExchange, dt: float, n_shards: int,
                 order: int = 4, src: SourceData | None = None, damp=None,
                 receivers: ReceiverData | None = None, stiffness=None,
                 overlap: bool = False, fill_mode: str = "auto",
                 packed: bool | str = False, impl: str | None = None,
                 comm: _comm.Comm | None = None):
        if order != 4:
            raise ValueError("ShardedFusedRunner is LF4-only")
        self._slab_setup(ex, n_shards, comm, fill_mode, overlap, p.device)
        super().__init__(p, ex, dt, src=src, damp=damp, receivers=receivers,
                         impl=impl, stiffness=stiffness, packed=packed)

    def _compose_step(self):
        self._vel_op = self._halo_op(self._vel_op)
        self._stress_op = self._halo_op(self._stress_op)
        return super()._compose_step()
