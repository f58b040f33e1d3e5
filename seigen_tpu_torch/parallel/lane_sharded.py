"""Slab-sharded lane-major LF2/LF4 runner on K4 SIG / K5 TR.

Port of ``seigen_tpu/parallel/lane_sharded.py:ShardedLaneRunner``.  The
supercell grid is cut into ``n_shards`` slabs along its outer axis
(``n_shards | G0``); rank r holds slab r — every class, G0/P planes of
supercells, class-major lanes — and steps it with ``LaneMajorRunner``'s
operators, unchanged.  Before every operator the input field's first and
last supercell planes go to the ring neighbours (``Comm.ring_exchange``,
the JAX runner's ``ppermute`` pair), and the trace exchange gathers from
the extended slab [left halo | slab | right halo] of every class: links
along axis 0 read the halo planes, the axis-1/2 shifts stay inside the
slab and wrap as the one-device exchange does.  The ring is cyclic, so
periodic meshes wrap; on a bounded mesh the off-mesh faces are masked to
the own traces and the received plane is never read.

Sources and receivers live on the rank whose slab holds their element;
``run`` returns the global State and the seismograms in the caller's
receiver order on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.structured_exchange import StructuredExchange
from ..ops.unstructured_exchange import _gather_plan, _gather_traces
from ..solver.lane_major import LaneMajorRunner
from ..solver.receivers import ReceiverData
from ..solver.source import SourceData
from ..solver.timestep import State
from . import comm as _comm
from .fused_sharded import _subset, gather_seismograms, slab_perm


class ShardedLaneRunner(LaneMajorRunner):
    """Slab-sharded lane-major runner (rank ``comm.rank`` of
    ``n_shards``; structured meshes, n_shards | G0).  Arguments as
    LaneMajorRunner's, with ``n_shards`` and ``comm`` (default: the process
    group's, or one rank)."""

    def __init__(self, p, ex: StructuredExchange, dt: float, n_shards: int,
                 order: int = 4, src: SourceData | None = None, damp=None,
                 receivers: ReceiverData | None = None,
                 impl: str | None = None, stiffness=None,
                 comm: _comm.Comm | None = None):
        G0 = ex.grid[0]
        if G0 % n_shards:
            raise ValueError(
                f"slab sharding needs n_shards | G0 ({n_shards} vs {G0})")
        self.comm = comm if comm is not None else _comm.current(p.device)
        if self.comm.world != n_shards:
            raise ValueError(f"{n_shards} shards on a comm of "
                             f"{self.comm.world} ranks")
        self.P, self.G0loc = n_shards, G0 // n_shards
        self.Grest = int(np.prod(ex.grid[1:]))
        E = p.Ginv.shape[0]
        self._g_old_of_new, self._g_new_of_old = slab_perm(ex, E, n_shards)
        El, r = E // n_shards, self.comm.rank
        shard = self._g_new_of_old // El
        self._rcv_ranks = None
        if receivers is not None:
            rs = shard[receivers.elems.cpu().numpy()]
            self._rcv_ranks = [np.nonzero(rs == q)[0]
                               for q in range(n_shards)]
            receivers = _subset(receivers, rs == r)
        if src is not None:
            src = _subset(src, shard[src.elems.cpu().numpy()] == r)
        super().__init__(p, ex, dt, order=order, src=src, damp=damp,
                         receivers=receivers, impl=impl, stiffness=stiffness)

    # --- the slab's lanes and its halo exchange ---
    def _element_perm(self):
        El, r = self.E // self.P, self.comm.rank
        mine = self._g_old_of_new[r * El : (r + 1) * El]
        local = np.full(self.E, -1, dtype=np.int64)
        local[mine] = np.arange(El)
        return mine, local

    def _make_exchanges(self):
        """(ex_u, ex_s): halo exchange + one gather from the extended
        slab, (C*npp, E_loc) field -> (C*ftpp, E_loc) neighbour traces."""
        ex, d = self.ex, self.d
        G0l, Gr, m = self.G0loc, self.Grest, ex.m
        rest = tuple(ex.grid[1:])
        nf, nfp = ex.n_faces, ex.n_fp
        ftp, El = nf * nfp, d.E
        Ee = m * (G0l + 2) * Gr  # extended lanes
        g0 = np.arange(G0l)[:, None]
        rc = np.stack(np.unravel_index(np.arange(Gr), rest))  # (dimr, Gr)
        rows = np.zeros((nf, nfp, m, G0l, Gr), dtype=np.int64)
        lanes = np.zeros((nf, nfp, m, G0l, Gr), dtype=np.int64)
        for t in range(m):
            for f in range(nf):
                sh = ex.shift[t, f]
                rn = np.ravel_multi_index(
                    tuple((rc[a] + sh[1 + a]) % g for a, g in
                          enumerate(rest)), rest)  # (Gr,)
                nb = ((int(ex.nbr_class[t, f]) * (G0l + 2) + g0 + sh[0]
                       + 1) * Gr + rn[None, :])
                own_l = (t * (G0l + 2) + g0 + 1) * Gr + np.arange(Gr)
                own = ex.self_mask[t, f].reshape(self.P, G0l, Gr)[
                    self.comm.rank]
                lanes[f, :, t] = np.where(own, own_l, nb)[None]
                rows[f, :, t] = np.where(
                    own[None], ex.own_nodes[f][:, None, None],
                    ex.nodes[t, f][:, None, None])
        idx = _gather_plan(rows.reshape(ftp, El), lanes.reshape(ftp, El), Ee,
                           d.ginv.device)

        def make(C):
            def exchange(f_lm):
                v = f_lm.reshape(C * d.npp, m, G0l, Gr)
                left, right = self.comm.ring_exchange(v[:, :, 0],
                                                      v[:, :, -1])
                ext = torch.cat([left[:, :, None], v, right[:, :, None]],
                                dim=2)
                return _gather_traces(ext.reshape(C * d.npp, Ee), idx, C,
                                      ftp, d.ftpp, El)
            return exchange

        return make(d.dim), make(d.n_sig)

    def halo_bytes_per_step(self):
        """Bytes a rank sends its neighbours in a step: two state planes
        of the input field before each operator (LF2: 1 + 1, LF4: 3 + 3)."""
        d = self.d
        k = 1 if self.order == 2 else 3
        rows = k * (d.dim + d.n_sig) * d.npp
        return (2 * rows * self.ex.m * self.Grest
                * torch.finfo(self.dtype).bits // 8)

    # --- global results ---
    def from_lm_state(self, ulm, slm) -> State:
        """The global State from every rank's slab (on every rank)."""
        d = self.d
        inv = torch.as_tensor(self._g_new_of_old, device=ulm.device)
        u, s = (torch.cat(self.comm.all_gather(x), dim=1)
                for x in (ulm, slm))
        from ..ops.lane_kernels import from_lm
        return State(u=from_lm(u, d.n_p, d.npp, d.dim)[inv],
                     s=from_lm(s, d.n_p, d.npp, d.n_sig)[inv])

    def run_lm(self, ulm, slm, n_steps: int, step0: int = 0):
        """n_steps on this rank's slab; returns (ulm, slm, the global
        seismograms (n_steps, R, C) or None)."""
        ulm, slm, seis = super().run_lm(ulm, slm, n_steps, step0)
        if self._rcv_ranks is None:
            return ulm, slm, None
        return ulm, slm, gather_seismograms(
            self.comm, self._rcv_ranks, seis, n_steps,
            self.d.dim + int(self.record_pressure), ulm)
