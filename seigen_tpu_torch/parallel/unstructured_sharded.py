"""Morton-block sharded lane runner for unstructured meshes, on K4 TRAC SEL
/ K5 SEL.

Port of ``seigen_tpu/parallel/unstructured_sharded.py:
ShardedUnstructuredRunner``.  The elements are ordered along a Morton curve
of their centroids and cut into contiguous blocks of E_loc = ceil(E/P);
rank r steps its block with ``UnstructuredLaneRunner``'s in-kernel select
operators, unchanged.  The only traffic between ranks is one
``Comm.all_gather`` per operator of a compact panel: each rank extracts
its own face traces (row index, and on the stress side the traction
contraction with its own normals: dim rows, not n_sig), takes the columns
any other rank reads (``gather_cols``: the block's boundary producers) and
gathers every rank's.  Each consumer face then takes its producer lanes
from [local traces | the P gathered panels] (``take``, precomputed on the
host), and the kernels run the (f2, pi) select as on one device.

Unlike the JAX runner there is no padding: the last block holds the
remaining E - (P-1)*E_loc elements (it must hold at least one), and the
panel keeps the one-device panel rows (``rows_pad``), the layout the SEL
kernels read.  ``stiffness`` (the general Hooke law in K5 SEL) follows the
lanes, as on one device.  Sources and receivers live on the rank of their
element; ``run`` returns the global State and the seismograms in the
caller's receiver order on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.elastic import ElasticParams, voigt_map
from ..ops.lane_kernels import from_lm
from ..ops.unstructured_exchange import _boundary_sign, _contract, \
    _own_rows, derive_face_pairing, orientation_groups, permute_pairing
from ..ops.fused_kernels import _rup
from ..solver.lane_unstructured import UnstructuredLaneRunner
from ..solver.receivers import ReceiverData
from ..solver.source import SourceData
from ..solver.timestep import State
from . import comm as _comm
from .fused_sharded import _subset, gather_seismograms
from .partition import morton_order


class ShardedUnstructuredRunner(UnstructuredLaneRunner):
    """Morton-block sharded LF2/LF4 lane runner for arbitrary conforming
    meshes (rank ``comm.rank`` of ``n_shards``).  Arguments as
    UnstructuredLaneRunner's (the select is always fused), with
    ``n_shards`` and ``comm`` (default: the process group's, or one
    rank)."""

    fill_mode = "all_gather"  # the bench's label of the exchange

    def __init__(self, p: ElasticParams, dt: float, n_shards: int, *,
                 centroids=None, order: int = 4,
                 src: SourceData | None = None, damp=None,
                 receivers: ReceiverData | None = None,
                 impl: str | None = None, stiffness=None,
                 comm: _comm.Comm | None = None):
        self.comm = comm if comm is not None else _comm.current(p.device)
        if self.comm.world != n_shards:
            raise ValueError(f"{n_shards} shards on a comm of "
                             f"{self.comm.world} ranks")
        E = p.Ginv.shape[0]
        self.P, r = n_shards, self.comm.rank
        self.E_loc = -(-E // n_shards)
        self._lo = r * self.E_loc
        self._hi = min(E, self._lo + self.E_loc)
        if self._hi <= self._lo:
            raise ValueError(f"{n_shards} blocks of {self.E_loc} elements "
                             f"leave rank {r} of a {E}-element mesh empty")
        if centroids is None:
            old_of_new = np.arange(E, dtype=np.int64)
        else:
            old_of_new = np.asarray(morton_order(np.asarray(centroids)),
                                    dtype=np.int64)
        new_of_old = np.empty(E, dtype=np.int64)
        new_of_old[old_of_new] = np.arange(E)
        self._g_old_of_new, self._g_new_of_old = old_of_new, new_of_old
        shard = new_of_old // self.E_loc
        self._rcv_ranks = None
        if receivers is not None:
            rs = shard[receivers.elems.cpu().numpy()]
            self._rcv_ranks = [np.nonzero(rs == q)[0]
                               for q in range(n_shards)]
            receivers = _subset(receivers, rs == r)
        if src is not None:
            src = _subset(src, shard[src.elems.cpu().numpy()] == r)
        super().__init__(p, dt, centroids=centroids, fused_select=True,
                         order=order, src=src, damp=damp,
                         receivers=receivers, impl=impl,
                         stiffness=stiffness)

    # --- the block's lanes and its panel exchange ---
    def _element_perm(self):
        mine = self._g_old_of_new[self._lo : self._hi]
        local = np.full(self.E, -1, dtype=np.int64)
        local[mine] = np.arange(len(mine))
        return mine, local

    def _make_exchanges(self):
        """The host plan (the select codes of the whole mesh, the
        published columns and the remapped takes) and the panel functions
        of both operators; returns (None, None): the panels replace the
        assembled traces."""
        p, d = self.p, self.d
        dev = d.ginv.device
        E, E_loc, Pn = len(self._g_old_of_new), self.E_loc, self.P
        lo, hi = self._lo, self._hi
        pr = derive_face_pairing(p.nbr.cpu().numpy(), p.n_p, p.fnodes)
        pr = permute_pairing(pr, self._g_old_of_new, self._g_new_of_old)
        nf, nfp = pr.n_faces, pr.n_fp
        ftp = nf * nfp
        rows_pad = _rup(d.dim * ftp, 8)

        # the select plan of the whole mesh (every rank the same selcfg)
        gid, perms_np = orientation_groups(pr)
        comb = pr.f2 * perms_np.shape[0] + gid  # (E, nf)
        face_combos = tuple(tuple(int(x) for x in np.unique(comb[:, f]))
                            for f in range(nf))
        perms = tuple(tuple(int(x) for x in row) for row in perms_np)
        selcfg = (d.dim, nf, nfp, ftp, d.ftpp, rows_pad, face_combos, perms)
        combo = np.zeros((8, hi - lo), dtype=np.int32)
        combo[:nf] = comb[lo:hi].T
        sign = np.zeros((8, hi - lo))
        sign[:nf] = _boundary_sign(pr)[lo:hi].T

        # published boundary columns of every producer block; the takes of
        # this block into [local traces | P panels of nb columns]
        e2 = pr.e2
        osh = e2 // E_loc
        cross = osh != (np.arange(E) // E_loc)[:, None]
        pubs = [np.unique(e2[cross & (osh == o)]) for o in range(Pn)]
        self.nb = nb = max((len(x) for x in pubs), default=0)
        gather_cols = np.zeros((Pn, nb), dtype=np.int64)
        pos = np.zeros_like(e2)
        for o in range(Pn):
            gather_cols[o, : len(pubs[o])] = pubs[o] - o * E_loc
            m = cross & (osh == o)
            if m.any():
                pos[m] = np.searchsorted(pubs[o], e2[m])
        E_r = hi - lo
        take = np.where(cross, E_r + osh * nb + pos, e2 - osh * E_loc)[lo:hi]
        self._gather_cols = gather_cols
        self._take = torch.as_tensor(take.T.copy(), device=dev)  # (nf, E_r)
        gcols = torch.as_tensor(gather_cols[self.comm.rank], device=dev)
        self._combo = torch.as_tensor(combo, device=dev)
        self._sign = torch.as_tensor(sign, device=dev).to(d.ginv.dtype)
        self._rows_pad = rows_pad
        fn_idx = torch.as_tensor(np.asarray(p.fnodes).reshape(-1),
                                 device=dev)
        V = voigt_map(d.dim)

        def panels(T):
            """(rows_pad, E_r) own-face rows -> (nf*rows_pad, E_r) panels:
            the boundary columns all-gathered, then the nf takes."""
            if nb:
                got = self.comm.all_gather(T.index_select(1, gcols))
                T = torch.cat([T] + got, dim=1)
            out = torch.empty((nf, rows_pad, E_r), dtype=T.dtype,
                              device=T.device)
            for f in range(nf):
                torch.index_select(T, 1, self._take[f], out=out[f])
            return out.reshape(nf * rows_pad, E_r)

        def pad(T):
            T = T.reshape(d.dim * ftp, -1)
            if rows_pad != d.dim * ftp:
                T = torch.nn.functional.pad(
                    T, (0, 0, 0, rows_pad - d.dim * ftp))
            return T

        def panels_u(u_lm):
            return panels(pad(_own_rows(u_lm, fn_idx, d.dim, d.npp)))

        def panels_t(s_lm):
            T = _contract(_own_rows(s_lm, fn_idx, d.n_sig, d.npp), d.nrm,
                          V, d.dim, d.ftpp, ftp)
            return panels(pad(T))

        self._pg_u = (panels_u, self._combo, None, selcfg)
        self._pg_t = (panels_t, self._combo, self._sign, selcfg)
        return None, None

    def halo_bytes_per_step(self):
        """Bytes of the panel a rank publishes in a step: rows_pad rows of
        nb columns before each operator (LF2: 1 + 1, LF4: 3 + 3)."""
        k = 2 if self.order == 2 else 6
        return (k * self._rows_pad * self.nb
                * torch.finfo(self.dtype).bits // 8)

    # --- global results ---
    def _gather_lanes(self, x):
        """Every rank's (rows, E_r) lanes -> (rows, E) in the global
        Morton order (the last block may be shorter)."""
        pad = x.new_zeros((x.shape[0], self.E_loc))
        pad[:, : x.shape[1]] = x
        return torch.cat(self.comm.all_gather(pad), dim=1)[
            :, : len(self._g_old_of_new)]

    def from_lm_state(self, ulm, slm) -> State:
        """The global State from every rank's block (on every rank)."""
        d = self.d
        inv = torch.as_tensor(self._g_new_of_old, device=ulm.device)
        u, s = (self._gather_lanes(x) for x in (ulm, slm))
        return State(u=from_lm(u, d.n_p, d.npp, d.dim)[inv],
                     s=from_lm(s, d.n_p, d.npp, d.n_sig)[inv])

    def run_lm(self, ulm, slm, n_steps: int, step0: int = 0):
        """n_steps on this rank's block; returns (ulm, slm, the global
        seismograms (n_steps, R, C) or None)."""
        ulm, slm, seis = super().run_lm(ulm, slm, n_steps, step0)
        if self._rcv_ranks is None:
            return ulm, slm, None
        return ulm, slm, gather_seismograms(
            self.comm, self._rcv_ranks, seis, n_steps, self.d.dim, ulm)
