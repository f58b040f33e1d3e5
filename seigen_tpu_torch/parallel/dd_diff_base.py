"""Domain-decomposed FWI gradients: ``LaneDiffFwi`` over a sharded runner.

Port of ``seigen_tpu/parallel/dd_diff_base.py:DomainDecomposedFwi``.  The
energy-conjugation identities of solver/lane_diff.py hold for the GLOBAL
material-free operators, and a sharded runner's operators compute exactly
those (partition invariance is tested); the mass weights are per element,
so they apply on each rank's lanes.  The backward of each sharded operator
is therefore one application of the other sharded operator, its exchange
included: no collective needs a hand-written transpose.

Three engines differ only in their runner (the ``_sharded_runner`` hook):
parallel/lane_diff_sharded.py (K4 SIG / K5 TR over ``ShardedLaneRunner``),
parallel/merged_diff_sharded.py (K1/K2 or K1pk/K2pk over
``ShardedFusedRunner``) and parallel/unstructured_diff_sharded.py (K4 TRAC
SEL / K5 SEL over ``ShardedUnstructuredRunner``).  Everything else is
``LaneDiffFwi``'s, on this rank's elements, with three sums over the
ranks:

- every rank samples every receiver, with zero weights where it does not
  hold the receiver's element, and the partial seismograms of a shot are
  summed over the ranks (``_SumRanks``: its backward passes the cotangent
  on unchanged, since every rank computes the same misfit of the sum);
- each rank's material gradient covers its own elements, and one
  ``all_reduce_sum`` per ``vg`` call adds them up;
- the illumination likewise.

Every rank must run the same calls in the same order: the exchanges run
inside the operators, forward and backward.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver.lane_diff import LaneDiffFwi
from ..solver.lane_merged import MergedLaneRunner
from ..solver.receivers import ReceiverData
from . import comm as _comm


class _SumRanks(torch.autograd.Function):
    """The sum of every rank's partial seismograms; the backward is the
    identity (each rank's misfit is the same function of the sum)."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce_sum(x) if comm.world > 1 else x.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class DomainDecomposedFwi(LaneDiffFwi):
    """FWI value-and-gradient with each shot's domain decomposed over the
    ranks of ``comm`` (default: the process group's; ``n_shards`` of
    them).  Subclasses build the sharded runner (``_sharded_runner``);
    the other arguments are LaneDiffFwi's.  Shots run one after the other;
    every rank gets the same misfit and gradient."""

    def __init__(self, p0, dm, ex, dt, n_steps, shots, receivers, observed,
                 n_shards: int, *, engine: str,
                 comm: _comm.Comm | None = None, **kw):
        self.comm = comm if comm is not None else _comm.current(p0.device)
        if self.comm.world != n_shards:
            raise ValueError(f"{n_shards} shards on a comm of "
                             f"{self.comm.world} ranks")
        self.n_shards = n_shards
        super().__init__(p0, dm, ex, dt, n_steps, shots, receivers,
                         observed, engine=engine, **kw)

    def _sharded_runner(self, pf, dm, ex, dt, order, damp, impl, packed):
        raise NotImplementedError

    def _make_runner(self, engine, pf, dm, ex, dt, order, damp, receivers,
                     impl, packed):
        r = self._sharded_runner(pf, dm, ex, dt, order, damp, impl, packed)
        # every receiver on every rank, zero-weighted off the rank's
        # elements: each rank's misfit then depends on its own lanes, so
        # every rank runs the same backward (and its exchanges)
        elems = receivers.elems.cpu().numpy()
        own = r._new_of_old[elems] >= 0
        loc = np.where(own, elems, r._old_of_new[0])
        w = receivers.weights * torch.as_tensor(
            own, device=receivers.weights.device)[:, None]
        if isinstance(r, MergedLaneRunner):
            MergedLaneRunner._build_receivers(r, ReceiverData(
                elems=torch.as_tensor(loc), weights=w))
        else:
            r.rcv = ReceiverData(
                elems=torch.as_tensor(r._new_of_old[loc], device=r.device),
                weights=w.to(device=r.device, dtype=r.dtype))
        return r

    def _seis_one(self, theta, src_k, segment=None):
        # one sum over the ranks for the whole shot: the same numbers as
        # JAX's psum of every step's partial samples
        return _SumRanks.apply(super()._seis_one(theta, src_k, segment),
                               self.comm)

    def _sum_ranks(self, x):
        return self.comm.all_reduce_sum(x)

    def vg_factory(self, taps):
        """As LaneDiffFwi's; the misfit is already the same on every rank,
        the gradient is summed over the ranks' elements."""
        vg1 = super().vg_factory(taps)

        def vg(theta):
            v, g = vg1(theta)
            return v, {k: self.comm.all_reduce_sum(x) for k, x in g.items()}

        return vg

    def vg_factory_sharded(self, comm=None):
        raise NotImplementedError("shot data parallelism and domain "
                                  "decomposition are exclusive")

    def source_vg_factory(self, *args, **kw):
        raise NotImplementedError("source gradients run on one device "
                                  "(LaneDiffFwi)")

    def moment_vg_factory(self, *args, **kw):
        raise NotImplementedError("moment gradients run on one device "
                                  "(LaneDiffFwi)")
