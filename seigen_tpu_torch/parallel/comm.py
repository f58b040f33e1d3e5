"""Ranks and their traffic: the port's ``shard_map``, ``lax.ppermute``,
``all_gather`` and ``psum``.

The JAX package runs a sharded solver as one SPMD program over a device
mesh and moves halo planes with ``jax.lax.ppermute``.  Here a sharded run
is one process per rank (``spawn``), each holding its slab on its own
device, and the planes move by ``torch.distributed`` point-to-point
(``batch_isend_irecv``) over a ring:

- ``backend="nccl"``: one GPU a rank (``cuda:rank``), device tensors; the
  transfers run on NCCL's own streams, so the caller's stream keeps
  launching kernels until it waits on the receive (``Exchange.wait``).
  NCCL refuses two ranks on one GPU: ``spawn`` exits naming the card count.
- ``backend="gloo"``: host tensors (the CPU tests, ``device="cpu"``), or
  CUDA tensors staged through pinned host memory (several ranks on one
  card).  gloo's send of a CUDA tensor aborts the sending process (its TCP
  transport writes from the device pointer: "writev ... Bad address", on
  an H100 with torch 2.11 + CUDA 12.8), so a CUDA plane is copied to the
  host, sent, received and copied back.

The backend is always the caller's choice: nothing here switches from one
to the other.  A ``Comm`` with one rank never calls ``torch.distributed``:
its ring neighbours are itself, and an exchange is a local copy
(``torch.distributed`` refuses a send to self).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass
class Comm:
    """One rank of a ring of ``world`` ranks on ``device``.

    ``backend`` names the process group's backend (None: one rank, no
    group).  Host-side plans may build a Comm of any rank without a process
    group: only the exchange and gather methods talk to other ranks.
    """

    rank: int = 0
    world: int = 1
    backend: str | None = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    @property
    def left(self) -> int:
        return (self.rank - 1) % self.world

    @property
    def right(self) -> int:
        return (self.rank + 1) % self.world

    @property
    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, x):
        if not self._staged:
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return h.copy_(x)

    def ring_exchange_start(self, to_left, to_right,
                            into=None) -> "Exchange":
        """Send ``to_left`` (this rank's first plane) to the left
        neighbour and ``to_right`` (its last plane) to the right one, and
        post the receives of theirs; returns the pending exchange, whose
        ``wait()`` gives (from_left, from_right): the left neighbour's
        last plane and the right neighbour's first, in the contiguous
        buffers ``into`` when given.  The ring is cyclic, as the JAX
        package's ppermute is: rank 0's left plane comes from the last
        rank."""
        if self.world == 1:
            planes = (to_right, to_left)
            if into is None:
                return Exchange(self, tuple(x.clone() for x in planes), [])
            for buf, x in zip(into, planes):
                buf.copy_(x)
            return Exchange(self, into, [])
        sl, sr = (self._host(x.contiguous()) for x in (to_left, to_right))
        if into is None or self._staged:
            rl, rr = torch.empty_like(sr), torch.empty_like(sl)
        else:
            rl, rr = into
        # tags tell the two planes apart where left and right are one
        # peer (two ranks); NCCL matches them in posting order
        ops = [dist.P2POp(dist.isend, sl, self.left, tag=0),
               dist.P2POp(dist.isend, sr, self.right, tag=1),
               dist.P2POp(dist.irecv, rr, self.right, tag=0),
               dist.P2POp(dist.irecv, rl, self.left, tag=1)]
        return Exchange(self, (rl, rr), dist.batch_isend_irecv(ops),
                        keep=(sl, sr), into=into)

    def ring_exchange(self, to_left, to_right):
        """``ring_exchange_start(...).wait()``: (from_left, from_right)."""
        return self.ring_exchange_start(to_left, to_right).wait()

    def all_gather(self, x) -> list:
        """Every rank's ``x`` (the same shape on each), in rank order."""
        if self.world == 1:
            return [x]
        xs = self._host(x.contiguous())
        out = [torch.empty_like(xs) for _ in range(self.world)]
        dist.all_gather(out, xs)
        return [o.to(x.device) for o in out]

    def all_reduce_sum(self, x):
        """The sum of every rank's ``x`` (the same shape on each), on
        every rank: JAX's ``psum``.  ``x`` itself is left as it is."""
        if self.world == 1:
            return x
        y = self._host(x.contiguous()) if self._staged else x.clone()
        dist.all_reduce(y)
        return y.to(x.device)

    def permute(self, x, pairs):
        """One round of JAX's ``lax.ppermute`` over ``(src, dst)`` pairs:
        this rank sends ``x`` to every dst it is the src of and returns
        what its src sent it, or zeros where no pair ends here.  Every
        rank calls it with the same pairs; each rank is the src and the
        dst of at most one pair (a matching, as ``partition.make_plan``'s
        edge colouring gives)."""
        dst = [d for s, d in pairs if s == self.rank]
        src = [s for s, d in pairs if d == self.rank]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"rank {self.rank} appears twice in {pairs}")
        if self.world == 1 or not (dst or src):
            return x.clone() if src else torch.zeros_like(x)
        xs = self._host(x.contiguous())
        got = torch.zeros_like(xs)
        ops = ([dist.P2POp(dist.isend, xs, dst[0])] if dst else []) + (
            [dist.P2POp(dist.irecv, got, src[0])] if src else [])
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return got.to(x.device)


@dataclass
class Exchange:
    """A pending ring exchange (see ``Comm.ring_exchange_start``)."""

    comm: Comm
    planes: tuple
    works: list
    keep: tuple = ()  # the send buffers, alive until the transfers end
    into: tuple | None = None

    def wait(self):
        """(from_left, from_right) on the comm's device.  With NCCL the
        calling stream waits for the transfers and the host does not."""
        for w in self.works:
            w.wait()
        if not self.comm._staged:
            return self.planes
        if self.into is None:
            return tuple(p.to(self.comm.device, non_blocking=True)
                         for p in self.planes)
        for buf, p in zip(self.into, self.planes):
            buf.copy_(p, non_blocking=True)
        return self.into


def rank_device(device: str | torch.device, rank: int) -> torch.device:
    """The device of a rank: its own card (rank modulo the cards), or the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init(rank: int, world: int, backend: str, init_method: str,
         device: str | torch.device = "cuda") -> Comm:
    """Join the process group (explicit backend and rendezvous, e.g.
    ``file:///tmp/x`` or ``tcp://localhost:29500``) and return this
    rank's Comm; CUDA ranks make their card the current device."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world > 1:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
        if backend == "nccl":
            # NCCL wants every rank in a group's first collective; a
            # ``permute`` round may leave a rank out
            dist.barrier(device_ids=[dev.index])
    return Comm(rank=rank, world=world,
                backend=backend if world > 1 else None, device=dev)


def current(device: str | torch.device = "cuda") -> Comm:
    """The Comm of this process: its rank in the default process group,
    or one rank when there is none."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        return Comm(rank=rank, world=world, backend=dist.get_backend(),
                    device=rank_device(device, rank))
    return Comm(device=torch.device(device))


def _entry(rank, fn, world, backend, init_method, device, args):
    torch.set_num_threads(1)
    comm = init(rank, world, backend, init_method, device)
    try:
        fn(comm, *args)
    finally:
        if world > 1:
            dist.destroy_process_group()


def spawn(fn, world: int, device: str = "cuda", backend: str | None = None,
          args: tuple = (), meanwhile=None):
    """Run ``fn(comm, *args)`` on ``world`` new processes, one a rank
    (``torch.multiprocessing.spawn``: a CUDA context needs a fresh
    process), joined by a ``file://`` rendezvous in a temporary directory
    (fixed TCP ports collide between concurrent runs).  ``backend``:
    "nccl" (the default on CUDA) or "gloo" (the default on the CPU).  Each
    child runs one intra-op thread.  ``meanwhile()``, if given, runs in
    this process while the ranks work; its result is returned.  Raises if
    a rank fails."""
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if backend == "nccl":
        n = torch.cuda.device_count()
        if world > n:
            raise SystemExit(
                f"{world} NCCL ranks need {world} CUDA devices, this machine "
                f"has {n}; name backend='gloo' to share a card")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = torch.multiprocessing.spawn(
            _entry, args=(fn, world, backend, init_method, device, args),
            nprocs=world, join=False)
        try:
            return meanwhile() if meanwhile is not None else None
        finally:
            while not ctx.join():
                pass
