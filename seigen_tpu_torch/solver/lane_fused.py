"""Exchange-fused lane-major LF4 solver — the v2 engine (structured meshes).

Port of ``seigen_tpu/solver/lane_fused.py``.  Every operator emits the face
traces of its output in its own face-node order (ops/fused_ops.py: K8
``fused_vel2``, K9 ``fused_stress2``), and the trace exchange is a pure
permutation of those compact (dim*ftpp, E) arrays into CONSUMER order: a
consumer face re-reads them at (producer face f2, node permutation pi) from
the neighbour class, at the supercell shifted by ``shift`` per axis
(wrapping), sign-flipped for tractions (conforming faces have opposite
normals), its own rows on boundary faces.  ``derive_pairing`` and
``_canonical_shift`` are NumPy, copied.

The exchange runs as K10 ``trace_exchange`` (csrc/trace_exchange.cu, one
launch per exchange, bounded and periodic meshes alike) or as its plain
version, one precomputed-index gather, a sign and a select.  The runner
(``FusedLaneRunner``) keeps the state in the class-major lane layout of the
merged runner it builds on, carries the traction traces of sigma across
steps, and composes its LF4 step through
``timestep.compose_lf_step_traced``: six operator launches and six
exchanges a step, sources scattered into fields and traces, u damped after
its traces fed the sh1 stage.  ``impl="kernel"`` runs K8/K9 (CUDA tensors
only) and K10, ``impl="reference"`` the plain versions of all three.
``run_lm`` is a Python loop over steps.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.cuda_build import CudaLibrary
from ..ops.elastic import ElasticParams
from ..ops.fused_kernels import FusedOpData
from ..ops.fused_ops import emit_components, stress2_op, stress2_op_ref, \
    vel2_op, vel2_op_ref
from ..ops.merged_kernels import check_operands
from ..ops.structured_exchange import StructuredExchange
from .lane_major import resolve_impl
from .lane_merged import MergedLaneRunner
from .receivers import ReceiverData
from .source import SourceData
from .timestep import compose_lf_step_traced


def derive_pairing(ex: StructuredExchange):
    """Producer-side face index f2 and node permutation pi per (t, f).

    ex.nodes[t, f] holds the neighbour's local node ids in CONSUMER order;
    the producer emits its own-face traces in fnodes order, so the exchange
    re-reads rows (f2, pi).  f2 is the unique neighbour face whose node set
    matches; pi[j] locates nodes[t, f][j] within fnodes[f2].
    """
    nf, nfp = ex.n_faces, ex.n_fp
    fsets = [frozenset(ex.own_nodes[f].tolist()) for f in range(nf)]
    f2 = np.zeros((ex.m, nf), dtype=np.int64)
    pi = np.zeros((ex.m, nf, nfp), dtype=np.int64)
    for t in range(ex.m):
        for f in range(nf):
            s = frozenset(ex.nodes[t, f].tolist())
            matches = [g for g in range(nf) if fsets[g] == s]
            assert len(matches) == 1, (t, f, s)
            g = matches[0]
            f2[t, f] = g
            pos = {int(n): j for j, n in enumerate(ex.own_nodes[g])}
            for j in range(nfp):
                pi[t, f, j] = pos[int(ex.nodes[t, f, j])]
    return f2, pi


def _flat_strides(grid):
    strides = []
    s = 1
    for g in reversed(grid):
        strides.append(s)
        s *= g
    return tuple(reversed(strides))


def _canonical_shift(ex: StructuredExchange, t: int, f: int):
    """True (unwrapped) per-axis neighbour offset for face (t, f), or None.

    ``ex.shift`` is only defined MODULO the grid — -1 and +1 coincide on
    a period-2 axis.  The lane-major operators read the neighbour at a
    flat lane shift WITHOUT the per-axis mod, so they need the true
    offset: the one whose out-of-range consumer set exactly equals the
    boundary mask (self_mask).  Returns the offset tuple, or None when no
    unique candidate matches.
    """
    import itertools

    grid = ex.grid
    dim = len(grid)
    base = [int(ex.shift[t, f, a]) for a in range(dim)]
    mask = np.asarray(ex.self_mask[t, f]).reshape(grid)
    options = []
    for s, g in zip(base, grid):
        if s == 0:
            options.append([0])
        else:
            alt = s - g * (1 if s > 0 else -1)
            options.append(sorted({s, alt}, key=abs))
    idx = np.indices(grid)
    matches = []
    for choice in itertools.product(*options):
        out = np.zeros(grid, dtype=bool)
        for a in range(dim):
            c = idx[a] + choice[a]
            out |= (c < 0) | (c >= grid[a])
        if np.array_equal(out, mask):
            matches.append(choice)
    return matches[0] if len(matches) == 1 else None


# ---------------------------------------------------------------------------
# the trace exchange


@dataclass(frozen=True)
class ExchangePlan:
    """Static tables of the v2 trace exchange of C-component traces (device
    tensors): ``table`` (m, nf, 5 + n_fp) int32 rows [t2, f2, shift per
    axis (3, the first one 0 in 2D), pi...] and ``mask`` (nf, E) float32
    (row f != 0: face f of that lane takes its own rows).  K10 reads them;
    the plain version reads ``gather``, the same permutation as flat
    indices, worked out from them at its first use."""

    C: int
    nf: int
    n_fp: int
    ftpp: int
    NC: int
    grid: tuple  # supercell grid, three axes (2D: a leading 1)
    table: torch.Tensor
    mask: torch.Tensor

    @property
    def E(self):
        return self.mask.shape[1]

    @functools.cached_property
    def gather(self):
        """(index, own): ``index`` (C, ftp, E) int64, the flat index into
        the (C*ftpp, E) trace array of every consumer row (own rows on
        boundary faces); ``own`` (ftp, E) bool, the rows a lane takes from
        itself.  Lane L = t*NC + j reads class t2 at the supercell
        (cell(j) + shift) mod grid per axis, rows f2*n_fp + pi."""
        m, nf, nfp, NC, E = self.table.shape[0], self.nf, self.n_fp, \
            self.NC, self.E
        dev = self.mask.device
        tab = self.table.to(torch.int64)
        g = torch.tensor(self.grid, device=dev)
        j = torch.arange(NC, device=dev)
        cell = torch.stack((j // (g[1] * g[2]), j // g[2] % g[1], j % g[2]))
        nb = (cell[:, None, None] + tab[..., 2:5].permute(2, 0, 1)[..., None]
              ) % g[:, None, None, None]  # (3, m, nf, NC)
        lane_nb = tab[..., :1] * NC + (nb[0] * g[1] + nb[1]) * g[2] + nb[2]
        row_nb = tab[..., 1:2] * nfp + tab[..., 5:]  # (m, nf, nfp)
        own = (self.mask != 0)[:, None]  # (nf, 1, E)
        lanes = torch.where(own, torch.arange(E, device=dev),
                            lane_nb.permute(1, 0, 2).reshape(nf, 1, E))
        rows = torch.where(
            own, torch.arange(nf * nfp, device=dev).reshape(nf, nfp, 1),
            row_nb.permute(1, 2, 0)[..., None].expand(nf, nfp, m, NC)
            .reshape(nf, nfp, E))
        index = ((torch.arange(self.C, device=dev)[:, None, None] * self.ftpp
                  + rows.reshape(1, nf * nfp, E)) * E
                 + lanes.expand(nf, nfp, E).reshape(1, nf * nfp, E))
        return index, own.expand(nf, nfp, E).reshape(nf * nfp, E)


def build_exchange_plan(ex: StructuredExchange,
                        d: FusedOpData) -> ExchangePlan:
    """The exchange tables of ``ex`` for d.dim-component traces of lanes in
    class-major order (lane t*NC + j: class t, supercell j in row-major
    grid order)."""
    grid = tuple(int(g) for g in ex.grid)
    dim = len(grid)
    m, nf = ex.m, ex.n_faces
    NC = int(np.prod(grid))
    f2, pi = derive_pairing(ex)
    shift = np.zeros((m, nf, 3), dtype=np.int64)
    shift[:, :, 3 - dim:] = ex.shift
    table = np.concatenate(
        [np.asarray(ex.nbr_class, dtype=np.int64)[..., None], f2[..., None],
         shift, pi], axis=2)
    own = np.stack([np.concatenate([np.asarray(ex.self_mask[t, f]).reshape(-1)
                                    for t in range(m)]) for f in range(nf)])
    dev = d.geo.device
    return ExchangePlan(
        C=d.dim, nf=nf, n_fp=ex.n_fp, ftpp=d.ftpp, NC=NC,
        grid=(1,) * (3 - dim) + grid,
        table=torch.as_tensor(table, device=dev).to(torch.int32).contiguous(),
        mask=torch.as_tensor(own, device=dev).to(torch.float32))


def trace_exchange_ref(xp: ExchangePlan, tr, negate: bool):
    """Plain version of K10: (C*ftpp, E) producer-emitted traces ->
    consumer-ordered traces, pad rows 0."""
    index, own = xp.gather
    g = tr.reshape(-1)[index]  # (C, ftp, E)
    if negate:
        g = torch.where(own, g, -g)
    out = tr.new_zeros((xp.C, xp.ftpp, xp.E))
    out[:, : g.shape[1]] = g
    return out.reshape(xp.C * xp.ftpp, xp.E)


EXCHANGE_LIBRARY = CudaLibrary("seigen_exchange", ("trace_exchange.cu",))

_P = ctypes.c_void_p


class ExchangeArgs(ctypes.Structure):
    """Mirror of ``struct ExchangeArgs`` in csrc/trace_exchange.cu."""

    _fields_ = [(n, _P) for n in ("tr", "table", "mask", "out")] + [
        ("E", ctypes.c_longlong)] + [(n, ctypes.c_int) for n in (
            "NC", "g0", "g1", "g2", "C", "nf", "nfp", "ftpp")] + [
        ("sign", ctypes.c_float)]


class TraceExchangeKernel:
    """ctypes binding of K10, with its launch count ``launches`` (one per
    kernel launch and nowhere else).  Called with (plan, (C*ftpp, E)
    producer-emitted traces on the card, negate) it returns the
    consumer-ordered traces; negate for traction traces."""

    name = "trace_exchange"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            lib = EXCHANGE_LIBRARY.load()
            size = lib.seigen_trace_exchange_args_size()
            if size != ctypes.sizeof(ExchangeArgs):
                raise RuntimeError(
                    f"ExchangeArgs layout mismatch: C {size} B, ctypes "
                    f"{ctypes.sizeof(ExchangeArgs)} B")
            fn = lib.seigen_trace_exchange
            fn.argtypes = [ctypes.POINTER(ExchangeArgs), _P]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def build(self):
        """Compile/load the library now; returns the build seconds."""
        self._function()
        return EXCHANGE_LIBRARY.build_seconds

    def __call__(self, xp: ExchangePlan, tr, negate: bool):
        dev = tr.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: the kernel takes CUDA tensors, "
                             f"got {dev}")
        check_operands(self.name, dev, xp.E,
                       [(tr, xp.C * xp.ftpp), (xp.mask, xp.nf)])
        out = torch.empty_like(tr)
        g0, g1, g2 = xp.grid
        args = ExchangeArgs(
            tr=tr.data_ptr(), table=xp.table.data_ptr(),
            mask=xp.mask.data_ptr(), out=out.data_ptr(), E=xp.E, NC=xp.NC,
            g0=g0, g1=g1, g2=g2, C=xp.C, nf=xp.nf, nfp=xp.n_fp,
            ftpp=xp.ftpp, sign=-1.0 if negate else 1.0)
        err = self._function()(ctypes.byref(args),
                               torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1
        return out


TRACE_EXCHANGE = TraceExchangeKernel()


# ---------------------------------------------------------------------------
# the runner


class FusedLaneRunner(MergedLaneRunner):
    """v2 exchange-fused lane-major runner (LF4, structured meshes,
    periodic ones included).

    Besides the merged runner's arguments: ``order`` (4 only).
    ``impl="kernel"`` runs K8/K9/K10, ``"reference"`` their plain versions.
    Sources are scattered into the stage outputs and their traces (no
    kernel-fused injection)."""

    _kernel_injection = False

    def __init__(
        self,
        p: ElasticParams,
        ex: StructuredExchange,
        dt: float,
        order: int = 4,
        src: SourceData | None = None,
        damp: torch.Tensor | np.ndarray | None = None,
        receivers: ReceiverData | None = None,
        record_pressure: bool = False,
        impl: str | None = None,
        stiffness=None,
    ):
        if order != 4:
            raise ValueError("FusedLaneRunner is LF4-only (use the v1 lane "
                             "path for order=2)")
        self.record_pressure = record_pressure
        self.impl = impl = resolve_impl(impl, p.device)
        self._vel_op = vel2_op if impl == "kernel" else vel2_op_ref
        self._stress_op = stress2_op if impl == "kernel" else stress2_op_ref
        self._exchange_op = (TRACE_EXCHANGE if impl == "kernel"
                             else trace_exchange_ref)
        self._dt_f = float(dt)
        self._c3_f = float(dt) ** 3 / 24.0
        self._setup_core(p, ex, dt, damp=damp, stiffness=stiffness)
        self.xplan = build_exchange_plan(ex, self.d)
        self._build_sources(src)
        self._build_receivers(receivers)
        self._lf = self._compose_step()

    def _build_plan(self, ex, d, pay):
        return None  # the exchange plan takes its place

    def _place_traces(self, tr):
        """(C, ftp, L) face-node traces -> component-major rows."""
        return emit_components(self.d, tr)

    def _compose_step(self):
        dt, c3, d, xp = self._dt_f, self._c3_f, self.d, self.xplan
        vel, stress, exchange = self._vel_op, self._stress_op, \
            self._exchange_op

        def ex_t(tr):  # tractions: the consumer's normal is opposite
            return exchange(xp, tr, True)

        def ex_u(tr):
            return exchange(xp, tr, False)

        return compose_lf_step_traced(
            vel=lambda s, tr: vel(d, s, ex_t(tr)),
            stress=lambda u, tr: stress(d, u, ex_u(tr)),
            vel_axpy=lambda s, tr, u, uh1: vel(
                d, s, ex_t(tr), axpy=(u, uh1), dt=dt, c3=c3),
            stress_axpy=lambda u, tr, s, sh1: stress(
                d, u, ex_u(tr), axpy=(s, sh1), dt=dt, c3=c3),
            inject_u=lambda f, tr, t_: self._inject(f, tr, 0, t_),
            inject_s=lambda f, tr, t_: self._inject(f, tr, 1, t_),
            post_u=self._post_u,
        )
