"""Fully lane-major LF2/LF4 solver path (the v1 ``lane`` runner).

Port of ``seigen_tpu/solver/lane_major.py``.  The whole run keeps its state
in the lane-major layout — u: (dim*npp, E), sigma: (n_sig*npp, E), lanes in
class-major element order (every element class a contiguous lane slice) —
so a step is exactly: trace exchange -> operator (ops/lane_kernels.py), 2x
(LF2) or 6x (LF4), plus the source scatter into lane columns and the
sponge multiply of u and sigma.  Layout conversions happen once at the
start and end of a run.

The structured exchange (``make_exchange_lm``) is one precomputed-index
gather per call: the JAX package's per-(class, face) roll-and-select over
the supercell grid, resolved on the host into a flat index.  Unlike the
merged runner this one takes periodic meshes (the roll wraps).

``impl="kernel"`` runs the CUDA operators (CUDA tensors only);
``impl="reference"`` their plain PyTorch versions on any device; the
default follows the device of the parameters.  ``run_lm`` is a Python loop
over steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.elastic import ElasticParams
from ..ops.lane_kernels import LaneOpData, build_cmat, build_lane_data, \
    lane_op, permute_lanes
from ..ops.structured_exchange import StructuredExchange
from ..ops.unstructured_exchange import _gather_plan, _gather_traces
from .receivers import ReceiverData
from .source import SourceData, ricker
from .timestep import State, compose_lf_step, numpy_dtype


def resolve_impl(impl: str | None, device: torch.device) -> str:
    """The runner's operator implementation: "kernel" (CUDA kernels, CUDA
    tensors only) or "reference" (plain versions); None follows the
    device."""
    if impl is None:
        impl = "kernel" if device.type == "cuda" else "reference"
    if impl not in ("kernel", "reference"):
        raise ValueError(f"impl must be 'kernel' or 'reference': {impl!r}")
    if impl == "kernel" and device.type != "cuda":
        raise ValueError("impl='kernel' needs CUDA tensors; the plain "
                         "version runs with impl='reference'")
    return impl


def to_lm(x: torch.Tensor, rows_pad: int) -> torch.Tensor:
    """(E, m, C) -> (C*rows_pad, E), pad rows zero."""
    E, m, C = x.shape
    out = x.new_zeros((C, rows_pad, E))
    out[:, :m] = x.permute(2, 1, 0)
    return out.reshape(C * rows_pad, E)


def from_lm(y: torch.Tensor, m: int, rows_pad: int, C: int) -> torch.Tensor:
    """(C*rows_pad, E) -> (E, m, C)."""
    return y.reshape(C, rows_pad, -1)[:, :m].permute(2, 1, 0).contiguous()


def class_major_perm(ex: StructuredExchange, E: int):
    """Element permutation to class-major lane order.

    Returns (old_of_new, new_of_old): new id = class * n_cells + supercell
    lex index — every class becomes a CONTIGUOUS lane slice.
    """
    base_grid = ex.base_grid
    scale, m0 = ex.scale, ex.m0
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
    supflat = sup[0]
    for g, ci in zip(ex.grid[1:], sup[1:]):
        supflat = supflat * g + ci
    NC = int(np.prod(ex.grid))
    new_of_old = cls * NC + supflat
    old_of_new = np.empty(E, dtype=np.int64)
    old_of_new[new_of_old] = np.arange(E)
    return old_of_new, new_of_old


def make_exchange_lm(ex: StructuredExchange, d: LaneOpData, C: int, E: int):
    """Structured trace exchange in CLASS-MAJOR lane order: (C*npp, E)
    field -> (C*ftpp, E) neighbour traces, rows c*ftpp + f*n_fp + k.

    Lane t*NC + j (class t, supercell j) of face f reads class
    nbr_class[t, f] at the supercell j shifted by shift[t, f] (wrapping, as
    the JAX package's roll does), nodes ex.nodes[t, f]; where
    self_mask[t, f, j] it reads its own face nodes instead.  The whole
    exchange is one gather through an index built here on the host.
    """
    grid = ex.grid
    NC = int(np.prod(grid))
    nf, nfp = ex.n_faces, ex.n_fp
    ftp = nf * nfp
    sup = np.stack(np.unravel_index(np.arange(NC), grid), axis=0)  # (dim, NC)
    rows = np.zeros((nf, nfp, ex.m, NC), dtype=np.int64)
    lanes = np.zeros((nf, nfp, ex.m, NC), dtype=np.int64)
    for t in range(ex.m):
        for f in range(nf):
            src = np.ravel_multi_index(
                tuple((sup[ax] + ex.shift[t, f, ax]) % g
                      for ax, g in enumerate(grid)), grid)
            own = ex.self_mask[t, f].reshape(-1)  # (NC,)
            lanes[f, :, t] = np.where(own, t * NC + np.arange(NC),
                                      int(ex.nbr_class[t, f]) * NC + src)
            rows[f, :, t] = np.where(own[None], ex.own_nodes[f][:, None],
                                     ex.nodes[t, f][:, None])
    idx = _gather_plan(rows.reshape(ftp, E), lanes.reshape(ftp, E), E,
                       d.ginv.device)

    def exchange(f_lm: torch.Tensor) -> torch.Tensor:
        return _gather_traces(f_lm, idx, C, ftp, d.ftpp, E)

    return exchange


class LaneMajorRunner:
    """Build once from concrete data; run entire simulations lane-major
    (LF2 or LF4, structured meshes, periodic ones included).

    ``stiffness``: optional (n_sig, n_sig) or (E, n_sig, n_sig) Voigt
    stiffness in p's element order (ops/anisotropic.py conventions): the
    stress operator then takes the general Hooke law instead of p's
    lam/mu."""

    def __init__(
        self,
        p: ElasticParams,
        ex: StructuredExchange | None,
        dt: float,
        order: int = 4,
        src: SourceData | None = None,
        damp: torch.Tensor | np.ndarray | None = None,
        receivers: ReceiverData | None = None,
        record_pressure: bool = False,
        impl: str | None = None,
        stiffness=None,
    ):
        self.impl = resolve_impl(impl, p.device)
        self.record_pressure = record_pressure
        self.p, self.ex, self.order = p, ex, order
        self.device, self.dtype = p.device, p.dtype
        self._npdt = numpy_dtype(p.dtype)
        self.dt = self._npdt(dt)
        d = build_lane_data(p)
        self.E = E = d.E

        # element reordering (structured: class-major; subclasses override,
        # e.g. Morton locality order for unstructured meshes)
        old_of_new, new_of_old = self._element_perm()
        self._old_of_new, self._new_of_old = old_of_new, new_of_old
        perm = torch.as_tensor(old_of_new, device=p.device)
        self.d = d = permute_lanes(d, perm)
        self.ex_u, self.ex_s = self._make_exchanges()

        # general anisotropic Hooke rows (n_sig*8, E), lanes in the new
        # order: row c*8+k = Voigt C[old_of_new, c, k]
        self.cmat = (None if stiffness is None
                     else build_cmat(stiffness, d, old_of_new))

        # tiled damping rows (lanes in the new order)
        self.damp_u = self.damp_s = None
        if damp is not None:
            dn = torch.zeros((d.npp, E), dtype=self.dtype, device=p.device)
            dn[: d.n_p] = torch.as_tensor(damp, device=p.device)[perm].T
            self.damp_u = dn.repeat(d.dim, 1)
            self.damp_s = dn.repeat(d.n_sig, 1)

        # lane-major source patches (elements remapped to the new order),
        # grouped by wavelet (f0, t0): a stage adds r_g(t) * amp * vec to
        # the group's lane columns with one index_add whose alpha is the
        # wavelet value computed on the host — a host-to-device copy of
        # the wavelet values would synchronise the stream every stage
        self._src_groups = []  # (f0, t0, lanes, patch_u, patch_s)
        if src is not None:
            npdt = self._npdt
            lanes = torch.as_tensor(new_of_old[src.elems.cpu().numpy()],
                                    device=p.device)
            amp = src.amp.to(self.dtype)
            f0 = src.f0.cpu().numpy().astype(npdt)
            t0 = src.t0.cpu().numpy().astype(npdt)

            def patch(vec, idx):  # (K, n_p, C) -> (C*npp, len(idx))
                C = vec.shape[2]
                out = torch.zeros((C, d.npp, len(idx)), dtype=self.dtype,
                                  device=p.device)
                out[:, : d.n_p] = (vec.to(self.dtype)[idx] * amp[idx, None,
                                                                  None]
                                   ).permute(2, 1, 0)
                return out.reshape(C * d.npp, -1)

            for f0g, t0g in sorted(set(zip(f0, t0))):
                idx = torch.as_tensor(np.nonzero((f0 == f0g) & (t0 == t0g))[0],
                                      device=p.device)
                self._src_groups.append((f0g, t0g, lanes[idx],
                                         patch(src.vec_u, idx),
                                         patch(src.vec_s, idx)))

        self.rcv = None
        if receivers is not None:
            self.rcv = ReceiverData(
                elems=torch.as_tensor(
                    new_of_old[receivers.elems.cpu().numpy()],
                    device=p.device),
                weights=receivers.weights.to(self.dtype))

        self._lf = compose_lf_step(
            vel=self._vel, stress=self._stress, inject_u=self._inject_u,
            inject_s=self._inject_s, post=self._post, dt=self.dt,
            order=order)

    # --- structured-mesh hooks (overridden by UnstructuredLaneRunner) ---
    def _element_perm(self):
        return class_major_perm(self.ex, self.E)

    def _make_exchanges(self):
        d, E = self.d, self.E
        return (make_exchange_lm(self.ex, d, d.dim, E),
                make_exchange_lm(self.ex, d, d.n_sig, E))

    def _op(self, name):
        return lane_op(name, self.impl)

    # --- state conversion (includes the element permutation) ---
    def to_lm_state(self, state: State):
        d = self.d
        perm = torch.as_tensor(self._old_of_new, device=state.u.device)
        return (to_lm(state.u[perm], d.npp), to_lm(state.s[perm], d.npp))

    def from_lm_state(self, ulm, slm) -> State:
        d = self.d
        inv = torch.as_tensor(self._new_of_old, device=ulm.device)
        return State(u=from_lm(ulm, d.n_p, d.npp, d.dim)[inv],
                     s=from_lm(slm, d.n_p, d.npp, d.n_sig)[inv])

    # --- step pieces ---
    def _vel(self, s_lm):
        return self._op("vel_op_lm")(self.d, s_lm, self.ex_s(s_lm))

    def _stress(self, u_lm):
        return self._op("stress_op_lm")(self.d, u_lm, self.ex_u(u_lm),
                                        cmat=self.cmat)

    def _inject(self, field, part, t):
        """field[:, lanes_g] += r_g(t) * patch_g for every wavelet group;
        part 0: velocity patches, 1: stress patches."""
        for f0, t0, lanes, *patches in self._src_groups:
            field = field.index_add(1, lanes, patches[part],
                                    alpha=float(ricker(t, f0, t0)))
        return field

    def _inject_u(self, du_lm, t):
        return self._inject(du_lm, 0, t)

    def _inject_s(self, ds_lm, t):
        return self._inject(ds_lm, 1, t)

    def _post(self, u, s):
        """End-of-step sponge: damps BOTH u and sigma."""
        if self.damp_u is None:
            return u, s
        return u * self.damp_u, s * self.damp_s

    def step(self, carry, t):
        """One LF step on the carry (ulm, slm) starting at time t."""
        return self._lf(carry[0], carry[1], t)

    def _sample(self, u_lm, s_lm=None):
        """(R, dim) velocity samples [+ a pressure column]."""
        d = self.d
        w = self.rcv.weights
        g3 = u_lm[:, self.rcv.elems].reshape(d.dim, d.npp, -1)[:, : d.n_p]
        rec = torch.einsum("ri,cir->rc", w, g3)
        if self.record_pressure and s_lm is not None:
            gs = s_lm[:, self.rcv.elems].reshape(d.n_sig, d.npp, -1)
            # pressure = -tr(sigma)/dim: first `dim` Voigt components
            pr = -gs[: d.dim, : d.n_p].mean(dim=0)
            rec_p = torch.einsum("ri,ir->r", w, pr)[:, None]
            rec = torch.cat([rec, rec_p], dim=-1)
        return rec

    def run_lm(self, ulm, slm, n_steps: int, step0: int = 0):
        """n_steps on lane-major state; returns (ulm, slm, seismograms
        tensor (n_steps, R, C) or None).  Step k starts at t = k*dt in the
        run dtype."""
        carry = (ulm, slm)
        seis = []
        for k in range(step0, step0 + n_steps):
            carry = self.step(carry, self._npdt(k) * self.dt)
            if self.rcv is not None:
                seis.append(self._sample(*carry))
        return carry[0], carry[1], (torch.stack(seis) if seis else None)

    def run(self, state0: State, n_steps: int, step0: int = 0):
        """Returns (final State, seismograms numpy array or None).

        ``step0``: global index of the first step (keeps time-dependent
        sources in phase on resume)."""
        ulm, slm = self.to_lm_state(state0)
        ulm, slm, seis = self.run_lm(ulm, slm, n_steps, step0)
        return self.from_lm_state(ulm, slm), (
            None if seis is None else seis.cpu().numpy())
