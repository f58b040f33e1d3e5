"""Lane-major upwind/RK4 runner: the dissipative scheme, merged layout.

Port of ``seigen_tpu/solver/lane_upwind.py:UpwindLaneRunner``.  Classic
RK4 on lane-major state, each stage one launch of the merged Godunov
operator (ops/upwind_kernels.py: K3 for CUDA tensors), so a step is four
kernel launches plus the RK4 stage combinations in plain PyTorch.

Trace carry across stages: the coupled operator is LINEAR in (u, s), so
the (u, traction) payload traces of any stage input are the same linear
combination of carried traces as the fields themselves —
  traces(u + a*k_u) = traces(u) + a*traces(k_u)
— and each RHS application emits the traces of its OUTPUT (du, ds).  The
step carry is (u, s, payload traces[, xi]); faces are never re-extracted
from full fields inside the loop.

Viscoelastic Q (ops/viscoelastic.py): the memory-variable ODEs are
elementwise given the unrelaxed elastic stress rate ds_el the operator
outputs; xi rides the carry as an (L, n_sig*npp, Ls) stack and the
traction trace rows are corrected by -traces(sum_l xi_l) (linear again).
Point sources then enter the relaxed balance as column patches; only
elastic runs fold at most 2 wavelet groups into the operator (dense
injection).

Scheme semantics match the einsum oracle (solver/rk4.py) exactly:
co-located (u, s) in time, sources evaluated at stage times, u, s, the
traces and xi damped after the update.  ``impl`` as MergedLaneRunner.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.elastic import ElasticParams, voigt_map
from ..ops.merged_kernels import _emit
from ..ops.structured_exchange import StructuredExchange
from ..ops.upwind import UpwindData
from ..ops.upwind_kernels import (
    build_upwind_rows,
    host_f64,
    upwind_rhs_merged,
    upwind_rhs_merged_ref,
)
from ..ops.viscoelastic import ViscoData, anelastic_rates_lm
from .lane_merged import MergedLaneRunner, resolve_impl
from .receivers import ReceiverData
from .rk4 import rk4_update
from .source import SourceData, ricker
from .timestep import State, inject_columns


class UpwindLaneRunner(MergedLaneRunner):
    """RK4 + Godunov-flux runner on the merged lane layout.

    Extra args vs MergedLaneRunner: w (UpwindData — impedances + boundary
    ghosts) and visco (ViscoData or None).  State semantics: u and s are
    CO-LOCATED in time (no staggering), as in solver/rk4.py.
    """

    def __init__(
        self,
        p: ElasticParams,
        ex: StructuredExchange,
        w: UpwindData,
        dt: float,
        src: SourceData | None = None,
        damp: torch.Tensor | np.ndarray | None = None,
        receivers: ReceiverData | None = None,
        impl: str | None = None,
        visco: ViscoData | None = None,
    ):
        self.impl = resolve_impl(impl, p.device)
        self._rhs_op = (upwind_rhs_merged if self.impl == "kernel"
                        else upwind_rhs_merged_ref)
        self.visco = visco
        self._setup_core(p, ex, dt, pay=2 * p.dim)
        d, plan = self.d, self.plan
        perm = self._old_of_new
        self.uwg = self._dev(build_upwind_rows(w)[:, perm])

        # RK4 damps BOTH fields (and xi) after the update; the traces are
        # damped with the face-node values (restriction commutes with the
        # per-node diagonal)
        self.damp_n = self.damp_tr = None
        if damp is not None:
            dmp = host_f64(damp)[perm]  # (Ls, n_p)
            dn = np.zeros((d.npp, plan.Ls))
            dn[: d.n_p] = dmp.T
            self.damp_n = self._dev(dn)
            face = dmp[:, np.array(p.fnodes)].transpose(1, 2, 0)
            dtr = np.ones((plan.nf, plan.rtf, plan.Ls))
            for q in range(plan.pay):
                dtr[:, q * d.n_fp : (q + 1) * d.n_fp] = face
            self.damp_tr = self._on_trace_lanes(
                self._dev(dtr.reshape(plan.nf * plan.rtf, -1)))

        if visco is not None:
            self.yk = self._dev(host_f64(visco.y_kappa)[perm].T[:, None, :])
            self.ym = self._dev(host_f64(visco.y_mu)[perm].T[:, None, :])
            self.omegas = self._dev(host_f64(visco.omegas))

        self._build_sources(src)
        self._build_receivers(receivers)

    def _dev(self, a):
        """Host array -> contiguous device tensor of the run dtype."""
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device
                               ).to(self.dtype)

    # --- sources (payload trace patches) -------------------------------
    def _build_sources(self, src, n_groups=None):
        """Dense per-wavelet-group patterns (<= 2 groups, elastic runs:
        kernel-fused injection) or per-element column patches of u, s and
        the payload traces (viscoelastic runs, > 2 groups).  ``n_groups``:
        as MergedLaneRunner's."""
        d, p, plan = self.d, self.p, self.plan
        self.src_dense = None
        self._src_groups = []
        self.src_elems = None
        if src is None:
            return
        K = src.elems.shape[0]
        V = voigt_map(d.dim)
        elems_old = src.elems.cpu().numpy()
        e_new = self._new_of_old[elems_old]
        vec_u, vec_s = host_f64(src.vec_u), host_f64(src.vec_s)  # (K, n_p, C)
        vu = np.zeros((d.dim, d.npp, K))
        vs = np.zeros((d.n_sig, d.npp, K))
        vu[:, : d.n_p] = vec_u.transpose(2, 1, 0)
        vs[:, : d.n_p] = vec_s.transpose(2, 1, 0)
        vu = vu.reshape(d.dim * d.npp, K)
        vs = vs.reshape(d.n_sig * d.npp, K)

        f0a, t0a, ampa = (np.broadcast_to(host_f64(x), (K,))
                          for x in (src.f0, src.t0, src.amp))
        groups: dict = {}
        for k in range(K):
            key = (round(float(f0a[k]), 12), round(float(t0a[k]), 12))
            groups.setdefault(key, []).append(k)
        # viscoelastic runs skip the kernel-fused dense injection: the
        # source must enter the RELAXED stress balance AFTER the anelastic
        # target is computed (solver/rk4.py), so it cannot be folded into
        # the operator that emits ds_el
        n_groups = len(groups) if n_groups is None else n_groups
        if n_groups <= 2 and self.visco is None:
            dense = []
            for (f0g, t0g), idx in groups.items():
                Su = np.zeros((d.dim * d.npp, plan.Ls))
                Ss = np.zeros((d.n_sig * d.npp, plan.Ls))
                for k in idx:
                    Su[:, e_new[k]] += vu[:, k] * ampa[k]
                    Ss[:, e_new[k]] += vs[:, k] * ampa[k]
                dense.append((self._dev(Su), self._dev(Ss)))
                self._src_groups.append((f0g, t0g))
            self.src_dense = tuple(dense)
            return

        # column patches, with the payload patch: face-node velocity rows
        # then traction rows (the element's own normals) per face
        fn = np.array(p.fnodes).reshape(-1)
        nrm = host_f64(p.normals)[elems_old][
            :, np.repeat(np.arange(d.nf), d.n_fp)]  # (K, ftp, dim)
        sf = vec_s[:, fn]  # (K, ftp, n_sig)
        t_face = np.stack([sum(nrm[..., dd] * sf[..., V[c, dd]]
                               for dd in range(d.dim))
                           for c in range(d.dim)])  # (dim, K, ftp)
        u_face = vec_u[:, fn].transpose(2, 0, 1)  # (dim, K, ftp)
        payload = np.concatenate([u_face, t_face]).transpose(0, 2, 1)
        self.src_elems = torch.as_tensor(e_new, device=self.device)
        self.src_tlanes = self._on_trace_lanes(self.src_elems)
        self.src_vu, self.src_vs = self._dev(vu), self._dev(vs)
        self.src_trp = _emit(plan, d, self._dev(payload))
        self.src_f0, self.src_t0, self.src_amp = (
            host_f64(x).astype(self._npdt) for x in (src.f0, src.t0, src.amp))

    # --- payload traces -------------------------------------------------
    def payload_traces(self, ulm, slm):
        """(u, traction) payload traces of lane-major state in the
        face-major trace layout — seeds the step carry."""
        d = self.d
        tr_u = torch.matmul(self._rmat, ulm.reshape(d.dim, d.npp, -1))
        return self._payload_place(tr_u, self._traction_rows(slm))

    def _payload_place(self, u_rows, t_rows):
        """(dim, ftp, Ls) velocity rows (None: zero) and traction rows ->
        (nf*rtf, Lt) face-major payload traces."""
        if u_rows is None:
            u_rows = torch.zeros_like(t_rows)
        return self._on_trace_lanes(
            _emit(self.plan, self.d, torch.cat([u_rows, t_rows])))

    # --- RK4 step --------------------------------------------------------
    def _add_columns(self, du, ds, trk, t):
        """Scatter point-source columns into a stage RHS and its traces."""
        r = torch.as_tensor(
            self.src_amp * ricker(t, self.src_f0, self.src_t0),
            device=self.device)[None, :]
        return (inject_columns(du, self.src_elems, self.src_vu * r),
                inject_columns(ds, self.src_elems, self.src_vs * r),
                inject_columns(trk, self.src_tlanes, self.src_trp * r))

    def _rhs(self, ulm, slm, tr, xi, t):
        """(du, ds, traces of (du, ds), dxi or None) at stage time t."""
        d = self.d
        inject = None
        if self.src_dense is not None:
            inject = [(su, ss, self._wavelet(t, g))
                      for g, (su, ss) in enumerate(self.src_dense)]
        du, ds, trk = self._rhs_op(self.plan, d, self.uwg, ulm, slm, tr,
                                   self.mask, inject=inject)
        dxi = None
        if self.visco is not None:
            dxi, xi_sum = anelastic_rates_lm(
                ds, xi, self.yk, self.ym, self.omegas, d.dim, d.n_sig, d.npp)
            ds = ds - xi_sum
            trk = trk - self._payload_place(None,
                                            self._traction_rows(xi_sum))
        if self.src_elems is not None:
            du, ds, trk = self._add_columns(du, ds, trk, t)
        return du, ds, trk, dxi

    def step_with(self, carry, t):
        """One RK4 step on the carry (ulm, slm, payload traces, xi or
        None) starting at time t."""
        new = rk4_update(self._rhs, carry, t, self.dt)
        if self.damp_n is not None:
            d = self.d
            u, s, tr, xi = new
            new = [(u.reshape(d.dim, d.npp, -1) * self.damp_n
                    ).reshape(u.shape),
                   (s.reshape(d.n_sig, d.npp, -1) * self.damp_n
                    ).reshape(s.shape),
                   tr * self.damp_tr,
                   None if xi is None else (
                       xi.reshape(-1, d.n_sig, d.npp, xi.shape[-1])
                       * self.damp_n).reshape(xi.shape)]
        return tuple(new)

    # --- drivers ---------------------------------------------------------
    def _go(self, ulm, slm, xi, n_steps, step0):
        carry = (ulm, slm, self.payload_traces(ulm, slm), xi)
        seis = []
        for k in range(step0, step0 + n_steps):
            carry = self.step_with(carry, self._npdt(k) * self.dt)
            if self.rcv is not None:
                seis.append(self._sample(carry[0]))
        return (carry[0], carry[1], carry[3],
                torch.stack(seis) if seis else None)

    def _xi0(self, slm):
        if self.visco is None:
            return None
        return torch.zeros((self.visco.L,) + tuple(slm.shape),
                           dtype=slm.dtype, device=slm.device)

    def run(self, state0: State, n_steps: int, step0: int = 0, xi0=None):
        """n_steps from a standard-layout State; returns (State,
        seismograms numpy array or None).  xi0: lane-major memory
        variables (None: zeros)."""
        ulm, slm = self.to_lm_state(state0)
        xi = self._xi0(slm) if xi0 is None else xi0
        ulm, slm, _, seis = self._go(ulm, slm, xi, n_steps, step0)
        return self.from_lm_state(ulm, slm), (
            None if seis is None else seis.cpu().numpy())

    def run_lm(self, ulm, slm, n_steps: int, step0: int = 0, xi0=None):
        """n_steps on lane-major state; returns (ulm, slm, seismograms
        tensor (n_steps, R, dim) or None)."""
        xi = self._xi0(slm) if xi0 is None else xi0
        ulm, slm, _, seis = self._go(ulm, slm, xi, n_steps, step0)
        return ulm, slm, seis

    # --- xi layout round-trip (checkpoint/resume chunks) ---------------
    def xi_to_lm(self, xi_std):
        """(E, n_p, n_sig, L) standard -> (L, n_sig*npp, Ls)."""
        return torch.stack([self._to_lm(xi_std[..., l])
                            for l in range(self.visco.L)])

    def xi_from_lm(self, xi_lm):
        return torch.stack([self._from_lm(xi_lm[l], self.d.n_sig)
                            for l in range(self.visco.L)], dim=-1)

    def run_xi(self, state0: State, xi_std, n_steps: int, step0: int = 0):
        """Viscoelastic chunked driver: standard-layout xi in and out
        (None xi_std = zeros); returns (State, xi, seismograms or None)."""
        ulm, slm = self.to_lm_state(state0)
        xi = self._xi0(slm) if xi_std is None else self.xi_to_lm(xi_std)
        ulm, slm, xi, seis = self._go(ulm, slm, xi, n_steps, step0)
        return (self.from_lm_state(ulm, slm),
                None if xi is None else self.xi_from_lm(xi),
                None if seis is None else seis.cpu().numpy())
