"""Exchange-in-kernel lane-major LF4 solver (structured meshes).

Port of ``seigen_tpu/solver/lane_merged.py:MergedLaneRunner`` (unpacked;
isotropic, or with ``stiffness=`` a Voigt stiffness per element).  The state
lives in the class-major lane layout for the whole run — u: (dim*npp, Ls),
sigma: (n_sig*npp, Ls), Ls = m*NC — and every
operator reads the producer trace arrays of its input directly
(ops/merged_kernels.py), so a step is six operator launches plus one damping
multiply of u.  The traction traces of sigma ride the step carry.

``impl="kernel"`` runs the CUDA kernels (CUDA tensors only);
``impl="reference"`` runs their plain PyTorch versions on any device.  The
default follows the device of the parameters.  ``run_lm`` is a Python loop
over steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.elastic import ElasticParams, voigt_map
from ..ops.fused_kernels import build_fused_data
from ..ops.merged_kernels import (
    build_merged_plan,
    stress_merged,
    stress_merged_ref,
    vel_merged,
    vel_merged_ref,
)
from ..ops.structured_exchange import StructuredExchange
from .lane_major import class_major_perm, from_lm, resolve_impl, to_lm
from .receivers import ReceiverData
from .source import SourceData, ricker
from .timestep import State, compose_lf_step_traced, inject_columns, \
    numpy_dtype


class MergedLaneRunner:
    """Exchange-in-kernel lane-major runner (LF4, structured meshes)."""

    def __init__(
        self,
        p: ElasticParams,
        ex: StructuredExchange,
        dt: float,
        src: SourceData | None = None,
        damp: torch.Tensor | np.ndarray | None = None,
        receivers: ReceiverData | None = None,
        impl: str | None = None,
        stiffness=None,
    ):
        """``stiffness``: optional (n_sig, n_sig) or (E, n_sig, n_sig)
        Voigt stiffness in p's element order (ops/anisotropic.py
        conventions): the stress operator then takes the general Hooke
        law over the ``C`` section of the operator data."""
        self.impl = impl = resolve_impl(impl, p.device)
        self._vel_op = vel_merged if impl == "kernel" else vel_merged_ref
        self._stress_op = (stress_merged if impl == "kernel"
                           else stress_merged_ref)
        self._dt_f = float(dt)
        self._c3_f = float(dt) ** 3 / 24.0
        self._setup_core(p, ex, dt, damp=damp, stiffness=stiffness)
        self._build_sources(src)
        self._build_receivers(receivers)
        self._lf = self._compose_step()

    def _setup_core(self, p, ex, dt, damp=None, pay=None, stiffness=None):
        """Class-major permutation, merged plan, placed geo/mask, face-node
        normal expansion + restriction matrix (also used by the upwind RK4
        runner).  pay: trace payload components per face (default dim)."""
        self.p = p
        self.ex = ex
        self.device = p.device
        self.dtype = p.dtype
        self._npdt = numpy_dtype(p.dtype)
        self.dt = self._npdt(dt)

        NC = int(np.prod(ex.grid))
        old_of_new, new_of_old = class_major_perm(ex, p.Ginv.shape[0])
        self._old_of_new, self._new_of_old = old_of_new, new_of_old
        perm = torch.as_tensor(old_of_new, device=p.device)

        if damp is not None:
            damp = torch.as_tensor(damp, device=p.device)[perm]
        d = build_fused_data(p, damp=damp, stiffness=stiffness)
        # lanes are class-major elements: permute the geo columns, the
        # stiffness rows among them — stiffness went in in p's element
        # order (damp was permuted above)
        self.d = d = dataclasses.replace(d, geo=d.geo[:, perm].contiguous())
        self.plan = plan = build_merged_plan(ex, d, pay=pay)
        if plan is None:
            raise ValueError("mesh does not satisfy the merged-operator "
                             "constraints (see build_merged_plan)")

        # per-face boundary mask as lane rows (8, Ls)
        mk = np.ones((8, plan.Ls), dtype=np.float64)
        for t in range(ex.m):
            for f in range(ex.n_faces):
                mk[f, t * NC : (t + 1) * NC] = ex.self_mask[t, f].reshape(-1)
        self.mask = torch.as_tensor(mk, device=p.device).to(p.dtype)

        # face-node-expanded normals for the initial traction extraction
        rep = torch.arange(d.nf, device=p.device).repeat_interleave(d.n_fp)
        nrm = p.normals[perm]  # (Ls, nf, dim)
        self._nrm_exp = nrm[:, rep, :].permute(2, 1, 0).contiguous()
        self._rmat = d.drr[d.dim * d.npp : d.dim * d.npp + d.ftp]

    def _build_receivers(self, receivers):
        if receivers is None:
            self.rcv = None
            return
        e_new = self._new_of_old[receivers.elems.cpu().numpy()]
        w = receivers.weights
        w8 = torch.zeros((w.shape[0], self.d.npp), dtype=self.dtype,
                         device=self.device)
        w8[:, : self.d.n_p] = w.to(self.dtype)
        self.rcv = ReceiverData(
            elems=torch.as_tensor(e_new, device=self.device), weights=w8)

    def _build_sources(self, src):
        """Dense per-wavelet-group patterns (<= 2 groups: kernel-fused
        injection) or per-element column patches (scatter fallback)."""
        d, p = self.d, self.p
        self.src_dense = None
        self._src_groups = []
        self.src_vu = self.src_vs = self.src_tru = self.src_trt = None
        if src is None:
            self.src_elems = None
            return
        K = src.elems.shape[0]
        V = voigt_map(d.dim)
        fnodes = np.array(p.fnodes)
        normals = p.normals.detach().cpu().numpy().astype(np.float64)
        elems_old = src.elems.cpu().numpy()
        vec_u = src.vec_u.detach().cpu().numpy().astype(np.float64)
        vec_s = src.vec_s.detach().cpu().numpy().astype(np.float64)
        e_new = self._new_of_old[elems_old]
        vu = np.zeros((d.dim * d.npp, K), dtype=np.float64)
        vs = np.zeros((d.n_sig * d.npp, K), dtype=np.float64)
        # face-major trace patches, rows f*rtf + c*n_fp + k
        rtf = self.plan.rtf
        tru = np.zeros((d.nf * rtf, K), dtype=np.float64)
        trt = np.zeros((d.nf * rtf, K), dtype=np.float64)
        for c in range(d.dim):
            vu[c * d.npp : c * d.npp + d.n_p] = vec_u[:, :, c].T
        for c in range(d.n_sig):
            vs[c * d.npp : c * d.npp + d.n_p] = vec_s[:, :, c].T
        for c in range(d.dim):
            for f in range(d.nf):
                rows = f * rtf + c * d.n_fp + np.arange(d.n_fp)
                tru[rows] = vec_u[:, fnodes[f], c].T
                acc = np.zeros((K, d.n_fp))
                for dd in range(d.dim):
                    acc += (normals[elems_old, f, dd][:, None]
                            * vec_s[:, fnodes[f], V[c, dd]])
                trt[rows] = acc.T
        # lanes are class-major element ids (no per-class padding)
        self.src_elems = torch.as_tensor(e_new, device=self.device)

        def dev(a):
            return torch.as_tensor(a, device=self.device).to(self.dtype)

        f0a = np.broadcast_to(src.f0.cpu().numpy().astype(np.float64), (K,))
        t0a = np.broadcast_to(src.t0.cpu().numpy().astype(np.float64), (K,))
        ampa = np.broadcast_to(src.amp.cpu().numpy().astype(np.float64), (K,))
        groups: dict = {}
        for k in range(K):
            key = (round(float(f0a[k]), 12), round(float(t0a[k]), 12))
            groups.setdefault(key, []).append(k)
        if len(groups) <= 2:
            # kernel-fused injection: out += r_g(t) * S_g inside the stage
            # operators, so the emitted traces carry the source too
            dense = []
            for (f0g, t0g), idx in groups.items():
                Su = np.zeros((d.dim * d.npp, self.plan.Ls), np.float64)
                Ss = np.zeros((d.n_sig * d.npp, self.plan.Ls), np.float64)
                for k in idx:
                    Su[:, e_new[k]] += vu[:, k] * ampa[k]
                    Ss[:, e_new[k]] += vs[:, k] * ampa[k]
                dense.append((dev(Su), dev(Ss)))
                self._src_groups.append((f0g, t0g))
            self.src_dense = tuple(dense)
        self.src_vu, self.src_vs = dev(vu), dev(vs)
        self.src_tru, self.src_trt = dev(tru), dev(trt)
        npdt = self._npdt
        self.src_f0 = src.f0.cpu().numpy().astype(npdt)
        self.src_t0 = src.t0.cpu().numpy().astype(npdt)
        self.src_amp = src.amp.cpu().numpy().astype(npdt)

    # --- state conversion ---
    def _to_lm(self, x):
        """(E, n_p, C) standard -> (C*npp, Ls) class-major lanes."""
        perm = torch.as_tensor(self._old_of_new, device=x.device)
        return to_lm(x[perm], self.d.npp)

    def _from_lm(self, y, C):
        inv = torch.as_tensor(self._new_of_old, device=y.device)
        return from_lm(y, self.d.n_p, self.d.npp, C)[inv]

    def to_lm_state(self, state: State):
        return self._to_lm(state.u), self._to_lm(state.s)

    def from_lm_state(self, ulm, slm) -> State:
        return State(u=self._from_lm(ulm, self.d.dim),
                     s=self._from_lm(slm, self.d.n_sig))

    def traction_traces(self, slm):
        """Own-face traction traces of a lane-major stress field in the
        face-major trace layout — seeds the step carry."""
        d, plan = self.d, self.plan
        V = voigt_map(d.dim)
        S = slm.reshape(d.n_sig, d.npp, -1)
        tr_sig = torch.matmul(self._rmat, S)  # (n_sig, ftp, Ls)
        rows = torch.stack([
            sum(self._nrm_exp[dd] * tr_sig[V[c, dd]] for dd in range(d.dim))
            for c in range(d.dim)])
        out = torch.zeros((plan.nf, plan.rtf, plan.Ls), dtype=slm.dtype,
                          device=slm.device)
        blk = rows.reshape(d.dim, d.nf, d.n_fp, -1).transpose(0, 1)
        out[:, : d.dim * d.n_fp] = blk.reshape(d.nf, d.dim * d.n_fp, -1)
        return out.reshape(plan.nf * plan.rtf, plan.Ls)

    # --- step ---
    def _inject(self, field, tr, vecs, tr_vecs, t):
        """Scatter fallback (> 2 wavelet groups): columns += r(t)*patch."""
        if self.src_elems is None:
            return field, tr
        r = torch.as_tensor(
            self.src_amp * ricker(t, self.src_f0, self.src_t0),
            device=self.device)[None, :]
        field = inject_columns(field, self.src_elems, vecs * r)
        tr = inject_columns(tr, self.src_elems, tr_vecs * r)
        return field, tr

    def _wavelet(self, t, g):
        f0g, t0g = self._src_groups[g]
        return float(ricker(t, f0g, t0g))

    def _src_stage_ops(self):
        """(vel_src, stress_src) kernel-fused injection stage operators,
        or (None, None) when the dense-pattern path is not active."""
        dense = self.src_dense
        if dense is None:
            return None, None
        plan, d, mask = self.plan, self.d, self.mask

        def vel_src(s, tr, t_):
            return self._vel_op(
                plan, d, s, tr, mask,
                inject=[(dense[g][0], self._wavelet(t_, g))
                        for g in range(len(dense))])

        def stress_src(u, tr, t_):
            return self._stress_op(
                plan, d, u, tr, mask,
                inject=[(dense[g][1], self._wavelet(t_, g))
                        for g in range(len(dense))])

        return vel_src, stress_src

    def _post_u(self, u):
        """End-of-step u damping: a plain multiply AFTER u's traces fed the
        sh1 stage (the stress damp is folded into stress_axpy)."""
        d = self.d
        if d.damp is None:
            return u
        return (u.reshape(d.dim, d.npp, -1) * d.damp).reshape(u.shape)

    def _compose_step(self):
        dt, c3 = self._dt_f, self._c3_f
        plan, d, mask = self.plan, self.d, self.mask
        vel, stress = self._vel_op, self._stress_op
        vel_src, stress_src = self._src_stage_ops()
        return compose_lf_step_traced(
            vel_src=vel_src,
            stress_src=stress_src,
            vel=lambda s, tr: vel(plan, d, s, tr, mask),
            stress=lambda u, tr: stress(plan, d, u, tr, mask),
            vel_axpy=lambda s, tr, u, uh1: vel(
                plan, d, s, tr, mask, axpy=(u, uh1), dt=dt, c3=c3),
            stress_axpy=lambda u, tr, s, sh1: stress(
                plan, d, u, tr, mask, axpy=(s, sh1), dt=dt, c3=c3),
            inject_u=lambda f, tr, t_: self._inject(
                f, tr, self.src_vu, self.src_tru, t_),
            inject_s=lambda f, tr, t_: self._inject(
                f, tr, self.src_vs, self.src_trt, t_),
            post_u=self._post_u,
        )

    def step_with(self, carry, t):
        """One LF4 step on the carry (ulm, slm, traction traces of slm)."""
        ulm, slm, trs = carry
        return self._lf(ulm, slm, trs, t, self.dt)

    def _sample(self, u_lm):
        """(R, dim) velocity samples of lane-major u."""
        g3 = u_lm[:, self.rcv.elems].reshape(self.d.dim, self.d.npp, -1)
        return torch.einsum("ri,cir->rc", self.rcv.weights, g3)

    def run_lm(self, ulm, slm, n_steps: int, step0: int = 0):
        """n_steps on lane-major state; returns (ulm, slm, seismograms
        tensor (n_steps, R, C) or None).  Step k starts at t = k*dt in the
        run dtype."""
        trs = self.traction_traces(slm)
        carry = (ulm, slm, trs)
        seis = []
        for k in range(step0, step0 + n_steps):
            carry = self.step_with(carry, self._npdt(k) * self.dt)
            if self.rcv is not None:
                seis.append(self._sample(carry[0]))
        return carry[0], carry[1], (torch.stack(seis) if seis else None)

    def run(self, state0: State, n_steps: int, step0: int = 0):
        ulm, slm = self.to_lm_state(state0)
        ulm, slm, seis = self.run_lm(ulm, slm, n_steps, step0)
        return self.from_lm_state(ulm, slm), (
            None if seis is None else seis.cpu().numpy())
