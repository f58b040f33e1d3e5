"""Exchange-in-kernel lane-major LF4 solver (structured meshes).

Port of ``seigen_tpu/solver/lane_merged.py:MergedLaneRunner`` (isotropic, or
with ``stiffness=`` a Voigt stiffness per element; ``packed=`` the P1
two-elements-per-lane layout).  The state lives in the class-major lane
layout for the whole run — u: (dim*npp, Ls), sigma: (n_sig*npp, Ls), Ls =
m*NC — and every operator reads the producer trace arrays of its input
directly (ops/merged_kernels.py), so a step is six operator launches plus
one damping multiply of u.  The traction traces of sigma ride the step
carry.  Packed, the classes (2u, 2u+1) share the lanes of packed class u,
the element of class 2u + par on rows par*4 + i of each 8-row block (Ls =
m*NC/2; ops/fused_kernels.py:build_packed_fused_data).

``impl="kernel"`` runs the CUDA kernels (CUDA tensors only);
``impl="reference"`` runs their plain PyTorch versions on any device.  The
default follows the device of the parameters.  ``run_lm`` is a Python loop
over steps.  The v2 runner (solver/lane_fused.py) and the upwind RK4 runner
(solver/lane_upwind.py) build on this class.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.elastic import ElasticParams, voigt_map
from ..ops.fused_kernels import build_fused_data, build_packed_fused_data
from ..ops.merged_kernels import (
    _emit,
    build_merged_plan,
    stress_merged,
    stress_merged_ref,
    to_trace_lanes,
    vel_merged,
    vel_merged_ref,
)
from ..ops.structured_exchange import StructuredExchange
from .lane_major import class_major_perm, resolve_impl
from .receivers import ReceiverData
from .source import SourceData, ricker
from .timestep import State, compose_lf_step_traced, inject_columns, \
    numpy_dtype


class MergedLaneRunner:
    """Exchange-in-kernel lane-major runner (LF4, structured meshes)."""

    record_pressure = False
    # sources of <= 2 wavelet groups enter through the stage operators
    _kernel_injection = True

    def __init__(
        self,
        p: ElasticParams,
        ex: StructuredExchange,
        dt: float,
        src: SourceData | None = None,
        damp: torch.Tensor | np.ndarray | None = None,
        receivers: ReceiverData | None = None,
        record_pressure: bool = False,
        impl: str | None = None,
        stiffness=None,
        packed: bool | str = False,
    ):
        """``stiffness``: optional (n_sig, n_sig) or (E, n_sig, n_sig)
        Voigt stiffness in p's element order (ops/anisotropic.py
        conventions): the stress operator then takes the general Hooke
        law over the ``C`` section of the operator data.
        ``record_pressure``: the seismograms get a last column, the
        pressure -tr(sigma)/dim at each receiver.  ``packed``: True runs
        the P1 two-elements-per-lane layout (isotropic, an even class
        count; ValueError otherwise), "auto" takes it wherever it applies
        (P1, no stiffness, even class count)."""
        if packed == "auto":
            packed = (p.n_p <= 4 and p.n_faces <= 4 and stiffness is None
                      and ex.m % 2 == 0)
        self.record_pressure = record_pressure
        self.impl = impl = resolve_impl(impl, p.device)
        self._vel_op = vel_merged if impl == "kernel" else vel_merged_ref
        self._stress_op = (stress_merged if impl == "kernel"
                           else stress_merged_ref)
        self._dt_f = float(dt)
        self._c3_f = float(dt) ** 3 / 24.0
        self._setup_core(p, ex, dt, damp=damp, stiffness=stiffness,
                         packed=bool(packed))
        self._build_sources(src)
        self._build_receivers(receivers)
        self._lf = self._compose_step()

    def _setup_core(self, p, ex, dt, damp=None, pay=None, stiffness=None,
                    packed=False):
        """Class-major permutation, merged plan (``_build_plan``), placed
        geo/mask, face-node normal expansion + restriction matrix (also used
        by the upwind RK4 and the v2 runner, unpacked).  pay: trace payload
        components per face (default dim).  packed: the P1
        two-elements-per-lane layout, class 2u + par on parity par of
        packed class u."""
        self.p = p
        self.ex = ex
        self.device = p.device
        self.dtype = p.dtype
        self._npdt = numpy_dtype(p.dtype)
        self.dt = self._npdt(dt)

        if packed and stiffness is not None:
            raise ValueError("the packed layout is isotropic only")
        if packed and ex.m % 2:
            raise ValueError("the packed layout needs an even class count")
        NC, old_of_new, new_of_old, cells = self._lanes(
            ex, p.Ginv.shape[0])
        self.NC = NC
        self._old_of_new, self._new_of_old = old_of_new, new_of_old
        self.n_par = 2 if packed else 1
        if packed:
            # lane L of packed class u holds classes 2u and 2u+1; the geo
            # and damp columns come out in that order
            idx = np.arange(len(old_of_new)).reshape(ex.m, NC)
            pairs = [old_of_new[idx[par::2].reshape(-1)] for par in (0, 1)]
            d = build_packed_fused_data(p, *pairs, damp=damp)
        else:
            pairs = [old_of_new]
            perm = torch.as_tensor(old_of_new, device=p.device)
            d = build_fused_data(p, stiffness=stiffness)
            # lanes are class-major elements: permute the geo columns, the
            # stiffness rows among them (stiffness went in in p's element
            # order), and place the damping rows of the lanes' elements
            dn = None
            if damp is not None:
                dn = torch.zeros((d.npp, len(perm)), dtype=p.dtype,
                                 device=p.device)
                dn[: d.n_p] = torch.as_tensor(
                    damp, device=p.device)[perm].T.to(p.dtype)
            d = dataclasses.replace(d, geo=d.geo[:, perm].contiguous(),
                                    damp=dn)
        self.d = d
        # the element of each (parity, lane), in p's order
        self._pairs = [torch.as_tensor(pe, device=p.device) for pe in pairs]
        self.plan = self._build_plan(ex, d, pay)

        # per-face boundary mask as lane rows (8, Ls): row par*4 + f of
        # packed class t // 2 (unpacked: row f of class t)
        Ls = len(old_of_new) // self.n_par
        mk = np.ones((8, Ls), dtype=np.float64)
        for t in range(ex.m):
            u, par = divmod(t, self.n_par)
            for f in range(ex.n_faces):
                mk[par * 4 + f, u * NC : (u + 1) * NC] = cells(
                    ex.self_mask[t, f])
        self.mask = torch.as_tensor(mk, device=p.device).to(p.dtype)

        # face-node-expanded normals for the initial traction extraction,
        # rows par*ftq + f*n_fp + k
        rep = torch.arange(d.nf, device=p.device).repeat_interleave(d.n_fp)
        self._nrm_exp = torch.cat(
            [p.normals[pe][:, rep, :].permute(2, 1, 0) for pe in self._pairs],
            dim=1).contiguous()
        self._rmat = d.drr[d.dim * d.npp : d.dim * d.npp + d.ftp]

    def _lanes(self, ex, E):
        """(NC, old_of_new, new_of_old, cells): lanes per class, the
        element (p's order) of each class-major lane, the lane of each
        element, and the map of a supercell-grid array to the lanes'
        supercells.  One device holds the whole mesh; a slab of a sharded
        run (parallel/fused_sharded.py) holds part of it."""
        old_of_new, new_of_old = class_major_perm(ex, E)
        return (int(np.prod(ex.grid)), old_of_new, new_of_old,
                lambda g: g.reshape(-1))

    def _build_plan(self, ex, d, pay):
        plan = build_merged_plan(ex, d, pay=pay, n_par=d.n_par)
        if plan is None:
            raise ValueError("mesh does not satisfy the merged-operator "
                             "constraints (see build_merged_plan)")
        return plan

    # --- layout helpers ---
    def _slane(self, e_new):
        """Class-major element index -> its lane (packed: its pair's)."""
        NC = self.NC
        return (e_new // NC) // self.n_par * NC + e_new % NC

    def _epar(self, e_new):
        """Class-major element index -> its parity within the lane."""
        return (e_new // self.NC) % self.n_par

    def _place_traces(self, tr):
        """(C, ftp, L) face-node traces -> the runner's trace layout
        (face-major rows f*rtf + par*rtq + c*n_fp + k)."""
        return _emit(self.plan, self.d, tr)

    def _build_receivers(self, receivers):
        """Receivers at their element's lane, the node weights on the rows
        of its parity (the other rows' weights 0)."""
        if receivers is None:
            self.rcv = None
            return
        e_new = self._new_of_old[receivers.elems.cpu().numpy()]
        w = receivers.weights
        w8 = torch.zeros((w.shape[0], self.d.npp), dtype=self.dtype,
                         device=self.device)
        rows = (4 * torch.as_tensor(self._epar(e_new), device=self.device)
                [:, None] + torch.arange(self.d.n_p, device=self.device))
        w8.scatter_(1, rows, w.to(self.dtype))
        self.rcv = ReceiverData(
            elems=torch.as_tensor(self._slane(e_new), device=self.device),
            weights=w8)

    def _build_sources(self, src, n_groups=None):
        """Sources grouped by wavelet.  With <= 2 groups (and
        ``_kernel_injection``) ``src_dense`` holds the dense (u, sigma)
        patterns per group of the kernel-fused injection and
        ``_src_groups`` the (f0, t0) of each; otherwise a group is (f0, t0,
        lanes, trace lanes, u patch, sigma patch, velocity-trace patch,
        traction-trace patch), amplitudes folded in, trace patches in the
        runner's trace layout, and the stages scatter the patches.
        ``n_groups``: the group count that decides (default: src's; a
        slab passes the whole run's)."""
        d, p = self.d, self.p
        self.src_dense = None
        self._src_groups = []
        if src is None:
            return
        K = src.elems.shape[0]
        V = voigt_map(d.dim)

        def host(x):
            return x.detach().cpu().numpy().astype(np.float64)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=self.device).to(self.dtype)

        elems_old = src.elems.cpu().numpy()
        vec_u, vec_s = host(src.vec_u), host(src.vec_s)  # (K, n_p, C)
        f0a, t0a, ampa = (np.broadcast_to(host(x), (K,))
                          for x in (src.f0, src.t0, src.amp))
        e_new = self._new_of_old[elems_old]
        # node rows of each source element's parity
        par_k = self._epar(e_new)
        vu = np.zeros((d.dim, d.npp, K))
        vs = np.zeros((d.n_sig, d.npp, K))
        for par in range(self.n_par):
            kk = par_k == par
            vu[:, par * 4 : par * 4 + d.n_p, kk] = (
                vec_u[kk].transpose(2, 1, 0) * ampa[kk])
            vs[:, par * 4 : par * 4 + d.n_p, kk] = (
                vec_s[kk].transpose(2, 1, 0) * ampa[kk])
        vu = vu.reshape(d.dim * d.npp, K)
        vs = vs.reshape(d.n_sig * d.npp, K)
        lanes = self._slane(e_new)
        groups: dict = {}
        for k in range(K):
            key = (round(float(f0a[k]), 12), round(float(t0a[k]), 12))
            groups.setdefault(key, []).append(k)
        n_groups = len(groups) if n_groups is None else n_groups

        if self._kernel_injection and n_groups <= 2:
            # kernel-fused injection: out += r_g(t) * S_g inside the stage
            # operators, so the emitted traces carry the source too
            Ls = d.geo.shape[1]
            dense = []
            for key, idx in groups.items():
                Su = np.zeros((d.dim * d.npp, Ls))
                Ss = np.zeros((d.n_sig * d.npp, Ls))
                np.add.at(Su.T, lanes[idx], vu[:, idx].T)
                np.add.at(Ss.T, lanes[idx], vs[:, idx].T)
                dense.append((dev(Su), dev(Ss)))
                self._src_groups.append(key)
            self.src_dense = tuple(dense)
            return

        # face-node patches: velocity rows, and traction rows with the
        # element's own normals, on the face-node rows of its parity
        fn = np.array(p.fnodes).reshape(-1)
        ftq = d.ftp // self.n_par
        nrm = host(p.normals)[elems_old][
            :, np.repeat(np.arange(d.nf), d.n_fp)]  # (K, ftq, dim)
        sf = vec_s[:, fn]  # (K, ftq, n_sig)
        tq_u = vec_u[:, fn].transpose(2, 1, 0) * ampa  # (dim, ftq, K)
        tq_t = np.stack([sum(nrm[..., dd] * sf[..., V[c, dd]]
                             for dd in range(d.dim))
                         for c in range(d.dim)]).transpose(0, 2, 1) * ampa
        tru = np.zeros((d.dim, d.ftp, K))
        trt = np.zeros((d.dim, d.ftp, K))
        for par in range(self.n_par):
            kk = par_k == par
            tru[:, par * ftq : (par + 1) * ftq, kk] = tq_u[..., kk]
            trt[:, par * ftq : (par + 1) * ftq, kk] = tq_t[..., kk]
        for (f0g, t0g), idx in groups.items():
            lanes_g = torch.as_tensor(lanes[idx], device=self.device)
            self._src_groups.append((
                f0g, t0g, lanes_g, self._on_trace_lanes(lanes_g),
                dev(vu[:, idx]), dev(vs[:, idx]),
                self._place_traces(dev(tru[..., idx])),
                self._place_traces(dev(trt[..., idx]))))

    # --- state conversion ---
    def _to_lm(self, x):
        """(E, n_p, C) standard -> (C*npp, Ls) class-major lanes (packed:
        the element of parity par on rows par*4 + i)."""
        d = self.d
        C = x.shape[2]
        out = x.new_zeros((C, d.npp, len(self._pairs[0])))
        for par, pe in enumerate(self._pairs):
            out[:, par * 4 : par * 4 + d.n_p] = x[pe.to(x.device)].permute(
                2, 1, 0)
        return out.reshape(C * d.npp, -1)

    def _from_lm(self, y, C, pairs=None):
        """(C*npp, L) lanes -> (E, n_p, C) standard, the lanes' elements
        ``pairs`` per parity (default the runner's own)."""
        d = self.d
        y = y.reshape(C, d.npp, -1)
        out = y.new_empty((y.shape[-1] * self.n_par, d.n_p, C))
        for par, pe in enumerate(pairs or self._pairs):
            out[pe.to(y.device)] = y[:, par * 4 : par * 4 + d.n_p].permute(
                2, 1, 0)
        return out

    def to_lm_state(self, state: State):
        return self._to_lm(state.u), self._to_lm(state.s)

    def from_lm_state(self, ulm, slm) -> State:
        return State(u=self._from_lm(ulm, self.d.dim),
                     s=self._from_lm(slm, self.d.n_sig))

    def _traction_rows(self, x_lm):
        """(dim, ftp, Ls) traction rows (own normals) of a lane-major Voigt
        field."""
        d = self.d
        V = voigt_map(d.dim)
        tr_sig = torch.matmul(self._rmat, x_lm.reshape(d.n_sig, d.npp, -1))
        return torch.stack([
            sum(self._nrm_exp[dd] * tr_sig[V[c, dd]] for dd in range(d.dim))
            for c in range(d.dim)])

    def traction_traces(self, slm):
        """Own-face traction traces of a lane-major stress field in the
        runner's trace layout — seeds the step carry."""
        return self._on_trace_lanes(
            self._place_traces(self._traction_rows(slm)))

    def _on_trace_lanes(self, x):
        """State lanes (an index vector) or a (rows, Ls) trace array ->
        the same on the plan's trace lanes (a slab's halo lanes 0)."""
        if self.plan is None or self.plan.NCt == self.plan.NC:
            return x
        return (self.plan.trace_lanes(x) if x.dim() == 1
                else to_trace_lanes(self.plan, x))

    # --- step ---
    def _inject(self, field, tr, part, t):
        """Scatter the sources into a stage output and its traces: per
        wavelet group, columns += r_g(t) * patch (part 0: velocity, 1:
        stress); tr None: the field alone (the C-PML right-hand sides of
        solver/lane_cpml.py).  One index_add per array and group, the
        wavelet value an argument computed on the host: copying it to the
        device would synchronise the stream every stage."""
        for g, (_, _, lanes, tlanes, *patches) in enumerate(
                self._src_groups):
            r = self._wavelet(t, g)
            field = inject_columns(field, lanes, patches[part], alpha=r)
            if tr is not None:
                tr = inject_columns(tr, tlanes, patches[2 + part], alpha=r)
        return field, tr

    def _wavelet(self, t, g):
        f0g, t0g = self._src_groups[g][:2]
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
            inject_u=lambda f, tr, t_: self._inject(f, tr, 0, t_),
            inject_s=lambda f, tr, t_: self._inject(f, tr, 1, t_),
            post_u=self._post_u,
        )

    def step_with(self, carry, t):
        """One LF4 step on the carry (ulm, slm, traction traces of slm)."""
        ulm, slm, trs = carry
        return self._lf(ulm, slm, trs, t, self.dt)

    def _sample(self, u_lm, s_lm=None):
        """(R, dim) velocity samples of lane-major u, and with
        ``record_pressure`` and s_lm a last column, the pressure
        -tr(sigma)/dim."""
        d, w = self.d, self.rcv.weights
        g3 = u_lm[:, self.rcv.elems].reshape(d.dim, d.npp, -1)
        rec = torch.einsum("ri,cir->rc", w, g3)
        if self.record_pressure and s_lm is not None:
            gs = s_lm[:, self.rcv.elems].reshape(d.n_sig, d.npp, -1)
            pr = -gs[: d.dim].mean(dim=0)
            rec = torch.cat([rec, torch.einsum("ri,ir->r", w, pr)[:, None]],
                            dim=-1)
        return rec

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
                seis.append(self._sample(carry[0], carry[1]))
        return carry[0], carry[1], (torch.stack(seis) if seis else None)

    def run(self, state0: State, n_steps: int, step0: int = 0):
        ulm, slm = self.to_lm_state(state0)
        ulm, slm, seis = self.run_lm(ulm, slm, n_steps, step0)
        return self.from_lm_state(ulm, slm), (
            None if seis is None else seis.cpu().numpy())
