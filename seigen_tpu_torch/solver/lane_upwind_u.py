"""Upwind/RK4 runner for UNSTRUCTURED meshes (``upwind_lane_u``): the
dissipative scheme, and with it viscoelastic Q, on the lane-take pipeline.

Port of ``seigen_tpu/solver/lane_upwind_u.py:UnstructuredUpwindRunner``.
The coupled Godunov operator (ops/lane_upwind_kernels.py: K6/K7 for CUDA
tensors) on the face-bijection panel machinery of the unstructured LF
runner (solver/lane_unstructured.py):

- **Panels per RHS.**  Each RK4 stage extracts the (u, traction) panels of
  its input with the panel gathers (own-row index + producer-side normal
  contraction + nf lane takes); the (f2, pi)-select runs in the operator.
  No trace carry: there is no supercell window to fill.
- **Ghosts in the select signs.**  Boundary faces self-pair, so the ghost
  coefficients (free: t+ = -t-; rigid: u+ = -u-; absorbing: zero exterior)
  fold into the per-face sign rows: ``sign_u`` = ghost_u on boundary faces
  (+1 inside), ``sign_t`` = ghost_t on boundary faces (-1 inside).
- **Three steppers, one ladder each.**  ``fused_axpy`` (elastic default):
  every stage is one K7 launch whose epilogue writes the next stage input
  and the running accumulator (``_step_fused``).  ``panel_emit=True`` is
  the same ladder with the stage's panels taken from the previous launch's
  emission instead of a gather of the stage input (only the nf lane takes
  remain).  ``fused_axpy=False`` and every viscoelastic run take the glue
  ladder (``rk4.rk4_update`` over K6): the anelastic rates need the raw
  elastic stress rate of every stage.
- **Sources.**  At most two wavelet groups fold into K7 as dense patterns
  (k += r_g(t) S_g, the wavelet value a host scalar); more groups fall back
  to column scatters after each launch, and the sponge then multiplies
  after the last scatter.

Scheme semantics match the einsum oracle (solver/rk4.py): co-located (u,
s), sources at stage times, damping after the update.  ``impl`` as
LaneMajorRunner.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.elastic import ElasticParams
from ..ops.lane_upwind_kernels import emitted_selcfg, lane_upwind_op
from ..ops.upwind import UpwindData
from ..ops.upwind_kernels import host_f64
from ..ops.viscoelastic import ViscoData, anelastic_rates_lm
from .lane_major import from_lm, to_lm
from .lane_unstructured import UnstructuredLaneRunner
from .receivers import ReceiverData
from .rk4 import rk4_update
from .source import SourceData, ricker
from .timestep import State


class UnstructuredUpwindRunner(UnstructuredLaneRunner):
    """RK4 + Godunov flux on the unstructured lane-take pipeline.

    Extra args vs UnstructuredLaneRunner: w (UpwindData), visco (ViscoData
    or None), fused_axpy, panel_emit.  State semantics: u and s CO-LOCATED
    in time.
    """

    def __init__(
        self,
        p: ElasticParams,
        w: UpwindData,
        dt: float,
        *,
        centroids=None,
        src: SourceData | None = None,
        damp=None,
        receivers: ReceiverData | None = None,
        record_pressure: bool = False,
        impl: str | None = None,
        visco: ViscoData | None = None,
        fused_axpy: bool = True,
        panel_emit: bool = False,
    ):
        super().__init__(p, dt, centroids=centroids, src=src, damp=damp,
                         receivers=receivers,
                         record_pressure=record_pressure, impl=impl)
        d, E = self.d, self.E
        old = self._old_of_new
        nf, nfp = d.nf, d.n_fp

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=self.device).to(self.dtype)

        # impedance rows: neighbour Zp/Zs expanded to face nodes, own in
        # rows 0/1 of an 8-row section (lanes in the new element order)
        def exp_face(a):  # (E, nf, 1) old order -> (ftpp, E) new order
            rows = np.zeros((d.ftpp, E))
            rows[: d.ftp] = np.repeat(host_f64(a)[old, :, 0].T, nfp, axis=0)
            return dev(rows)

        zo = np.zeros((8, E))
        zo[0] = host_f64(w.zp_own)[old, 0, 0]
        zo[1] = host_f64(w.zs_own)[old, 0, 0]
        self.uw = (exp_face(w.zp_nbr), exp_face(w.zs_nbr), dev(zo))

        # ghost coefficients folded into the per-face select signs
        pr = self.pairing  # already in the new order
        boundary = (pr.e2 == np.arange(E)[:, None]) & (
            pr.f2 == np.arange(nf)[None, :])
        su, st = np.zeros((8, E)), np.zeros((8, E))
        su[:nf] = np.where(boundary, host_f64(w.ghost_u)[old, :, 0], 1.0).T
        st[:nf] = np.where(boundary, host_f64(w.ghost_t)[old, :, 0], -1.0).T
        self.sign_u, self.sign_t = dev(su), dev(st)
        self.combo, self.selcfg = self._pg_u[1], self._pg_u[3]

        self.visco = visco
        # the fused epilogue never sees the raw ds_el the anelastic rates
        # need, so the viscoelastic step keeps the glue ladder
        self.fused_axpy = fused_axpy and visco is None
        self._rhs_op = lane_upwind_op("upwind_rhs_lm_sel", self.impl)
        self._axpy_op = lane_upwind_op("upwind_rhs_lm_sel_axpy", self.impl)

        # dense per-wavelet-group source patterns for the fused epilogue:
        # the blob pattern is constant, only r_g(t) varies
        self.src_dense = None
        if src is not None and self.fused_axpy \
                and len(self._src_groups) <= 2:
            nu, ns = d.dim * d.npp, d.n_sig * d.npp
            self.src_dense = tuple(
                (torch.zeros((nu, E), dtype=self.dtype, device=self.device
                             ).index_add_(1, lanes, pu),
                 torch.zeros((ns, E), dtype=self.dtype, device=self.device
                             ).index_add_(1, lanes, ps))
                for _, _, lanes, pu, ps in self._src_groups)

        # producer-side panel emission (opt-in): each stage launch appends
        # the own-face panels of the state it emits, so the next stage's
        # gather is only the nf lane takes.  The epilogue must then emit
        # FINAL state values: fused path, dense (or no) sources.
        self.panel_emit = False
        if panel_emit:
            if not self.fused_axpy:
                raise ValueError(
                    "panel_emit requires the fused-axpy elastic path")
            if src is not None and self.src_dense is None:
                raise ValueError(
                    "panel_emit requires dense source groups (<= 2 "
                    "distinct wavelets) or no sources: the scatter "
                    "fallback changes the state after the operator")
            self._selcfg_e = emitted_selcfg(self.selcfg)
            self.panel_emit = True

        if visco is not None:
            self.yk = dev(host_f64(visco.y_kappa)[old].T[:, None, :])
            self.ym = dev(host_f64(visco.y_mu)[old].T[:, None, :])
            self.omegas = dev(host_f64(visco.omegas))

    # --- stage inputs' panels --------------------------------------------
    def _gathered_panels(self, ulm, slm):
        return self._pg_u[0](ulm), self._pg_t[0](slm)

    def _own_rows_e(self, ulm, slm):
        """(TU, TT) own-face panels of a state in the EMISSION layout
        (per-component ftpp sections): the seed at run entry; the
        launches emit every later one."""
        d = self.d

        def relay(T):  # (rows_pad, E), stride ftp -> (C*ftpp, E)
            T = T[: d.dim * d.ftp].reshape(d.dim, d.ftp, -1)
            T = torch.nn.functional.pad(T, (0, 0, 0, d.ftpp - d.ftp))
            return T.reshape(d.dim * d.ftpp, -1)

        return (relay(self._pg_u[0].own_rows_fn(ulm)),
                relay(self._pg_t[0].own_rows_fn(slm)))

    # --- sources -----------------------------------------------------------
    def _dense_inject(self, t):
        """Dense source groups at stage time t: [(Su, Ss, r_g(t)), ...]."""
        if self.src_dense is None:
            return None
        return [(su, ss, float(ricker(t, f0, t0)))
                for (su, ss), (f0, t0, *_) in zip(self.src_dense,
                                                  self._src_groups)]

    def _inject_sc(self, xu, xs, t, c):
        """Add the stage source term, scaled by ``c``, to both blocks."""
        for f0, t0, lanes, pu, ps in self._src_groups:
            a = float(c * ricker(t, f0, t0))
            xu = xu.index_add(1, lanes, pu, alpha=a)
            xs = xs.index_add(1, lanes, ps, alpha=a)
        return xu, xs

    # --- coupled RHS (glue ladder) -----------------------------------------
    def _rhs(self, ulm, slm, xi, t):
        """(du, ds, dxi or None) at stage time t."""
        d = self.d
        out = self._rhs_op(d, self.uw, ulm, slm,
                           *self._gathered_panels(ulm, slm), self.combo,
                           self.sign_u, self.sign_t, self.selcfg)
        nu = d.dim * d.npp
        du, ds = self._inject_u(out[:nu], t), out[nu:]
        dxi = None
        if self.visco is not None:
            dxi, xi_sum = anelastic_rates_lm(
                ds, xi, self.yk, self.ym, self.omegas, d.dim, d.n_sig, d.npp)
            ds = ds - xi_sum
        return du, self._inject_s(ds, t), dxi

    # --- RK4 step ----------------------------------------------------------
    def step_with(self, carry, t):
        """One RK4 step on the carry (ulm, slm, xi or None, emitted panels
        or None) starting at time t."""
        if self.fused_axpy:
            return self._step_fused(carry, t)
        ulm, slm, xi = rk4_update(self._rhs, carry[:3], t, self.dt)
        if self.damp_u is not None:
            ulm, slm = ulm * self.damp_u, slm * self.damp_s
            if xi is not None:
                xi = xi * self.damp_s
        return ulm, slm, xi, None

    def _step_fused(self, carry, t):
        """The fused ladder: four K7 launches, each writing the next stage
        input and the accumulator (the last: the damped update).  A
        stage's panels are the gather of its input, or with panel_emit
        the lane takes of the panels the previous launch emitted."""
        ulm, slm, _, pan = carry
        d = self.d
        npdt = self._npdt
        h = float(self.dt)
        h2, w = 0.5 * h, h / 6.0
        emit = self.panel_emit
        selcfg = self._selcfg_e if emit else self.selcfg
        scatter = bool(self._src_groups) and self.src_dense is None
        # the sponge multiplies in the last launch unless a scatter of its
        # stage's source still has to land first
        in_damp = self.damp_u is not None and not scatter
        nu, ns = d.dim * d.npp, d.n_sig * d.npp
        ne = d.dim * d.ftpp

        uin, sin, au, asg = ulm, slm, ulm, slm
        # (stage time, accumulator weight, next-input weight or None)
        for t_, wa, cs in ((t, w, h2), (t + npdt(h2), 2 * w, h2),
                           (t + npdt(h2), 2 * w, h), (t + npdt(h), w, None)):
            final = cs is None
            if emit:
                pu = self._pg_u[0].takes_fn(pan[0])
                pt = self._pg_t[0].takes_fn(pan[1])
            else:
                pu, pt = self._gathered_panels(uin, sin)
            out = self._axpy_op(
                d, self.uw, uin, sin, pu, pt, self.combo, self.sign_u,
                self.sign_t, selcfg, au, asg, wa,
                base_u=None if final else ulm,
                base_s=None if final else slm, cs=cs,
                inject=self._dense_inject(t_),
                damp_row=self.damp_u[: d.npp] if final and in_damp else None,
                emit=emit)
            b = 0
            if not final:
                uin, sin, b = out[:nu], out[nu : nu + ns], nu + ns
            au, asg = out[b : b + nu], out[b + nu : b + nu + ns]
            if emit:
                b += nu + ns
                pan = (out[b : b + ne], out[b + ne :])
            if scatter:
                if not final:
                    uin, sin = self._inject_sc(uin, sin, t_, cs)
                au, asg = self._inject_sc(au, asg, t_, wa)
        if self.damp_u is not None and not in_damp:
            au, asg = au * self.damp_u, asg * self.damp_s
        return au, asg, None, pan

    # --- run loops -----------------------------------------------------------
    def _go(self, ulm, slm, xi, n_steps, step0):
        # the emission carry is rebuilt from the state at every entry, so
        # chunked runs resume exactly
        pan = self._own_rows_e(ulm, slm) if self.panel_emit else None
        carry = (ulm, slm, xi, pan)
        seis = []
        for k in range(step0, step0 + n_steps):
            carry = self.step_with(carry, self._npdt(k) * self.dt)
            if self.rcv is not None:
                seis.append(self._sample(carry[0], carry[1]))
        return (carry[0], carry[1], carry[2],
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
        tensor (n_steps, R, C) or None)."""
        xi = self._xi0(slm) if xi0 is None else xi0
        ulm, slm, _, seis = self._go(ulm, slm, xi, n_steps, step0)
        return ulm, slm, seis

    # --- xi layout round-trip (checkpoint/resume chunks) ---------------
    def xi_to_lm(self, xi_std):
        """(E, n_p, n_sig, L) standard -> (L, n_sig*npp, E)."""
        perm = torch.as_tensor(self._old_of_new, device=xi_std.device)
        return torch.stack([to_lm(xi_std[perm, :, :, l], self.d.npp)
                            for l in range(self.visco.L)])

    def xi_from_lm(self, xi_lm):
        d = self.d
        inv = torch.as_tensor(self._new_of_old, device=xi_lm.device)
        return torch.stack([from_lm(xi_lm[l], d.n_p, d.npp, d.n_sig)[inv]
                            for l in range(self.visco.L)], dim=-1)

    def run_xi(self, state0: State, xi_std, n_steps: int, step0: int = 0):
        """Viscoelastic chunked run: standard-layout xi in and out
        (None xi_std = zeros); returns (State, xi, seismograms or None)."""
        ulm, slm = self.to_lm_state(state0)
        xi = self._xi0(slm) if xi_std is None else self.xi_to_lm(xi_std)
        ulm, slm, xi, seis = self._go(ulm, slm, xi, n_steps, step0)
        return (self.from_lm_state(ulm, slm),
                None if xi is None else self.xi_from_lm(xi),
                None if seis is None else seis.cpu().numpy())
