"""C-PML on the merged lane engine: absorbing layers through K1/K2.

Port of ``seigen_tpu/solver/lane_cpml.py:CpmlLaneRunner``.  The runner adds
no kernel; it rests on two structural facts:

1. **The stock merged operators compute exact direction-split operators
   when fed direction-masked geometry.**  The split velocity piece
   V_k(sigma) (ops/cpml.apply_vel_op_split) is the merged velocity
   operator K1 run on geo whose Ginv rows r*dim + d, d != k, and normal
   sections d != k are zero, fed the producer traction traces contracted
   with n_k alone.  Likewise the split stress piece S_k(u) is K2 under the
   same mask (its velocity-trace payload does not depend on the
   direction; n_k enters through the masked normal sections).  The
   boundary-flux coefficients (scb/bfs/dfs) ride unchanged: they are
   per-(element, face) scalars that commute with the n_k weighting.  K1
   negates the producer traction (its neighbour's normal is opposite), so
   the own-normal seeds are the right input.  The traces the masked
   launches emit are discarded: every right-hand side seeds its own.

2. **Memory fields in operator-output units commute with the decay ODE.**
   The kernels apply the material (1/rho, Hooke), so the memory variables
   are pv_k = (1/rho) psi_v[k] and ps_k = C : sym(psi_s[k]): per-element
   material factors commute with the per-(node, direction) diagonal
   decay, so

       udot    = sum_k (V_k + pv_k)
       pvdot_k = -(d_k + a_k) pv_k - d_k V_k
       sdot    = sum_k (S_k + ps_k)
       psdot_k = -(d_k + a_k) ps_k - d_k S_k

   integrates the same dynamics as solver/pml.make_cpml_rhs.  ps lives in
   Voigt stress rows: the sym embedding of a direction-k gradient piece
   mixes only entries that share the same (node, k) decay.

A right-hand side is dim K1 and dim K2 plain launches, a step classical
RK4 (the scheme of solver/pml.run_cpml): 4 * 2 * dim launches, 24 in 3D.
Sources enter the right-hand sides as wavelet-group column scatters
(MergedLaneRunner._inject on the field alone).  Isotropic and unpacked
only.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.elastic import ElasticParams, voigt_map
from ..ops.merged_kernels import stress_merged, stress_merged_ref, \
    vel_merged, vel_merged_ref
from ..ops.structured_exchange import StructuredExchange
from .lane_major import resolve_impl
from .lane_merged import MergedLaneRunner
from .pml import cpml_profiles
from .receivers import ReceiverData
from .source import SourceData
from .timestep import State


class CpmlLaneRunner(MergedLaneRunner):
    """Merged-engine C-PML RK4 runner (one GPU, isotropic, unpacked).

    Besides the merged runner's arguments: the mesh ``dm`` and the C-PML
    profile arguments of solver/pml.cpml_profiles (``sides``, ``width``,
    ``vp_max``, ``f0``, ``R0``, ``p_exp``).  ``impl="kernel"`` runs K1/K2,
    ``"reference"`` their plain versions; the default follows the device
    of the parameters.  The carry is (u, s, pv, ps) on the lanes: u
    (dim*npp, Ls), s (n_sig*npp, Ls), pv (dim, dim*npp, Ls), ps (dim,
    n_sig*npp, Ls)."""

    # sources are scattered into the right-hand sides
    _kernel_injection = False

    def __init__(
        self,
        p: ElasticParams,
        dm,
        ex: StructuredExchange,
        dt: float,
        sides,
        width: float,
        vp_max: float,
        f0: float = 2.0,
        src: SourceData | None = None,
        receivers: ReceiverData | None = None,
        impl: str | None = None,
        R0: float = 1e-4,
        p_exp: float = 2.0,
        packed: bool = False,
    ):
        if packed:
            raise ValueError("the C-PML lane runner is unpacked only")
        self.impl = impl = resolve_impl(impl, p.device)
        self._vel_op = vel_merged if impl == "kernel" else vel_merged_ref
        self._stress_op = (stress_merged if impl == "kernel"
                           else stress_merged_ref)
        self._dt_f = float(dt)
        self._setup_core(p, ex, dt)
        self._build_sources(src)
        self._build_receivers(receivers)
        d = self.d
        dim, npp = d.dim, d.npp

        # direction-masked geo: the split operators from the stock kernels
        o_ginv, o_nrm = d.off[0], d.off[1]
        self._d_dir = []
        for k in range(dim):
            g = d.geo.clone()
            for rd in range(dim * dim):
                if rd % dim != k:
                    g[o_ginv + rd] = 0.0
            for dd in range(dim):
                if dd != k:
                    g[o_nrm + 8 * dd : o_nrm + 8 * dd + 8] = 0.0
            self._d_dir.append(dataclasses.replace(d, geo=g))

        # per-node profiles on the lanes, (dim, npp, Ls); pad rows 0
        dprof, aprof = cpml_profiles(dm, sides, width, vp_max, f0=f0, R0=R0,
                                     p_exp=p_exp)

        def lanes(prof):
            x = torch.as_tensor(prof, device=self.device).to(self.dtype)
            return self._to_lm(x).reshape(dim, npp, -1)

        # negated: a memory rate is -decay*mem - dd*op
        self._ndd = lanes(-dprof)
        self._ndecay = lanes(-(dprof + aprof))

    # --- the C-PML right-hand side ---------------------------------------
    def _memory(self, acc, rate, mem, op, k, C):
        """rate = -decay_k*mem - dd_k*op, then acc += op + mem (None acc:
        the sum starts in op's buffer, a fresh kernel output); returns
        acc."""
        rows = (C, self.d.npp, -1)
        r = rate.view(rows)
        torch.mul(mem.view(rows), self._ndecay[k], out=r)
        r.addcmul_(op.view(rows), self._ndd[k])
        op.add_(mem)
        return op if acc is None else acc.add_(op)

    def rhs(self, carry, t):
        """Rates (udot, sdot, pvdot, psdot) of the carry at stage time t:
        dim split velocity and dim split stress operators on traces seeded
        from the carry, the memory-field decay and the sources."""
        d, plan, mask = self.d, self.plan, self.mask
        dim, n_sig, npp = d.dim, d.n_sig, d.npp
        V = voigt_map(dim)
        u, s, pv, ps = carry
        Ls = u.shape[1]
        tru = self._place_traces(
            torch.matmul(self._rmat, u.reshape(dim, npp, Ls)))
        tr_sig = torch.matmul(self._rmat, s.reshape(n_sig, npp, Ls))
        pvdot, psdot = torch.empty_like(pv), torch.empty_like(ps)
        udot = sdot = None
        for k in range(dim):
            dk = self._d_dir[k]
            # the direction-k piece of the own tractions, n_k sigma_{ck}
            trt = self._place_traces(
                self._nrm_exp[k] * tr_sig[[int(V[c, k]) for c in range(dim)]])
            vk, _ = self._vel_op(plan, dk, s, trt, mask)
            udot = self._memory(udot, pvdot[k], pv[k], vk, k, dim)
            sk, _ = self._stress_op(plan, dk, u, tru, mask)
            sdot = self._memory(sdot, psdot[k], ps[k], sk, k, n_sig)
        udot, _ = self._inject(udot, None, 0, t)
        sdot, _ = self._inject(sdot, None, 1, t)
        return udot, sdot, pvdot, psdot

    # --- classical RK4 (method of lines, as solver/pml.run_cpml) ---------
    def step(self, carry, t):
        """One RK4 step of the carry (u, s, pv, ps) from time t."""
        dt = self._dt_f
        k = self.rhs(carry, t)
        out = [torch.add(x, kx, alpha=dt / 6.0) for x, kx in zip(carry, k)]
        for a, w in ((0.5, 2.0), (0.5, 2.0), (1.0, 1.0)):
            k = self.rhs([torch.add(x, kx, alpha=a * dt)
                          for x, kx in zip(carry, k)], t + a * self.dt)
            for y, kx in zip(out, k):
                y.add_(kx, alpha=w * dt / 6.0)
        return tuple(out)

    def init_carry(self, state0: State):
        """(u, s, pv, ps) on the lanes from a standard-layout State, the
        memory fields zero."""
        ulm, slm = self.to_lm_state(state0)
        dim = self.d.dim
        return (ulm, slm, ulm.new_zeros((dim,) + tuple(ulm.shape)),
                slm.new_zeros((dim,) + tuple(slm.shape)))

    def run_lm(self, carry, n_steps: int, step0: int = 0):
        """n_steps on the lane-major carry; returns (carry, seismograms
        tensor (n_steps, R, dim) or None).  Step k starts at t = k*dt in
        the run dtype."""
        seis = []
        for k in range(step0, step0 + n_steps):
            carry = self.step(carry, self._npdt(k) * self.dt)
            if self.rcv is not None:
                seis.append(self._sample(carry[0]))
        return carry, (torch.stack(seis) if seis else None)

    def run(self, state0: State, n_steps: int, step0: int = 0):
        """n_steps from a standard-layout State (memory fields zero);
        returns (State, seismograms numpy array or None)."""
        carry, seis = self.run_lm(self.init_carry(state0), n_steps, step0)
        return self.from_lm_state(carry[0], carry[1]), (
            None if seis is None else seis.cpu().numpy())
