"""Merged coupled upwind (Godunov) operator: CUDA kernel K3, plain twin.

Port of ``seigen_tpu/ops/upwind_kernels.py``.  The Riemann-flux operator
gets the same exchange-in-kernel treatment as the LF4 operators
(ops/merged_kernels.py):

- **Widened trace payload.**  The Godunov flux consumes BOTH sides'
  velocity AND traction at each face node, so the face-major trace layout
  carries pay = 2*dim components per face: rows f*rtf + c*n_fp are the
  velocity traces, rows f*rtf + (dim+c)*n_fp the tractions (rtf =
  roundup(2*dim*n_fp, 8)).  Consumer signs: +1 for velocity, -1 for
  traction (conforming faces have opposite normals).
- **One coupled operator.**  du and ds come out of one launch (du needs
  div(sigma) + LIFT(t*-t-), ds needs grad(u) + Hooke(LIFT(u*-u-)); both
  Riemann states share the N/T projections), so u and sigma are each read
  once per RHS application.
- **Boundary ghosts.**  The mask-select resolves boundary faces to the
  own-side trace, then the ghost coefficients gu/gt (free: t+ = -t-;
  rigid: u+ = -u-; absorbing: zero exterior state) multiply the selected
  trace — the ghost-state construction of ops/upwind.py.

The operator is linear in the state, so the runner (solver/lane_upwind.py)
carries (u, s, traces) across RK4 stages and never re-extracts faces.

``upwind_rhs_merged`` launches K3 (csrc/upwind_kernels.cu) for CUDA tensors
and runs the plain version ``upwind_rhs_merged_ref`` for CPU tensors;
``UPWIND_KERNEL.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import CudaLibrary
from .elastic import voigt_map
from .fused_kernels import FusedOpData
from .merged_kernels import (
    MergedPlan,
    _derivs,
    _emit,
    _face_rows,
    _hooke,
    _neighbour,
    _own_mask,
    _restrict,
    check_operands,
    to_trace_lanes,
)
from .upwind import UpwindData

# uw_geo row sections (8-aligned): per-face neighbour impedances, ghost
# coefficients, then own-element impedances in rows 0-1 of the last section
UW_OFF = (0, 8, 16, 24, 32)  # zp_nbr, zs_nbr, ghost_u, ghost_t, own
UW_ROWS = 40


def host_f64(x) -> np.ndarray:
    """float64 numpy copy of an array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def build_upwind_rows(w: UpwindData) -> np.ndarray:
    """(UW_ROWS, E) lane-major geo rows from UpwindData (OLD element
    order; runners permute them into their lane layouts), float64."""
    E, nf = w.zp_nbr.shape[0], w.zp_nbr.shape[1]
    o_zpn, o_zsn, o_gu, o_gt, o_own = UW_OFF
    rows = np.zeros((UW_ROWS, E), dtype=np.float64)
    rows[o_zpn : o_zpn + nf] = host_f64(w.zp_nbr[:, :, 0]).T
    rows[o_zsn : o_zsn + nf] = host_f64(w.zs_nbr[:, :, 0]).T
    rows[o_gu : o_gu + nf] = host_f64(w.ghost_u[:, :, 0]).T
    rows[o_gt : o_gt + nf] = host_f64(w.ghost_t[:, :, 0]).T
    rows[o_own] = host_f64(w.zp_own[:, 0, 0])
    rows[o_own + 1] = host_f64(w.zs_own[:, 0, 0])
    return rows


def upwind_signs(dim: int):
    """Consumer sign of each payload component: velocity +1, traction -1."""
    return (1.0,) * dim + (-1.0,) * dim


# ---------------------------------------------------------------------------
# plain PyTorch version


def upwind_rhs_merged_ref(plan: MergedPlan, d: FusedOpData, uwg, ulm, slm,
                          trs, mask, inject=None):
    """Plain version of K3 (see upwind_rhs_merged)."""
    dim, npp, Ls = d.dim, d.npp, ulm.shape[1]
    V = voigt_map(dim)
    o_ginv, o_nrm, o_scb, _, _, o_mat = d.off[:6]
    o_zpn, o_zsn, o_gu, o_gt, o_own = UW_OFF
    geo = d.geo
    U = ulm.reshape(dim, npp, Ls)
    S = slm.reshape(d.n_sig, npp, Ls)
    der_u, own_u = _derivs(d, U), _restrict(d, U)
    der_s, own_s = _derivs(d, S), _restrict(d, S)
    nrm = [_face_rows(d, geo, o_nrm + 8 * k) for k in range(dim)]
    fsc = 2.0 * _face_rows(d, geo, o_scb)  # scb = 0.5*Fscale
    zp_p, zs_p, gu, gt = (_face_rows(d, uwg, o)
                          for o in (o_zpn, o_zsn, o_gu, o_gt))
    zp_m, zs_m = uwg[o_own], uwg[o_own + 1]
    irho, lam, mu = geo[o_mat], geo[o_mat + 1], geo[o_mat + 2]

    def nsum(vec):
        return sum(nrm[k] * vec[k] for k in range(dim))

    # own tractions t- = n . sigma- at face nodes
    t_own = torch.stack([sum(nrm[k] * own_s[V[c, k]] for k in range(dim))
                         for c in range(dim)])
    # exchanged, ghosted plus-side states (own trace on boundary faces)
    nb = _neighbour(plan, trs, upwind_signs(dim), torch.cat([own_u, t_own]),
                    _own_mask(d, mask))
    u_p, t_p = gu * nb[:dim], gt * nb[dim:]

    uN_m, uN_p = nsum(own_u), nsum(u_p)
    tN_m, tN_p = nsum(t_own), nsum(t_p)
    zp_sum = zp_m + zp_p
    zs_sum = zs_m + zs_p
    has_shear = zs_sum > 0
    zs_safe = torch.where(has_shear, zs_sum, torch.ones_like(zs_sum))
    tstar_N = (zp_p * tN_m + zp_m * tN_p + zp_m * zp_p * (uN_p - uN_m)) \
        / zp_sum
    ustar_N = (zp_m * uN_m + zp_p * uN_p + (tN_p - tN_m)) / zp_sum
    dtf, duf = [], []
    for c in range(dim):
        tT_m = t_own[c] - tN_m * nrm[c]
        tT_p = t_p[c] - tN_p * nrm[c]
        uT_m = own_u[c] - uN_m * nrm[c]
        uT_p = u_p[c] - uN_p * nrm[c]
        tT = torch.where(
            has_shear,
            (zs_p * tT_m + zs_m * tT_p + zs_m * zs_p * (uT_p - uT_m))
            / zs_safe,
            0.5 * (tT_m + tT_p))
        uT = torch.where(
            has_shear,
            (zs_m * uT_m + zs_p * uT_p + (tT_p - tT_m)) / zs_safe,
            0.5 * (uT_m + uT_p))
        dtf.append(fsc * (tstar_N * nrm[c] + tT - t_own[c]))
        duf.append(ustar_N * nrm[c] + uT - own_u[c])

    lift = d.lift[:, : d.ftp]
    # velocity equation: du = (1/rho)(div sigma + LIFT(Fscale (t*-t-)))
    surf_u = torch.matmul(lift, torch.stack(dtf))
    div = torch.stack([
        sum(geo[o_ginv + r * dim + k] * der_s[r, V[c, k]]
            for k in range(dim) for r in range(dim))
        for c in range(dim)])
    du = irho * (div + surf_u)

    # stress equation: ds = Hooke(grad u) + LIFT(Fscale Hooke_f(u*-u-))
    def grad(k, c):  # d u_c / d x_k
        return sum(geo[o_ginv + r * dim + k] * der_u[r, c] for r in range(dim))

    vol = torch.stack(_hooke(dim, lam, mu, lambda c, k: grad(k, c)))
    face = torch.stack(_hooke(dim, lam, mu, lambda c, k: nrm[k] * duf[c]))
    ds = vol + torch.matmul(lift, fsc * face)

    for s_u, s_s, r_g in inject or ():
        du = du + r_g * s_u.reshape(dim, npp, Ls)
        ds = ds + r_g * s_s.reshape(d.n_sig, npp, Ls)

    # traces of the OUTPUT: velocity rows of du, traction rows of ds (own
    # normals; the consumer flips the sign)
    tr_u = _restrict(d, du)
    tr_s = _restrict(d, ds)
    tr_t = torch.stack([sum(nrm[k] * tr_s[V[c, k]] for k in range(dim))
                        for c in range(dim)])
    return (du.reshape(dim * npp, Ls), ds.reshape(d.n_sig * npp, Ls),
            to_trace_lanes(plan, _emit(plan, d, torch.cat([tr_u, tr_t]))))


# ---------------------------------------------------------------------------
# CUDA kernel

LIBRARY = CudaLibrary("seigen_upwind", ("upwind_kernels.cu",))

_P = ctypes.c_void_p


class UpwindArgs(ctypes.Structure):
    """Mirror of ``struct UpwindArgs`` in csrc/upwind_kernels.cu."""

    _fields_ = [(n, _P) for n in (
        "u", "s", "trs", "geo", "uwg", "mask", "inj_u0", "inj_s0", "inj_u1",
        "inj_s1", "plan", "dr", "lift", "fnodes", "tab", "du", "ds",
        "trout")] + [
        (n, ctypes.c_longlong) for n in ("Ls", "Lt")] + [
        (n, ctypes.c_int) for n in (
            "NC", "NCt", "h0", "npp", "rtf", "o_ginv", "o_nrm", "o_scb",
            "o_mat",
            "n_inj")] + [(n, ctypes.c_float) for n in ("r0", "r1")]


class UpwindKernel:
    """ctypes binding of K3, with its launch count: ``launches`` grows by
    one per kernel launch and nowhere else."""

    name = "upwind_rhs"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            lib = LIBRARY.load()
            size = lib.seigen_upwind_args_size()
            if size != ctypes.sizeof(UpwindArgs):
                raise RuntimeError(
                    f"UpwindArgs layout mismatch: C {size} B, ctypes "
                    f"{ctypes.sizeof(UpwindArgs)} B")
            fn = lib.seigen_upwind_rhs
            fn.argtypes = [ctypes.POINTER(UpwindArgs), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, _P]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def build(self):
        """Compile/load the library now; returns the build seconds."""
        self._function()
        return LIBRARY.build_seconds

    def __call__(self, plan: MergedPlan, d: FusedOpData, uwg, ulm, slm, trs,
                 mask, inject=None):
        inject = list(inject or ())
        if len(inject) > 2:
            raise ValueError("the kernel takes at most 2 dense source groups")
        dev = ulm.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: the kernel takes CUDA tensors, "
                             f"got {dev}")
        if plan.pay != 2 * d.dim:
            raise ValueError(f"{self.name}: needs a plan with pay = 2*dim, "
                             f"got {plan.pay}")
        Ls = plan.Ls
        checks = [(ulm, d.dim * d.npp), (slm, d.n_sig * d.npp),
                  (trs, plan.nf * plan.rtf, plan.Lt), (d.geo, None),
                  (uwg, UW_ROWS), (mask, 8)]
        for s_u, s_s, _ in inject:
            checks += [(s_u, d.dim * d.npp), (s_s, d.n_sig * d.npp)]
        check_operands(self.name, dev, Ls, checks)
        du = torch.empty((d.dim * d.npp, Ls), dtype=ulm.dtype, device=dev)
        ds = torch.empty((d.n_sig * d.npp, Ls), dtype=ulm.dtype, device=dev)
        trout = torch.empty((plan.nf * plan.rtf, plan.Lt), dtype=ulm.dtype,
                            device=dev)
        o = d.off

        def inj(g, i):
            return inject[g][i].data_ptr() if len(inject) > g else None

        args = UpwindArgs(
            u=ulm.data_ptr(), s=slm.data_ptr(), trs=trs.data_ptr(),
            geo=d.geo.data_ptr(), uwg=uwg.data_ptr(), mask=mask.data_ptr(),
            inj_u0=inj(0, 0), inj_s0=inj(0, 1), inj_u1=inj(1, 0),
            inj_s1=inj(1, 1), plan=plan.table.data_ptr(),
            dr=d.tables.dr.data_ptr(), lift=d.tables.lift.data_ptr(),
            fnodes=d.tables.fnodes.data_ptr(),
            tab=d.tables.tile.data_ptr(), du=du.data_ptr(),
            ds=ds.data_ptr(), trout=trout.data_ptr(),
            Ls=Ls, Lt=plan.Lt, NC=plan.NC, NCt=plan.NCt, h0=plan.h0,
            npp=d.npp, rtf=plan.rtf, o_ginv=o[0],
            o_nrm=o[1], o_scb=o[2], o_mat=o[5], n_inj=len(inject),
            r0=float(inject[0][2]) if len(inject) > 0 else 0.0,
            r1=float(inject[1][2]) if len(inject) > 1 else 0.0,
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = self._function()(ctypes.byref(args), d.dim, d.n_p, d.n_fp,
                               stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: " + (
                f"no instantiation for dim={d.dim} n_p={d.n_p}" if err == -1
                else "bad arguments" if err == -2
                else f"cudaError {err}"))
        self.launches += 1
        return du, ds, trout


UPWIND_KERNEL = UpwindKernel()


def upwind_rhs_merged(plan: MergedPlan, d: FusedOpData, uwg, ulm, slm, trs,
                      mask, inject=None):
    """Coupled Godunov RHS on lane-major state with in-kernel exchange (K3).

    ulm (dim*npp, Ls), slm (n_sig*npp, Ls), uwg (UW_ROWS, Ls) impedance/
    ghost rows, trs (nf*rtf, Lt) face-major (u, t) payload traces of the
    INPUT state (plan built with pay = 2*dim; the traces lie on the plan's
    trace lanes, a slab's halo included).  inject: None or
    [(Su_g, Ss_g, r_g float), ...] (at most 2) kernel-fused dense source
    groups, added before the output traces are emitted.  Returns (du,
    ds_el, traces of (du, ds_el)).

    CUDA tensors launch K3; CPU tensors run upwind_rhs_merged_ref.
    """
    if ulm.device.type == "cuda":
        return UPWIND_KERNEL(plan, d, uwg, ulm, slm, trs, mask, inject=inject)
    return upwind_rhs_merged_ref(plan, d, uwg, ulm, slm, trs, mask,
                                 inject=inject)
