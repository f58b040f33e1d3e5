"""Coupled upwind (Godunov) RHS on unstructured lane-major state: CUDA
kernels K6/K7, plain twins.

Port of the upwind part of ``seigen_tpu/ops/pallas_kernels.py``
(``upwind_rhs_lm_sel``, ``upwind_rhs_lm_sel_axpy``): the Godunov operator of
ops/upwind_kernels.py on the lane layout and panel exchange of the
unstructured LF runner (ops/lane_kernels.py, ops/unstructured_exchange.py).

- **Plus side from raw panels.**  ``panels_u`` holds velocity traces,
  ``panels_t`` producer-contracted tractions, one lane take per face; the
  (f2, pi)-select runs in the operator through the combo code.
- **Ghosts in the select signs.**  Boundary faces self-pair, so the select
  resolves them to the own trace and the per-face sign rows carry the ghost
  coefficients there (``sign_u``: ghost_u, +1 inside; ``sign_t``: ghost_t,
  -1 inside, the producer's normal being minus the consumer's).
- **Impedance rows.**  ``uw = (zpn, zsn, zown)``: neighbour Zp/Zs expanded
  to face nodes (ftpp, E), own Zp/Zs in rows 0/1 of an (8, E) section.
- **Fused RK4 epilogue** (``upwind_rhs_lm_sel_axpy``).  Beside the RHS
  k = (du, ds) of the stage input the operator reads the step's base state
  and the running accumulator and writes the next stage input and the new
  accumulator (stage mode), or the completed, optionally sponge-damped
  update (final mode); up to two dense source groups add r_g * S_g to k
  first; ``emit=True`` appends the own-face (u, traction) panels of the
  emitted state in the per-component-ftpp layout, which the next call's
  select reads with ``selcfg`` = (C, nf, n_fp, ftpp, ftpp, C*ftpp, ...).

``upwind_rhs_lm_sel`` launches K6 ``lane_upwind_rhs`` and
``upwind_rhs_lm_sel_axpy`` K7 ``lane_upwind_axpy``
(csrc/lane_upwind_kernels.cu) for CUDA tensors; CPU tensors run the plain
versions ``*_ref``.  ``LANE_UPWIND_RHS.launches`` and
``LANE_UPWIND_AXPY.launches`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary
from .elastic import voigt_map
from .lane_kernels import LaneOpData, _derivs_own, _select_tiles, \
    check_select
from .merged_kernels import _hooke, check_operands


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _upwind_rows(d: LaneOpData, uw, u_lm, s_lm, panels_u, panels_t, combo,
                 sign_u, sign_t, selcfg):
    """(du (dim, npp, E), ds (n_sig, npp, E)) of the coupled Godunov RHS."""
    dim, ftpp, n_sig = d.dim, d.ftpp, d.n_sig
    V = voigt_map(dim)
    E = u_lm.shape[1]
    zpn, zsn, zown = uw
    der_u, own_u = _derivs_own(d, u_lm, dim)
    der_s, own_s = _derivs_own(d, s_lm, n_sig)
    nrm = d.nrm.reshape(dim, ftpp, E)
    ginv = d.ginv

    def nsum(vec):
        return sum(nrm[k] * vec[k] for k in range(dim))

    t_own = [sum(nrm[k] * own_s[V[c, k]] for k in range(dim))
             for c in range(dim)]
    # exchanged, ghosted plus-side states
    u_p = _select_tiles(panels_u, combo, sign_u, selcfg).reshape(
        dim, ftpp, E)
    t_p = _select_tiles(panels_t, combo, sign_t, selcfg).reshape(
        dim, ftpp, E)

    zp_m, zs_m = zown[0], zown[1]
    uN_m, uN_p = nsum(own_u), nsum(u_p)
    tN_m, tN_p = nsum(t_own), nsum(t_p)
    zp_sum = zp_m + zpn
    zs_sum = zs_m + zsn
    # a face with Zs- + Zs+ = 0 (acoustic on both sides) takes the average
    # of the two tangential states; Zp- + Zp+ > 0 on every lane (the own
    # impedance is positive and there are no dead pad lanes)
    has_shear = zs_sum > 0
    zs_safe = torch.where(has_shear, zs_sum, torch.ones_like(zs_sum))
    tstar_N = (zpn * tN_m + zp_m * tN_p + zp_m * zpn * (uN_p - uN_m)) \
        / zp_sum
    ustar_N = (zp_m * uN_m + zpn * uN_p + (tN_p - tN_m)) / zp_sum
    dtf, duf = [], []
    for c in range(dim):
        tT_m = t_own[c] - tN_m * nrm[c]
        tT_p = t_p[c] - tN_p * nrm[c]
        uT_m = own_u[c] - uN_m * nrm[c]
        uT_p = u_p[c] - uN_p * nrm[c]
        tT = torch.where(
            has_shear,
            (zsn * tT_m + zs_m * tT_p + zs_m * zsn * (uT_p - uT_m))
            / zs_safe,
            0.5 * (tT_m + tT_p))
        uT = torch.where(
            has_shear,
            (zs_m * uT_m + zsn * uT_p + (tT_p - tT_m)) / zs_safe,
            0.5 * (uT_m + uT_p))
        dtf.append(d.fsc * (tstar_N * nrm[c] + tT - t_own[c]))
        duf.append(ustar_N * nrm[c] + uT - own_u[c])

    # velocity equation: du = (1/rho)(div sigma + LIFT(Fscale (t*-t-)))
    div = torch.stack([
        sum(ginv[r * dim + k] * der_s[V[c, k], r]
            for k in range(dim) for r in range(dim))
        for c in range(dim)])
    du = d.irho[0] * (div + torch.matmul(d.lift, torch.stack(dtf)))

    # stress equation: ds = Hooke(grad u) + LIFT(Fscale Hooke_f(u*-u-))
    def grad(c, k):  # d u_c / d x_k
        return sum(ginv[r * dim + k] * der_u[c, r] for r in range(dim))

    lam, mu = d.lam[0], d.mu[0]
    vol = torch.stack(_hooke(dim, lam, mu, grad))
    face = torch.stack(_hooke(dim, lam, mu, lambda c, k: nrm[k] * duf[c]))
    ds = vol + torch.matmul(d.lift, d.fsc * face)
    return du, ds


def upwind_rhs_lm_sel_ref(d: LaneOpData, uw, u_lm, s_lm, panels_u, panels_t,
                          combo, sign_u, sign_t, selcfg):
    """Plain version of K6 (see upwind_rhs_lm_sel)."""
    du, ds = _upwind_rows(d, uw, u_lm, s_lm, panels_u, panels_t, combo,
                          sign_u, sign_t, selcfg)
    E = u_lm.shape[1]
    return torch.cat([du.reshape(-1, E), ds.reshape(-1, E)])


def own_face_panels(d: LaneOpData, u_lm, s_lm):
    """Own-face panels of a lane-major state in the EMITTED layout: (TU,
    TT), each (dim*ftpp, E), rows c*ftpp + f*n_fp + k: u_c at the face
    node, and the traction sum_d n_d s_{V[c,d]} with the lane's own
    normals; pad rows zero."""
    dim, npp, ftpp = d.dim, d.npp, d.ftpp
    V = voigt_map(dim)
    E = u_lm.shape[1]
    R = d.drr[dim * npp :]
    tu = torch.matmul(R, u_lm.reshape(dim, npp, E))
    own_s = torch.matmul(R, s_lm.reshape(d.n_sig, npp, E))
    nrm = d.nrm.reshape(dim, ftpp, E)
    tt = torch.stack([sum(nrm[k] * own_s[V[c, k]] for k in range(dim))
                      for c in range(dim)])
    return tu.reshape(dim * ftpp, E), tt.reshape(dim * ftpp, E)


def emitted_selcfg(selcfg):
    """The select plan of panels in the emitted layout, from the plan of
    the gathered ones: per-component ftpp sections, C*ftpp rows a face."""
    C, nf, nfp, _, ftpp, _, face_combos, perms = selcfg
    return (C, nf, nfp, ftpp, ftpp, C * ftpp, face_combos, perms)


def upwind_rhs_lm_sel_axpy_ref(d: LaneOpData, uw, u_lm, s_lm, panels_u,
                               panels_t, combo, sign_u, sign_t, selcfg,
                               acc_u, acc_s, wa, base_u=None, base_s=None,
                               cs=None, inject=None, damp_row=None,
                               emit=False):
    """Plain version of K7 (see upwind_rhs_lm_sel_axpy)."""
    stage = _check_epilogue(base_u, base_s, cs, damp_row)
    dim, npp, n_sig = d.dim, d.npp, d.n_sig
    E = u_lm.shape[1]
    du, ds = _upwind_rows(d, uw, u_lm, s_lm, panels_u, panels_t, combo,
                          sign_u, sign_t, selcfg)
    for s_u, s_s, r_g in inject or ():
        du = du + r_g * s_u.reshape(dim, npp, E)
        ds = ds + r_g * s_s.reshape(n_sig, npp, E)
    du, ds = du.reshape(-1, E), ds.reshape(-1, E)
    new_u, new_s = acc_u + wa * du, acc_s + wa * ds
    if damp_row is not None:
        new_u = (damp_row * new_u.reshape(dim, npp, E)).reshape(-1, E)
        new_s = (damp_row * new_s.reshape(n_sig, npp, E)).reshape(-1, E)
    if stage:
        out = [base_u + cs * du, base_s + cs * ds, new_u, new_s]
    else:
        out = [new_u, new_s]
    if emit:  # own-face panels of the emitted state (out[0], out[1])
        out += own_face_panels(d, out[0], out[1])
    return torch.cat(out)


def _check_epilogue(base_u, base_s, cs, damp_row) -> bool:
    """True for stage mode (base and cs given), False for final mode."""
    stage = base_u is not None
    if (base_s is not None) != stage or (cs is not None) != stage:
        raise ValueError("stage mode takes base_u, base_s and cs together")
    if stage and damp_row is not None:
        raise ValueError("the sponge row folds into final mode only")
    return stage


# ---------------------------------------------------------------------------
# CUDA kernels

LIBRARY = CudaLibrary("seigen_lane_upwind", ("lane_upwind_kernels.cu",))

_P = ctypes.c_void_p


class LaneUpwindArgs(ctypes.Structure):
    """Mirror of ``struct LaneUpwindArgs`` in csrc/lane_upwind_kernels.cu."""

    _fields_ = [(n, _P) for n in (
        "u", "s", "pu", "pt", "combo", "sign_u", "sign_t", "perms", "ginv",
        "nrm", "fsc", "irho", "lam", "mu", "zpn", "zsn", "zown", "base_u",
        "base_s", "acc_u", "acc_s", "damp", "inj_u0", "inj_s0", "inj_u1",
        "inj_s1", "fnodes", "tab", "out")] + [
        ("E", ctypes.c_longlong)] + [(n, ctypes.c_int) for n in (
            "npp", "ftpp", "rows_pad", "cstride", "G", "stage", "n_inj",
            "emit")] + [(n, ctypes.c_float) for n in (
                "cs", "wa", "r0", "r1")]


class LaneUpwindKernel:
    """ctypes binding of K6 (``axpy=False``) or K7 (``axpy=True``), with its
    launch count: ``launches`` grows by one per kernel launch and nowhere
    else."""

    def __init__(self, symbol: str, name: str, axpy: bool):
        self.symbol = symbol
        self.name = name
        self.axpy = axpy
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            lib = LIBRARY.load()
            size = lib.seigen_lane_upwind_args_size()
            if size != ctypes.sizeof(LaneUpwindArgs):
                raise RuntimeError(
                    f"LaneUpwindArgs layout mismatch: C {size} B, ctypes "
                    f"{ctypes.sizeof(LaneUpwindArgs)} B")
            fn = getattr(lib, self.symbol)
            fn.argtypes = [ctypes.POINTER(LaneUpwindArgs), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, _P]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def build(self):
        """Compile/load the library now; returns the build seconds."""
        self._function()
        return LIBRARY.build_seconds

    def __call__(self, d: LaneOpData, uw, u_lm, s_lm, panels_u, panels_t,
                 combo, sign_u, sign_t, selcfg, acc_u=None, acc_s=None,
                 wa=0.0, base_u=None, base_s=None, cs=None, inject=None,
                 damp_row=None, emit=False):
        dev = u_lm.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: the kernel takes CUDA tensors, "
                             f"got {dev}")
        inject = list(inject or ())
        if len(inject) > 2:
            raise ValueError("the kernel takes at most 2 dense source groups")
        stage = self.axpy and _check_epilogue(base_u, base_s, cs, damp_row)
        E, nu, ns = d.E, d.dim * d.npp, d.n_sig * d.npp
        rows_pad, cstride, perm_t = check_select(self.name, d, selcfg, combo)
        zpn, zsn, zown = uw
        checks = [(u_lm, nu), (s_lm, ns), (panels_u, d.nf * rows_pad),
                  (panels_t, d.nf * rows_pad), (sign_u, 8), (sign_t, 8),
                  (d.ginv, d.dim * d.dim), (d.nrm, d.dim * d.ftpp),
                  (d.fsc, d.ftpp), (d.irho, 8), (d.lam, 8), (d.mu, 8),
                  (zpn, d.ftpp), (zsn, d.ftpp), (zown, 8)]
        out_rows = nu + ns
        if self.axpy:
            checks += [(acc_u, nu), (acc_s, ns)]
            if stage:
                checks += [(base_u, nu), (base_s, ns)]
                out_rows *= 2
            if damp_row is not None:
                checks.append((damp_row, d.npp))
            for s_u, s_s, _ in inject:
                checks += [(s_u, nu), (s_s, ns)]
            if emit:
                out_rows += 2 * d.dim * d.ftpp
        check_operands(self.name, dev, E, checks)
        # a fresh output: stage 1 passes one tensor as input, base and acc
        out = torch.empty((out_rows, E), dtype=u_lm.dtype, device=dev)

        def ptr(x):
            return None if x is None else x.data_ptr()

        def inj(g, i):
            return inject[g][i].data_ptr() if len(inject) > g else None

        args = LaneUpwindArgs(
            u=ptr(u_lm), s=ptr(s_lm), pu=ptr(panels_u), pt=ptr(panels_t),
            combo=ptr(combo), sign_u=ptr(sign_u), sign_t=ptr(sign_t),
            perms=ptr(perm_t), ginv=ptr(d.ginv), nrm=ptr(d.nrm),
            fsc=ptr(d.fsc), irho=ptr(d.irho), lam=ptr(d.lam), mu=ptr(d.mu),
            zpn=ptr(zpn), zsn=ptr(zsn), zown=ptr(zown), base_u=ptr(base_u),
            base_s=ptr(base_s), acc_u=ptr(acc_u), acc_s=ptr(acc_s),
            damp=ptr(damp_row), inj_u0=inj(0, 0), inj_s0=inj(0, 1),
            inj_u1=inj(1, 0), inj_s1=inj(1, 1), fnodes=ptr(d.kfn),
            tab=ptr(d.ktile), out=ptr(out),
            E=E, npp=d.npp, ftpp=d.ftpp, rows_pad=rows_pad, cstride=cstride,
            G=perm_t.shape[0], stage=int(stage), n_inj=len(inject),
            emit=int(bool(emit)), cs=float(cs) if stage else 0.0,
            wa=float(wa),
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
        return out


LANE_UPWIND_RHS = LaneUpwindKernel("seigen_lane_upwind_rhs",
                                   "lane_upwind_rhs", axpy=False)
LANE_UPWIND_AXPY = LaneUpwindKernel("seigen_lane_upwind_axpy",
                                    "lane_upwind_axpy", axpy=True)


def upwind_rhs_lm_sel(d: LaneOpData, uw, u_lm, s_lm, panels_u, panels_t,
                      combo, sign_u, sign_t, selcfg):
    """Coupled Godunov RHS on lane-major state, unstructured meshes.

    u_lm (dim*npp, E), s_lm (n_sig*npp, E); ``uw`` = (zpn, zsn, zown)
    impedance rows; panels_u/panels_t (nf*rows_pad, E) raw lane takes;
    combo (8, E) int32; sign_u/sign_t (8, E); selcfg as
    lane_kernels._select_tiles.  Returns stacked ((dim+n_sig)*npp, E) rows
    [du; ds].  CUDA tensors launch K6; CPU tensors run
    upwind_rhs_lm_sel_ref."""
    args = (d, uw, u_lm, s_lm, panels_u, panels_t, combo, sign_u, sign_t,
            selcfg)
    if u_lm.device.type == "cuda":
        return LANE_UPWIND_RHS(*args)
    return upwind_rhs_lm_sel_ref(*args)


def upwind_rhs_lm_sel_axpy(d: LaneOpData, uw, u_lm, s_lm, panels_u, panels_t,
                           combo, sign_u, sign_t, selcfg, acc_u, acc_s, wa,
                           base_u=None, base_s=None, cs=None, inject=None,
                           damp_row=None, emit=False):
    """upwind_rhs_lm_sel with the RK4 stage/accumulator axpys in the
    operator's epilogue.

    Stage mode (base_u, base_s, cs given): returns stacked
    (2*(dim+n_sig)*npp, E) rows [base_u + cs*du; base_s + cs*ds;
    acc_u + wa*du; acc_s + wa*ds].  Final mode: ((dim+n_sig)*npp, E) rows
    [acc_u + wa*du; acc_s + wa*ds], each component times ``damp_row``
    (npp, E) when given.  inject: None or [(Su (dim*npp, E), Ss
    (n_sig*npp, E), r float), ...] (at most 2) dense source groups,
    k += r*S before the epilogue.  emit: append [TU; TT] (dim*ftpp rows
    each), the own-face panels of the emitted state (own_face_panels).
    CUDA tensors launch K7; CPU tensors run upwind_rhs_lm_sel_axpy_ref.
    The output never aliases an input."""
    args = (d, uw, u_lm, s_lm, panels_u, panels_t, combo, sign_u, sign_t,
            selcfg, acc_u, acc_s, wa)
    kw = dict(base_u=base_u, base_s=base_s, cs=cs, inject=inject,
              damp_row=damp_row, emit=emit)
    if u_lm.device.type == "cuda":
        return LANE_UPWIND_AXPY(*args, **kw)
    return upwind_rhs_lm_sel_axpy_ref(*args, **kw)


_OPS = {"upwind_rhs_lm_sel": (upwind_rhs_lm_sel, upwind_rhs_lm_sel_ref),
        "upwind_rhs_lm_sel_axpy": (upwind_rhs_lm_sel_axpy,
                                   upwind_rhs_lm_sel_axpy_ref)}


def lane_upwind_op(name: str, impl: str):
    """Operator ``name`` for a runner's impl: the public operator (which
    launches the kernel on CUDA tensors) for "kernel", its plain version
    for "reference"."""
    return _OPS[name][0 if impl == "kernel" else 1]
