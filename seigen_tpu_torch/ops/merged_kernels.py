"""Merged exchange-in-kernel LF operators — plan, CUDA kernels, plain twins.

Port of ``seigen_tpu/ops/merged_kernels.py`` (the v3 lane pipeline).  Each
operator consumes the PRODUCER face-major trace array of its input directly:
per (class t, face f) the neighbour trace sits in class t2 at the flat lane
shift s, rows f2*rtf + c*n_fp + pi[k]; traction rows flip sign, velocity
rows do not; boundary faces select the own-side trace.  Consumer-ordered
traces never exist in device memory.

Layout (both the plain version and the kernel):
  state arrays (C*npp, Ls), Ls = m*NC — class-major lanes, no padding;
  trace arrays (nf*rtf, Ls), face-major rows f*rtf + c*n_fp + k, rows
  dim*n_fp..rtf of each face block are zero.
This is the JAX package's layout whenever its lane block divides NC, so
the arrays compare row for row (tests/test_torch_merged_ops.py).

``vel_merged``/``stress_merged`` launch the CUDA kernels
(csrc/merged_kernels.cu) for CUDA tensors and run the plain PyTorch
versions ``vel_merged_ref``/``stress_merged_ref`` for CPU tensors.  Each
kernel keeps a launch count (``VEL_KERNEL.launches``,
``STRESS_KERNEL.launches``; ``launches_c`` counts those of them that ran
the general Hooke law of a ``C`` section, see ops/fused_kernels.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .anisotropic import _voigt_strain_pair
from .cuda_build import CudaLibrary
from .elastic import voigt_map
from .fused_kernels import FusedOpData, _rup
from .structured_exchange import StructuredExchange


@dataclass(frozen=True)
class MergedPlan:
    """Static exchange plan of the merged operators (device tensors).

    Per (class t, face f): producer class t2, producer face f2, node
    permutation pi and flat lane shift s.  ``table`` packs them for the
    kernel as (m, nf, 3 + n_fp) int32 rows [t2, f2, s, pi...];
    ``gather`` is the plain version's flat index of the component-0
    neighbour trace of every (face node, lane), its lane clamped into the
    producer class (boundary faces never use it).
    """

    m: int
    nf: int
    n_fp: int
    NC: int
    pay: int  # payload components per face (LF: dim; upwind: 2*dim)
    rtf: int  # trace rows per face = roundup(pay*n_fp, 8)
    table: torch.Tensor  # (m, nf, 3 + n_fp) int32
    gather: torch.Tensor  # (nf*n_fp, Ls) int64 into the flat trace array
    dr: torch.Tensor  # (dim, n_p, n_p) kernel tables, float32
    lift: torch.Tensor  # (n_p, nf*n_fp)
    fnodes: torch.Tensor  # (nf, n_fp) int32

    @property
    def Ls(self):
        return self.m * self.NC


def build_merged_plan(ex: StructuredExchange, d: FusedOpData,
                      pay: int | None = None) -> MergedPlan | None:
    """The merged-operator plan, or None when the mesh's neighbour lanes
    are not a fixed flat shift per (class, face) (periodic meshes, ambiguous
    wrap shifts).  ``pay``: trace payload components per face (default
    d.dim, the LF operators; the upwind Riemann operator carries 2*dim,
    velocity AND traction rows)."""
    from ..solver.lane_fused import _canonical_shift, _flat_strides, \
        derive_pairing

    if ex.self_mask.size and not ex.self_mask.any():
        return None  # periodic: wrap planes are not boundary-masked
    m, nf, nfp = ex.m, ex.n_faces, ex.n_fp
    NC = int(np.prod(ex.grid))
    Ls = m * NC
    pay = d.dim if pay is None else pay
    rtf = _rup(pay * nfp, 8)
    strides = _flat_strides(ex.grid)

    f2, pi = derive_pairing(ex)
    t2 = np.asarray(ex.nbr_class, dtype=np.int64)
    shift = np.zeros((m, nf), dtype=np.int64)
    for t in range(m):
        for f in range(nf):
            off = _canonical_shift(ex, t, f)
            if off is None:
                return None
            shift[t, f] = int(np.dot(off, strides))

    table = np.concatenate(
        [t2[..., None], f2[..., None], shift[..., None], pi], axis=2)
    j = np.arange(NC)
    gather = np.zeros((nf, nfp, Ls), dtype=np.int64)
    for t in range(m):
        for f in range(nf):
            lane = t2[t, f] * NC + np.clip(j + shift[t, f], 0, NC - 1)
            row = f2[t, f] * rtf + pi[t, f]
            gather[f, :, t * NC : (t + 1) * NC] = (
                row[:, None] * Ls + lane[None, :])
    dev = d.geo.device
    n_p = d.n_p
    dr = d.drr[: d.dim * d.npp].reshape(d.dim, d.npp, d.npp)[:, :n_p, :n_p]
    return MergedPlan(
        m=m, nf=nf, n_fp=nfp, NC=NC, pay=pay, rtf=rtf,
        table=torch.as_tensor(table, device=dev).to(torch.int32).contiguous(),
        gather=torch.as_tensor(gather.reshape(nf * nfp, Ls), device=dev),
        dr=dr.to(torch.float32).contiguous(),
        lift=d.lift[:n_p, : d.ftp].to(torch.float32).contiguous(),
        fnodes=torch.as_tensor(np.array(d.fnodes), device=dev).to(
            torch.int32).contiguous(),
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _face_rows(d: FusedOpData, geo, off):
    """(ftp, Ls) face-node expansion of a per-face geo section."""
    rep = torch.arange(d.nf, device=geo.device).repeat_interleave(d.n_fp)
    return geo[off + rep]


def _own_mask(d: FusedOpData, mask):
    return _face_rows(d, mask, 0) != 0.0


def _neighbour(plan: MergedPlan, trs, signs, own, sel):
    """Consumer-ordered neighbour traces (C, ftp, Ls) of payload components
    0..C-1: signs[c] * producer rows at the neighbour lanes; own rows where
    ``sel`` (boundary)."""
    flat = trs.reshape(-1)
    nb = torch.stack([signs[c] * flat[plan.gather + c * plan.n_fp * plan.Ls]
                      for c in range(own.shape[0])])
    return torch.where(sel, own, nb)


def _restrict(d: FusedOpData, x):
    """(C, npp, Ls) -> own face-node values (C, ftp, Ls)."""
    R = d.drr[d.dim * d.npp : d.dim * d.npp + d.ftp]
    return torch.matmul(R, x)


def _emit(plan: MergedPlan, d: FusedOpData, tr):
    """(C, ftp, L) component traces -> (nf*rtf, L) face-major rows
    f*rtf + c*n_fp + k, pad rows 0 (C <= plan.pay)."""
    C, Ls = tr.shape[0], tr.shape[-1]
    out = torch.zeros((plan.nf, plan.rtf, Ls), dtype=tr.dtype,
                      device=tr.device)
    blk = tr.reshape(C, d.nf, d.n_fp, Ls).transpose(0, 1)
    out[:, : C * d.n_fp] = blk.reshape(d.nf, C * d.n_fp, Ls)
    return out.reshape(plan.nf * plan.rtf, Ls)


def _epilogue(res, axpy, dt, c3, damp, inject, C, npp):
    """axpy / damp / inject on (C, npp, Ls) operator output."""
    if axpy is not None:
        u, uh1 = (x.reshape(C, npp, -1) for x in axpy)
        res = u + dt * uh1 + c3 * res
        if damp is not None:
            res = damp * res
    for s_g, r_g in inject or ():
        res = res + r_g * s_g.reshape(C, npp, -1)
    return res


def _derivs(d: FusedOpData, x):
    """(C, npp, Ls) -> reference derivatives (dim, C, npp, Ls)."""
    Dr = d.drr[: d.dim * d.npp].reshape(d.dim, 1, d.npp, d.npp)
    return torch.matmul(Dr, x[None])


def vel_merged_ref(plan: MergedPlan, d: FusedOpData, sig_lm, trs, mask,
                   axpy=None, dt=0.0, c3=0.0, inject=None):
    """Plain version of K1 (see vel_merged)."""
    dim, npp, Ls = d.dim, d.npp, sig_lm.shape[1]
    V = voigt_map(dim)
    o_ginv, o_nrm, o_scb, o_bfs, _, o_mat = d.off[:6]
    geo = d.geo
    S = sig_lm.reshape(d.n_sig, npp, Ls)
    der = _derivs(d, S)
    own = _restrict(d, S)
    nrm = [_face_rows(d, geo, o_nrm + 8 * k) for k in range(dim)]
    scb, bfs = _face_rows(d, geo, o_scb), _face_rows(d, geo, o_bfs)
    t_own = torch.stack([sum(nrm[k] * own[V[c, k]] for k in range(dim))
                         for c in range(dim)])
    t_nb = _neighbour(plan, trs, (-1.0,) * dim, t_own, _own_mask(d, mask))
    flux = scb * t_nb + bfs * t_own
    surf = torch.matmul(d.lift[:, : d.ftp], flux)  # (dim, npp, Ls)
    div = torch.stack([
        sum(geo[o_ginv + r * dim + k] * der[r, V[c, k]]
            for k in range(dim) for r in range(dim))
        for c in range(dim)])
    res = geo[o_mat] * (div + surf)
    res = _epilogue(res, axpy, dt, c3, None, inject, dim, npp)
    tr = _restrict(d, res)
    return res.reshape(dim * npp, Ls), _emit(plan, d, tr)


def _hooke(dim, lam, mu, gd):
    """gd(c, d) -> Voigt rows of lam tr(e) I + 2 mu sym(e), a list."""
    tr = sum(gd(k, k) for k in range(dim))
    comps = [lam * tr + 2.0 * mu * gd(c, c) for c in range(dim)]
    if dim == 2:
        comps.append(mu * (gd(0, 1) + gd(1, 0)))
    else:
        comps.append(mu * (gd(1, 2) + gd(2, 1)))
        comps.append(mu * (gd(0, 2) + gd(2, 0)))
        comps.append(mu * (gd(0, 1) + gd(1, 0)))
    return comps


def _voigt_hooke(dim, crow, gd):
    """gd(c, d) -> Voigt rows of C : sym(e) with engineering strains:
    row k = sum_m crow(k, m) eps_m, eps_m = sum of gd(i, j) over the
    (component i, direction j) pairs of Voigt slot m."""
    eps = [sum(gd(i, j) for (i, j) in slot)
           for slot in _voigt_strain_pair(dim)]
    return [sum(crow(k, m) * e for m, e in enumerate(eps))
            for k in range(len(eps))]


def hooke_rows(dim, lam, mu, cmat, gd):
    """Voigt rows of the stress of gd(c, d): the general law over the
    8-row sections of ``cmat`` (row c*8 + k = C[c, k]) when it is given,
    else the isotropic (lam, mu) one."""
    if cmat is None:
        return _hooke(dim, lam, mu, gd)
    return _voigt_hooke(dim, lambda c, k: cmat[c * 8 + k], gd)


def stress_merged_ref(plan: MergedPlan, d: FusedOpData, u_lm, trs, mask,
                      axpy=None, dt=0.0, c3=0.0, inject=None):
    """Plain version of K2 (see stress_merged)."""
    dim, npp, Ls = d.dim, d.npp, u_lm.shape[1]
    V = voigt_map(dim)
    o_ginv, o_nrm, o_scb, _, o_dfs, o_mat = d.off[:6]
    geo = d.geo
    U = u_lm.reshape(dim, npp, Ls)
    der = _derivs(d, U)
    own = _restrict(d, U)
    nrm = [_face_rows(d, geo, o_nrm + 8 * k) for k in range(dim)]
    scb, dfs = _face_rows(d, geo, o_scb), _face_rows(d, geo, o_dfs)
    lam, mu = geo[o_mat + 1], geo[o_mat + 2]
    o_C = d.off[6]
    cmat = geo[o_C : o_C + 8 * d.n_sig] if o_C >= 0 else None

    def grad(k, c):  # d u_c / d x_k
        return sum(geo[o_ginv + r * dim + k] * der[r, c] for r in range(dim))

    vol = torch.stack(hooke_rows(dim, lam, mu, cmat,
                                 lambda c, k: grad(k, c)))
    u_nb = _neighbour(plan, trs, (1.0,) * dim, own, _own_mask(d, mask))
    jump = scb * u_nb + dfs * own
    face = torch.stack(hooke_rows(dim, lam, mu, cmat,
                                  lambda c, k: nrm[k] * jump[c]))
    res = vol + torch.matmul(d.lift[:, : d.ftp], face)
    damp = d.damp if axpy is not None else None
    res = _epilogue(res, axpy, dt, c3, damp, inject, d.n_sig, npp)
    tr_sig = _restrict(d, res)
    tr = torch.stack([sum(nrm[k] * tr_sig[V[c, k]] for k in range(dim))
                      for c in range(dim)])
    return res.reshape(d.n_sig * npp, Ls), _emit(plan, d, tr)


# ---------------------------------------------------------------------------
# CUDA kernels

LIBRARY = CudaLibrary("seigen_merged", ("merged_kernels.cu",))

_P = ctypes.c_void_p


class MergedArgs(ctypes.Structure):
    """Mirror of ``struct MergedArgs`` in csrc/merged_kernels.cu."""

    _fields_ = [(n, _P) for n in (
        "field", "trs", "geo", "mask", "ax0", "ax1", "damp", "inj0", "inj1",
        "plan", "dr", "lift", "fnodes", "out", "trout")] + [
        ("Ls", ctypes.c_longlong)] + [(n, ctypes.c_int) for n in (
            "NC", "npp", "rtf", "o_ginv", "o_nrm", "o_scb", "o_bfs", "o_dfs",
            "o_mat", "o_C", "axpy", "n_inj")] + [(n, ctypes.c_float) for n in (
                "dt", "c3", "r0", "r1")]


def check_operands(name, dev, Ls, checks):
    """Raise unless every (tensor, rows) operand is a contiguous float32
    (rows, Ls) tensor on dev (rows None: any row count)."""
    for x, rows in checks:
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name}: expects float32 tensors on {dev}, "
                             f"got {x.dtype} on {x.device}")
        if not x.is_contiguous() or x.dim() != 2 or x.shape[1] != Ls \
                or (rows is not None and x.shape[0] != rows):
            raise ValueError(f"{name}: bad operand {tuple(x.shape)}")


class MergedKernel:
    """ctypes binding of one merged operator kernel, with its launch
    counts: ``launches`` grows by one per kernel launch and nowhere else;
    ``launches_c`` counts the launches among them that ran the general
    Hooke law (K2 on operator data with a ``C`` section)."""

    def __init__(self, symbol: str, name: str):
        self.symbol = symbol
        self.name = name
        self.launches = 0
        self.launches_c = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            lib = LIBRARY.load()
            size = lib.seigen_merged_args_size()
            if size != ctypes.sizeof(MergedArgs):
                raise RuntimeError(
                    f"MergedArgs layout mismatch: C {size} B, ctypes "
                    f"{ctypes.sizeof(MergedArgs)} B")
            fn = getattr(lib, self.symbol)
            fn.argtypes = [ctypes.POINTER(MergedArgs), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, _P]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def build(self):
        """Compile/load the library now; returns the build seconds."""
        self._function()
        return LIBRARY.build_seconds

    def __call__(self, plan: MergedPlan, d: FusedOpData, field, trs, mask,
                 axpy=None, damp=None, dt=0.0, c3=0.0, inject=None):
        inject = list(inject or ())
        if len(inject) > 2:
            raise ValueError("the kernels take at most 2 dense source groups")
        dev = field.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: the kernel takes CUDA tensors, "
                             f"got {dev}")
        Ls = plan.Ls
        C_in, C_out = ((d.n_sig, d.dim) if self.name == "merged_vel"
                       else (d.dim, d.n_sig))
        checks = [(field, C_in * d.npp), (trs, plan.nf * plan.rtf),
                  (d.geo, None), (mask, 8)]
        checks += [(x, C_out * d.npp) for x in (axpy or ())]
        checks += [(damp, d.npp)] if damp is not None else []
        checks += [(s_g, C_out * d.npp) for s_g, _ in inject]
        check_operands(self.name, dev, Ls, checks)
        o = d.off
        # the C section switches K2 to the general Hooke law; K1 has no
        # material law and ignores it
        o_C = o[6] if self.name == "merged_stress" else -1
        if o_C >= 0 and o_C + 8 * d.n_sig > d.geo.shape[0]:
            raise ValueError(f"{self.name}: geo has {d.geo.shape[0]} rows, "
                             f"its C section needs {o_C + 8 * d.n_sig}")
        out = torch.empty((C_out * d.npp, Ls), dtype=field.dtype, device=dev)
        trout = torch.empty((plan.nf * plan.rtf, Ls), dtype=field.dtype,
                            device=dev)
        ptr = (lambda x: None if x is None else x.data_ptr())
        args = MergedArgs(
            field=ptr(field), trs=ptr(trs), geo=ptr(d.geo), mask=ptr(mask),
            ax0=ptr(axpy[0]) if axpy else None,
            ax1=ptr(axpy[1]) if axpy else None,
            damp=ptr(damp),
            inj0=ptr(inject[0][0]) if len(inject) > 0 else None,
            inj1=ptr(inject[1][0]) if len(inject) > 1 else None,
            plan=ptr(plan.table), dr=ptr(plan.dr), lift=ptr(plan.lift),
            fnodes=ptr(plan.fnodes), out=ptr(out), trout=ptr(trout),
            Ls=Ls, NC=plan.NC, npp=d.npp, rtf=plan.rtf, o_ginv=o[0],
            o_nrm=o[1], o_scb=o[2], o_bfs=o[3], o_dfs=o[4], o_mat=o[5],
            o_C=o_C, axpy=int(axpy is not None), n_inj=len(inject),
            dt=float(dt), c3=float(c3),
            r0=float(inject[0][1]) if len(inject) > 0 else 0.0,
            r1=float(inject[1][1]) if len(inject) > 1 else 0.0,
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = self._function()(ctypes.byref(args), d.dim, d.n_p, d.n_fp,
                               stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: " + (
                f"no instantiation for dim={d.dim} n_p={d.n_p}" if err == -1
                else f"cudaError {err}"))
        self.launches += 1
        self.launches_c += int(o_C >= 0)
        return out, trout


VEL_KERNEL = MergedKernel("seigen_merged_vel", "merged_vel")
STRESS_KERNEL = MergedKernel("seigen_merged_stress", "merged_stress")


def _on_cuda(x):
    return x.device.type == "cuda"


def vel_merged(plan: MergedPlan, d: FusedOpData, sig_lm, trs, mask,
               axpy=None, dt=0.0, c3=0.0, inject=None):
    """Merged velocity operator (K1): consumes the PRODUCER traction trace
    array trs ((nf*rtf, Ls), face-major) directly, state sig_lm
    (n_sig*npp, Ls).  Returns (out (dim*npp, Ls), traces (nf*rtf, Ls)).

    axpy: None or (u, uh1) -> out = u + dt*uh1 + c3*du.
    inject: None or [(S_g (dim*npp, Ls), r_g float), ...] (at most 2) —
    kernel-fused point-source groups: out += r_g*S_g, with the emitted
    traces including the source (plain ops only).

    CUDA tensors launch K1; CPU tensors run vel_merged_ref.
    """
    if axpy is not None and inject:
        raise ValueError("inject is plain-op only")
    if _on_cuda(sig_lm):
        return VEL_KERNEL(plan, d, sig_lm, trs, mask, axpy=axpy, dt=dt,
                          c3=c3, inject=inject)
    return vel_merged_ref(plan, d, sig_lm, trs, mask, axpy=axpy, dt=dt,
                          c3=c3, inject=inject)


def stress_merged(plan: MergedPlan, d: FusedOpData, u_lm, trs, mask,
                  axpy=None, dt=0.0, c3=0.0, inject=None):
    """Merged stress operator (K2): consumes PRODUCER velocity traces trs;
    axpy (s, sh1) additionally folds d.damp: out = damp*(s + dt*sh1 +
    c3*ds).  Emits traction traces.  inject: see vel_merged (S_g has
    n_sig*npp rows here).  Operator data built with ``stiffness``
    (d.off[6] >= 0) takes the general Hooke law over its ``C`` rows
    instead of the isotropic (lambda, mu) one.

    CUDA tensors launch K2; CPU tensors run stress_merged_ref.
    """
    if axpy is not None and inject:
        raise ValueError("inject is plain-op only")
    if _on_cuda(u_lm):
        damp = d.damp if axpy is not None else None
        return STRESS_KERNEL(plan, d, u_lm, trs, mask, axpy=axpy,
                             damp=damp, dt=dt, c3=c3, inject=inject)
    return stress_merged_ref(plan, d, u_lm, trs, mask, axpy=axpy, dt=dt,
                             c3=c3, inject=inject)
