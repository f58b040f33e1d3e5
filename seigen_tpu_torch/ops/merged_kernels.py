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
The packed P1 layout (operator data with n_par = 2, ops/fused_kernels.py)
pairs the original classes (2u, 2u+1) onto packed class u, so Ls =
(m/2)*NC: state rows c*npp + par*4 + i, and each face block of the traces
splits into two parity blocks of rtq rows, f*rtf + par*rtq + c*n_fp + k
(rtf = 2*rtq).
This is the JAX package's layout whenever its lane block divides NC, so
the arrays compare row for row (tests/test_torch_merged_ops.py,
tests/test_torch_packed.py).

``vel_merged``/``stress_merged`` launch the CUDA kernels
(csrc/merged_kernels.cu) for CUDA tensors and run the plain PyTorch
versions ``vel_merged_ref``/``stress_merged_ref`` for CPU tensors.  Each
kernel keeps a launch count (``VEL_KERNEL.launches``,
``STRESS_KERNEL.launches``; ``launches_c`` counts those of them that ran
the general Hooke law of a ``C`` section, see ops/fused_kernels.py, and
``launches_pk`` those that ran the packed P1 layout).

The physics is written once, in ``vel_body``/``stress_body``, as in the
JAX package (``_vel2_body``/``_stress2_body`` behind both its merged and
its v2 kernels): a body takes the source of the neighbour traces and the
layout of the traces it emits as functions.  The merged operators read
the producer face-major rows through the plan and emit face-major rows;
the v2 operators (ops/fused_ops.py) read exchanged consumer-order rows and
emit component-major rows.
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

    Per ORIGINAL class t and face f: producer class t2, producer face f2,
    node permutation pi and flat lane shift s.  ``table`` packs them for
    the kernel as (n_par*m, nf, 3 + n_fp) int32 rows [t2, f2, s, pi...];
    ``gather`` is the plain version's flat index of the component-0
    neighbour trace of every consumer face-node row and lane, its lane
    clamped into the producer class (boundary faces never use it).  The
    kernels' element tables are the operator data's
    (``FusedOpData.tables``).

    Packed (n_par = 2): lanes hold packed classes u = t // 2, and the
    consumer of original class t = 2u + par reads its producer t2 at lane
    (t2 // 2)*NC + j + s, rows f2*rtf + (t2 % 2)*rtq + c*n_fp + pi[k].
    """

    m: int  # classes on the lanes (packed: pairs of original classes)
    nf: int
    n_fp: int
    NC: int
    pay: int  # payload components per face (LF: dim; upwind: 2*dim)
    rtf: int  # trace rows per face = n_par * rtq
    rtq: int  # rows of one parity's face block, roundup(pay*n_fp, 8)
    n_par: int  # elements per lane
    table: torch.Tensor  # (n_par*m, nf, 3 + n_fp) int32
    gather: torch.Tensor  # (ftp, Ls) int64 into the flat trace array

    @property
    def Ls(self):
        return self.m * self.NC


def build_merged_plan(ex: StructuredExchange, d: FusedOpData,
                      pay: int | None = None,
                      n_par: int = 1) -> MergedPlan | None:
    """The merged-operator plan, or None when the mesh's neighbour lanes
    are not a fixed flat shift per (class, face) (periodic meshes, ambiguous
    wrap shifts) or, with ``n_par`` = 2 (the packed P1 layout), when the
    class count is odd.  ``pay``: trace payload components per face
    (default d.dim, the LF operators; the upwind Riemann operator carries
    2*dim, velocity AND traction rows)."""
    from ..solver.lane_fused import _canonical_shift, _flat_strides, \
        derive_pairing

    if ex.self_mask.size and not ex.self_mask.any():
        return None  # periodic: wrap planes are not boundary-masked
    if ex.m % n_par:
        return None
    nf, nfp = ex.n_faces, ex.n_fp
    m = ex.m // n_par
    NC = int(np.prod(ex.grid))
    Ls = m * NC
    pay = d.dim if pay is None else pay
    rtq = _rup(pay * nfp, 8)
    rtf = n_par * rtq
    strides = _flat_strides(ex.grid)

    f2, pi = derive_pairing(ex)
    t2 = np.asarray(ex.nbr_class, dtype=np.int64)
    shift = np.zeros((ex.m, nf), dtype=np.int64)
    for t in range(ex.m):
        for f in range(nf):
            off = _canonical_shift(ex, t, f)
            if off is None:
                return None
            shift[t, f] = int(np.dot(off, strides))

    table = np.concatenate(
        [t2[..., None], f2[..., None], shift[..., None], pi], axis=2)
    j = np.arange(NC)
    gather = np.zeros((n_par, nf, nfp, Ls), dtype=np.int64)
    for t in range(ex.m):
        u, par = divmod(t, n_par)
        for f in range(nf):
            tn = t2[t, f]
            lane = (tn // n_par) * NC + np.clip(j + shift[t, f], 0, NC - 1)
            row = f2[t, f] * rtf + (tn % n_par) * rtq + pi[t, f]
            gather[par, f, :, u * NC : (u + 1) * NC] = (
                row[:, None] * Ls + lane[None, :])
    dev = d.geo.device
    return MergedPlan(
        m=m, nf=nf, n_fp=nfp, NC=NC, pay=pay, rtf=rtf, rtq=rtq, n_par=n_par,
        table=torch.as_tensor(table, device=dev).to(torch.int32).contiguous(),
        gather=torch.as_tensor(gather.reshape(n_par * nf * nfp, Ls),
                               device=dev),
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _face_index(d: FusedOpData, device):
    """The 8-row section row of each face-node row par*ftq + f*n_fp + k:
    par*4 + f."""
    f = torch.arange(d.nf, device=device).repeat_interleave(d.n_fp)
    return torch.cat([par * 4 + f for par in range(d.n_par)])


def _face_rows(d: FusedOpData, geo, off):
    """(ftp, Ls) face-node expansion of a per-face geo section."""
    return geo[off + _face_index(d, geo.device)]


def _geo_rows(d: FusedOpData, geo):
    """Per-lane geometry and material operands of the operators: (g(r, k)
    the Ginv entry, irho, lam, mu as node rows, lam_f, mu_f as face-node
    rows).  Unpacked they are geo rows broadcast over the rows; packed
    (n_par = 2) each is expanded to per-row (npp or ftp, Ls) operands by
    the one-hot ``gexp`` product over the compact ginv and mat rows (the
    JAX package's ``fused_kernels.py:_geo_rows``)."""
    dim, npp = d.dim, d.npp
    o_ginv, o_mat = d.off[0], d.off[5]
    if d.gexp is None:
        lam, mu = geo[o_mat + 1], geo[o_mat + 2]
        return (lambda r, k: geo[o_ginv + r * dim + k], geo[o_mat], lam, mu,
                lam, mu)
    gci = _rup(2 * dim * dim)
    gm = torch.matmul(d.gexp, torch.cat(
        [geo[o_ginv : o_ginv + gci], geo[o_mat : o_mat + 8]]))
    G = dim * dim * npp
    f0 = G + 3 * npp
    return (lambda r, k: gm[(r * dim + k) * npp : (r * dim + k + 1) * npp],
            gm[G : G + npp], gm[G + npp : G + 2 * npp],
            gm[G + 2 * npp : f0], gm[f0 : f0 + d.ftp],
            gm[f0 + d.ftpp : f0 + d.ftpp + d.ftp])


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
    f*rtf + par*rtq + c*n_fp + k, pad rows 0 (C <= plan.pay)."""
    C, Ls = tr.shape[0], tr.shape[-1]
    n_par, nf, nfp = plan.n_par, d.nf, d.n_fp
    out = torch.zeros((nf, n_par, plan.rtq, Ls), dtype=tr.dtype,
                      device=tr.device)
    blk = tr.reshape(C, n_par, nf, nfp, Ls).permute(2, 1, 0, 3, 4)
    out[:, :, : C * nfp] = blk.reshape(nf, n_par, C * nfp, Ls)
    return out.reshape(nf * plan.rtf, Ls)


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


def vel_body(d: FusedOpData, sig_lm, neighbour, emit, axpy=None, dt=0.0,
             c3=0.0, inject=None):
    """The plain velocity operator of K1 and K8:
    du_c = (1/rho) (div(sigma)_c + LIFT(scb*t+_c + bfs*t-_c)).

    neighbour(t_own) -> (dim, ftp, Ls) signed neighbour tractions t+ (t_own
    on boundary faces); emit(traces (dim, ftp, Ls)) -> the trace array the
    operator returns.  axpy / inject: see vel_merged."""
    dim, npp, Ls = d.dim, d.npp, sig_lm.shape[1]
    V = voigt_map(dim)
    o_nrm, o_scb, o_bfs = d.off[1:4]
    geo = d.geo
    g, irho = _geo_rows(d, geo)[:2]
    S = sig_lm.reshape(d.n_sig, npp, Ls)
    der = _derivs(d, S)
    own = _restrict(d, S)
    nrm = [_face_rows(d, geo, o_nrm + 8 * k) for k in range(dim)]
    scb, bfs = _face_rows(d, geo, o_scb), _face_rows(d, geo, o_bfs)
    t_own = torch.stack([sum(nrm[k] * own[V[c, k]] for k in range(dim))
                         for c in range(dim)])
    flux = scb * neighbour(t_own) + bfs * t_own
    surf = torch.matmul(d.lift[:, : d.ftp], flux)  # (dim, npp, Ls)
    div = torch.stack([
        sum(g(r, k) * der[r, V[c, k]] for k in range(dim) for r in range(dim))
        for c in range(dim)])
    res = irho * (div + surf)
    res = _epilogue(res, axpy, dt, c3, None, inject, dim, npp)
    return res.reshape(dim * npp, Ls), emit(_restrict(d, res))


def vel_merged_ref(plan: MergedPlan, d: FusedOpData, sig_lm, trs, mask,
                   axpy=None, dt=0.0, c3=0.0, inject=None):
    """Plain version of K1 (see vel_merged)."""
    sel = _own_mask(d, mask)
    return vel_body(
        d, sig_lm,
        lambda t_own: _neighbour(plan, trs, (-1.0,) * d.dim, t_own, sel),
        lambda tr: _emit(plan, d, tr), axpy, dt, c3, inject)


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


def stress_body(d: FusedOpData, u_lm, neighbour, emit, axpy=None, dt=0.0,
                c3=0.0, inject=None):
    """The plain stress operator of K2 and K9: ds = Hooke(grad u) +
    LIFT(Hooke_face(n (x) (scb*u+ + dfs*u-))), the Hooke law isotropic or
    general over the ``C`` rows of d.geo; emits the TRACTION traces
    n . sigma of its output.

    neighbour(u_own) -> (dim, ftp, Ls) neighbour velocity traces u+ (u_own
    on boundary faces); emit: see vel_body.  axpy also folds d.damp:
    out = damp*(s + dt*sh1 + c3*ds)."""
    dim, npp, Ls = d.dim, d.npp, u_lm.shape[1]
    V = voigt_map(dim)
    o_nrm, o_scb, _, o_dfs = d.off[1:5]
    geo = d.geo
    U = u_lm.reshape(dim, npp, Ls)
    der = _derivs(d, U)
    own = _restrict(d, U)
    nrm = [_face_rows(d, geo, o_nrm + 8 * k) for k in range(dim)]
    scb, dfs = _face_rows(d, geo, o_scb), _face_rows(d, geo, o_dfs)
    g, _, lam, mu, lam_f, mu_f = _geo_rows(d, geo)
    o_C = d.off[6]
    cmat = geo[o_C : o_C + 8 * d.n_sig] if o_C >= 0 else None

    def grad(k, c):  # d u_c / d x_k
        return sum(g(r, k) * der[r, c] for r in range(dim))

    vol = torch.stack(hooke_rows(dim, lam, mu, cmat,
                                 lambda c, k: grad(k, c)))
    jump = scb * neighbour(own) + dfs * own
    face = torch.stack(hooke_rows(dim, lam_f, mu_f, cmat,
                                  lambda c, k: nrm[k] * jump[c]))
    res = vol + torch.matmul(d.lift[:, : d.ftp], face)
    damp = d.damp if axpy is not None else None
    res = _epilogue(res, axpy, dt, c3, damp, inject, d.n_sig, npp)
    tr_sig = _restrict(d, res)
    tr = torch.stack([sum(nrm[k] * tr_sig[V[c, k]] for k in range(dim))
                      for c in range(dim)])
    return res.reshape(d.n_sig * npp, Ls), emit(tr)


def stress_merged_ref(plan: MergedPlan, d: FusedOpData, u_lm, trs, mask,
                      axpy=None, dt=0.0, c3=0.0, inject=None):
    """Plain version of K2 (see stress_merged)."""
    sel = _own_mask(d, mask)
    return stress_body(
        d, u_lm,
        lambda own: _neighbour(plan, trs, (1.0,) * d.dim, own, sel),
        lambda tr: _emit(plan, d, tr), axpy, dt, c3, inject)


# ---------------------------------------------------------------------------
# CUDA kernels

LIBRARY = CudaLibrary("seigen_merged", ("merged_kernels.cu",))

_P = ctypes.c_void_p


class MergedArgs(ctypes.Structure):
    """Mirror of ``struct MergedArgs`` in csrc/merged_kernels.cu."""

    _fields_ = [(n, _P) for n in (
        "field", "trs", "geo", "mask", "ax0", "ax1", "damp", "inj0", "inj1",
        "plan", "fnodes", "tab", "out", "trout")] + [
        ("Ls", ctypes.c_longlong)] + [(n, ctypes.c_int) for n in (
            "NC", "npp", "rtf", "rtq", "n_par", "irho_par", "o_ginv",
            "o_nrm", "o_scb", "o_bfs", "o_dfs", "o_mat", "o_C", "axpy",
            "n_inj")] + [(n, ctypes.c_float) for n in (
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
    """ctypes binding of one operator kernel of csrc/merged_kernels.cu,
    with its launch counts: ``launches`` grows by one per kernel launch and
    nowhere else; ``launches_c`` counts the launches among them that ran
    the general Hooke law (a stress operator on operator data with a ``C``
    section), ``launches_pk`` those that ran the packed P1 instantiation
    (operator data with n_par = 2).  Calling it launches a merged operator
    (K1/K2) on the producer trace array of its plan; ops/fused_ops.py
    binds the v2 operators (K8/K9) through ``launch``."""

    def __init__(self, symbol: str, name: str, vel: bool):
        self.symbol = symbol
        self.name = name
        self.vel = vel
        self.launches = 0
        self.launches_c = 0
        self.launches_pk = 0
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
        return self.launch(d, field, trs, plan.nf * plan.rtf, plan.rtf,
                           plan=plan, mask=mask, axpy=axpy, damp=damp, dt=dt,
                           c3=c3, inject=inject)

    def launch(self, d: FusedOpData, field, trs, tr_rows, rtf, plan=None,
               mask=None, axpy=None, damp=None, dt=0.0, c3=0.0, inject=None,
               irho_par=1):
        """Check the operands and launch: traces in and out have tr_rows
        rows, ``rtf`` is the kernel's row stride of a trace block (merged:
        rows per face; v2: rows per component); ``plan`` and ``mask`` only
        for the merged layout.  ``irho_par``: the row distance of the two
        parities' 1/rho rows in the packed layout (FusedOpData: 1, the P1
        pack probe's geo: 4)."""
        inject = list(inject or ())
        if len(inject) > 2:
            raise ValueError("the kernels take at most 2 dense source groups")
        dev = field.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: the kernel takes CUDA tensors, "
                             f"got {dev}")
        Ls = field.shape[-1]
        if plan is not None and (Ls, d.n_par) != (plan.Ls, plan.n_par):
            raise ValueError(f"{self.name}: {Ls} lanes of {d.n_par} "
                             f"element(s), the plan has {plan.Ls} of "
                             f"{plan.n_par}")
        C_in, C_out = (d.n_sig, d.dim) if self.vel else (d.dim, d.n_sig)
        checks = [(field, C_in * d.npp), (trs, tr_rows), (d.geo, None)]
        checks += [(mask, 8)] if plan is not None else []
        checks += [(x, C_out * d.npp) for x in (axpy or ())]
        checks += [(damp, d.npp)] if damp is not None else []
        checks += [(s_g, C_out * d.npp) for s_g, _ in inject]
        check_operands(self.name, dev, Ls, checks)
        o = d.off
        # the C section switches a stress kernel to the general Hooke law;
        # the velocity kernels have no material law and ignore it
        o_C = -1 if self.vel else o[6]
        if o_C >= 0 and o_C + 8 * d.n_sig > d.geo.shape[0]:
            raise ValueError(f"{self.name}: geo has {d.geo.shape[0]} rows, "
                             f"its C section needs {o_C + 8 * d.n_sig}")
        if o_C >= 0 and d.n_par != 1:
            raise ValueError(f"{self.name}: the packed layout is isotropic "
                             "only")
        out = torch.empty((C_out * d.npp, Ls), dtype=field.dtype, device=dev)
        trout = torch.empty((tr_rows, Ls), dtype=field.dtype, device=dev)
        ptr = (lambda x: None if x is None else x.data_ptr())
        kt = d.tables
        args = MergedArgs(
            field=ptr(field), trs=ptr(trs), geo=ptr(d.geo), mask=ptr(mask),
            ax0=ptr(axpy[0]) if axpy else None,
            ax1=ptr(axpy[1]) if axpy else None,
            damp=ptr(damp),
            inj0=ptr(inject[0][0]) if len(inject) > 0 else None,
            inj1=ptr(inject[1][0]) if len(inject) > 1 else None,
            plan=ptr(plan.table) if plan is not None else None,
            fnodes=ptr(kt.fnodes), tab=ptr(kt.tile),
            out=ptr(out), trout=ptr(trout),
            Ls=Ls, NC=plan.NC if plan is not None else Ls, npp=d.npp,
            rtf=rtf, rtq=plan.rtq if plan is not None else rtf,
            n_par=d.n_par, irho_par=irho_par, o_ginv=o[0], o_nrm=o[1],
            o_scb=o[2], o_bfs=o[3], o_dfs=o[4], o_mat=o[5],
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
                f"no instantiation for dim={d.dim} n_p={d.n_p} "
                f"n_par={d.n_par}" if err == -1 else f"cudaError {err}"))
        self.launches += 1
        self.launches_c += int(o_C >= 0)
        self.launches_pk += int(d.n_par == 2)
        return out, trout


VEL_KERNEL = MergedKernel("seigen_merged_vel", "merged_vel", vel=True)
STRESS_KERNEL = MergedKernel("seigen_merged_stress", "merged_stress",
                             vel=False)


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
