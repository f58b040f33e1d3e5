"""v1 lane-major LF operators — operator data, CUDA kernels, plain twins.

Port of ``seigen_tpu/ops/pallas_kernels.py`` (the lane-major operator
family of the ``lane`` and ``lane_u`` runners).  Each operator application
fuses, per element (lane):

    reference-derivative products -> inverse-Jacobian contraction ->
    div/Hooke recombination -> central flux at the face nodes -> LIFT
    product -> material scaling

on state arrays (C*npp, E) whose rows are (component, node) and whose lanes
are elements.  Neighbour traces arrive pre-exchanged in CONSUMER order
(C*ftpp, E), rows c*ftpp + f*n_fp + k, or — the ``_sel`` variants — as raw
per-face panels plus a per-(face, lane) combo code that the operator
decodes itself (ops/unstructured_exchange.py:make_panel_gather).

``LaneOpData`` keeps the JAX package's row layout (``npp``/``ftpp`` padded
to 8, ``drr = [Dr; R]``, (8, E) scalar rows, geometry expanded to face
nodes), so every array compares row for row with the JAX one.  Lanes are
the E elements, without padding.

The public operators launch the CUDA kernels of csrc/lane_kernels.cu for
CUDA tensors — K4 ``lane_vel`` (modes SIG, TRAC, SEL; the tile kernel on
K1's velocity core) and K5 ``lane_stress`` (modes TR, SEL; the tile kernel
on K2's stress core), both of which read each face's geometry at its first
face-node row, the expanded rows being constant over a face — and run the
plain PyTorch versions (``*_ref``) for CPU tensors.  Each kernel keeps a
launch count (``LANE_VEL.launches``, ``LANE_STRESS.launches``).  The stress operators
take an optional ``cmat`` (n_sig*8, E), row c*8 + k = Voigt C[c, k] of the
lane's element (ops/anisotropic.py conventions): the general Hooke law,
computed inside K5 (``LANE_STRESS.launches_c`` counts those launches).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .cuda_build import CudaLibrary
from .elastic import ElasticParams, voigt_map
from .fused_kernels import _rup, stiffness_array, tile_table
from .merged_kernels import check_operands, hooke_rows

# trace-source modes of the kernels (run-time flag, csrc/lane_kernels.cu)
VEL_SIG, VEL_TRAC, VEL_SEL = 0, 1, 2
STRESS_TR, STRESS_SEL = 0, 1
MAX_PERMS = 16  # orientation groups the kernels hold in shared memory


@dataclass(frozen=True)
class LaneOpData:
    """Transposed + padded operator data for the lane-major operators."""

    lift: torch.Tensor  # (npp, ftpp)
    drr: torch.Tensor  # (dim*npp + ftpp, npp): stacked derivative
    #                    matrices over the own-trace restriction
    ginv: torch.Tensor  # (dim*dim, E) rows r*dim+d
    nrm: torch.Tensor  # (dim*ftpp, E) face-node-expanded normals
    fsc: torch.Tensor  # (ftpp, E) face-node-expanded Fscale
    beta: torch.Tensor  # (ftpp, E) expanded traction-jump coefficient
    delta: torch.Tensor  # (ftpp, E) expanded velocity-jump coefficient
    irho: torch.Tensor  # (8, E) row 0 = 1/rho
    lam: torch.Tensor  # (8, E) row 0 = lambda
    mu: torch.Tensor  # (8, E) row 0 = mu
    kfn: torch.Tensor  # (nf, n_fp) int32 face node ids
    ktile: torch.Tensor  # float32 product table of the K4/K5 and K6/K7
    #                      tile kernels (fused_kernels.tile_table)
    dim: int
    n_p: int
    npp: int  # n_p padded to 8
    ftp: int  # n_faces * n_fp
    ftpp: int  # padded
    n_sig: int
    E: int
    nf: int
    n_fp: int


LANE_FIELDS = ("ginv", "nrm", "fsc", "beta", "delta", "irho", "lam", "mu")


def build_lane_data(p: ElasticParams) -> LaneOpData:
    """Lane-major operator data on p's device and dtype, lanes in p's
    element order (host tables assembled in f64, then cast)."""
    dim, n_p = p.dim, p.n_p
    nf, n_fp = p.n_faces, p.n_fp
    npp = _rup(n_p)
    ftp = nf * n_fp
    ftpp = _rup(ftp)
    E = p.Ginv.shape[0]

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    Dr = np.zeros((dim * npp, npp), dtype=np.float64)
    for r in range(dim):
        Dr[r * npp : r * npp + n_p, :n_p] = host(p.Dr[r])
    LIFT = np.zeros((npp, ftpp), dtype=np.float64)
    LIFT[:n_p, :ftp] = host(p.LIFT)
    fn = np.array(p.fnodes).reshape(-1)
    R = np.zeros((ftpp, npp), dtype=np.float64)
    R[np.arange(ftp), fn] = 1.0

    # per-face geometry expanded to face-node rows (f*n_fp + k ordering)
    rep = np.repeat(np.arange(nf), n_fp)

    def expand(a):  # (E, nf) -> (ftpp, E)
        out = np.zeros((ftpp, E), dtype=np.float64)
        out[:ftp] = a[:, rep].T
        return out

    nrm = np.zeros((dim * ftpp, E), dtype=np.float64)
    normals = host(p.normals)
    for d in range(dim):
        nrm[d * ftpp : d * ftpp + ftp] = normals[:, rep, d].T

    def scalar_rows(a):  # (E,) -> (8, E)
        out = np.zeros((8, E), dtype=np.float64)
        out[0] = a
        return out

    def dev(a, dtype=p.dtype):
        return torch.as_tensor(a, device=p.device).to(dtype)

    return LaneOpData(
        lift=dev(LIFT),
        drr=dev(np.concatenate([Dr, R], axis=0)),
        ginv=dev(host(p.Ginv).transpose(1, 2, 0).reshape(dim * dim, E)),
        nrm=dev(nrm),
        fsc=dev(expand(host(p.Fscale))),
        beta=dev(expand(host(p.beta_t))),
        delta=dev(expand(host(p.delta_u))),
        irho=dev(scalar_rows(host(p.inv_rho))),
        lam=dev(scalar_rows(host(p.lam))),
        mu=dev(scalar_rows(host(p.mu))),
        kfn=dev(np.array(p.fnodes), torch.int32).contiguous(),
        ktile=dev(tile_table(host(p.Dr), host(p.LIFT)),
                  torch.float32).contiguous(),
        dim=dim, n_p=n_p, npp=npp, ftp=ftp, ftpp=ftpp, n_sig=p.n_sig, E=E,
        nf=nf, n_fp=n_fp,
    )


def permute_lanes(d: LaneOpData, old_of_new: torch.Tensor) -> LaneOpData:
    """The same data with its lanes (elements) reordered: new lane j holds
    old element old_of_new[j]."""
    return dataclasses.replace(d, **{
        k: getattr(d, k)[:, old_of_new].contiguous() for k in LANE_FIELDS})


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _derivs_own(d: LaneOpData, x, C):
    """(C*npp, E) -> reference derivatives (C, dim, npp, E) and own face
    traces (C, ftpp, E): one [Dr; R] product per component."""
    E = x.shape[1]
    combo = torch.matmul(d.drr, x.reshape(C, d.npp, E))
    der = combo[:, : d.dim * d.npp].reshape(C, d.dim, d.npp, E)
    return der, combo[:, d.dim * d.npp :]


def _vel_core(d: LaneOpData, sig_lm, t_nbr):
    """Velocity operator given consumer-ordered neighbour tractions
    t_nbr (dim, ftpp, E)."""
    dim, npp, ftpp = d.dim, d.npp, d.ftpp
    V = voigt_map(dim)
    E = sig_lm.shape[1]
    der, own = _derivs_own(d, sig_lm, d.n_sig)
    nrm = d.nrm.reshape(dim, ftpp, E)
    ginv = d.ginv
    out = []
    for c in range(dim):
        div = sum(ginv[r * dim + k] * der[V[c, k], r]
                  for k in range(dim) for r in range(dim))
        t_own = sum(nrm[k] * own[V[c, k]] for k in range(dim))
        jump = 0.5 * t_nbr[c] + d.beta * t_own
        surf = torch.matmul(d.lift, jump * d.fsc)
        out.append(d.irho[0] * (div + surf))
    return torch.cat(out, dim=0)


def vel_op_lm_ref(d: LaneOpData, sig_lm, tr_lm):
    """Plain version of K4 mode SIG (see vel_op_lm)."""
    dim, ftpp = d.dim, d.ftpp
    V = voigt_map(dim)
    tr = tr_lm.reshape(d.n_sig, ftpp, -1)
    nrm = d.nrm.reshape(dim, ftpp, -1)
    t_nbr = [sum(nrm[k] * tr[V[c, k]] for k in range(dim))
             for c in range(dim)]
    return _vel_core(d, sig_lm, t_nbr)


def vel_op_lm_trac_ref(d: LaneOpData, sig_lm, tr_lm):
    """Plain version of K4 mode TRAC (see vel_op_lm_trac)."""
    return _vel_core(d, sig_lm, tr_lm.reshape(d.dim, d.ftpp, -1))


def _select_tiles(panels, combo, sign, selcfg):
    """Consumer traces (C*ftpp, E) from raw per-face panels: lane L of
    face f reads rows c*cstride + g*n_fp + perms[pi][k] of its panel, with
    (g, pi) = divmod(combo[f, L], G), times sign[f, L] when given.

    selcfg = (C, nf, n_fp, cstride, ftpp, rows_pad, face_combos, perms);
    ``cstride`` is the panels' component stride: nf*n_fp for gathered
    panels (``make_panel_gather``), ftpp for panels an operator emitted
    (ops/lane_upwind_kernels.py, ``emit=True``)."""
    C, nf, nfp, cstride, ftpp, rows_pad, _, perms = selcfg
    G = len(perms)
    E = panels.shape[1]
    dev = panels.device
    P = panels.reshape(nf, rows_pad, E)
    perm_t = torch.as_tensor(perms, device=dev)  # (G, nfp)
    cbase = (torch.arange(C, device=dev) * cstride)[:, None, None]
    out = panels.new_zeros((C, ftpp, E))
    for f in range(nf):
        code = combo[f].long()
        g, pi = code // G, code % G
        rows = cbase + (g * nfp)[None, None, :] + perm_t[pi].T[None]
        tile = torch.gather(P[f], 0, rows.reshape(C * nfp, E))
        if sign is not None:
            tile = tile * sign[f]
        out[:, f * nfp : (f + 1) * nfp] = tile.reshape(C, nfp, E)
    return out.reshape(C * ftpp, E)


def vel_op_lm_trac_sel_ref(d: LaneOpData, sig_lm, panels, combo, sign,
                           selcfg):
    """Plain version of K4 mode SEL (see vel_op_lm_trac_sel)."""
    return vel_op_lm_trac_ref(d, sig_lm,
                              _select_tiles(panels, combo, sign, selcfg))


def build_cmat(stiffness, d: LaneOpData, old_of_new=None) -> torch.Tensor:
    """(n_sig*8, E) stiffness rows of the lane stress operators on d's
    device and dtype: row c*8 + k = C[e, c, k] of the element e =
    old_of_new[lane] (identity when None); rows n_sig..7 of each section
    are zero.  ``stiffness``: (n_sig, n_sig) or (E, n_sig, n_sig)."""
    n_sig, E = d.n_sig, d.E
    C = stiffness_array(stiffness, E, n_sig)
    if old_of_new is not None:
        C = C[np.asarray(old_of_new)]
    cm = np.zeros((n_sig * 8, E), dtype=np.float64)
    for c in range(n_sig):
        cm[c * 8 : c * 8 + n_sig] = C[:, c, :].T
    return torch.as_tensor(cm, device=d.ginv.device).to(d.ginv.dtype)


def check_cmat(name, d: LaneOpData, cmat):
    """Raise unless cmat is a (n_sig*8, E) tensor of d's dtype and device."""
    if not isinstance(cmat, torch.Tensor) \
            or cmat.shape != (d.n_sig * 8, d.E) \
            or cmat.dtype != d.ginv.dtype or cmat.device != d.ginv.device:
        got = tuple(cmat.shape) if isinstance(cmat, torch.Tensor) else cmat
        raise ValueError(
            f"{name}: cmat must be a ({d.n_sig * 8}, {d.E}) {d.ginv.dtype} "
            f"tensor on {d.ginv.device}, got {got!r}")


def stress_op_lm_ref(d: LaneOpData, u_lm, tr_lm, cmat=None):
    """Plain version of K5 mode TR (see stress_op_lm)."""
    if cmat is not None:
        check_cmat("stress_op_lm_ref", d, cmat)
    dim, ftpp = d.dim, d.ftpp
    E = u_lm.shape[1]
    der, own = _derivs_own(d, u_lm, dim)
    nbr = tr_lm.reshape(dim, ftpp, E)
    nrm = d.nrm.reshape(dim, ftpp, E)
    ginv = d.ginv

    def grad(c, k):  # d u_c / d x_k
        return sum(ginv[r * dim + k] * der[c, r] for r in range(dim))

    du = [0.5 * nbr[c] + d.delta * own[c] for c in range(dim)]
    lam, mu = d.lam[0], d.mu[0]
    vol = hooke_rows(dim, lam, mu, cmat, grad)
    face = hooke_rows(dim, lam, mu, cmat, lambda c, k: nrm[k] * du[c])
    return torch.cat([v + torch.matmul(d.lift, f * d.fsc)
                      for v, f in zip(vol, face)], dim=0)


def stress_op_lm_sel_ref(d: LaneOpData, u_lm, panels, combo, selcfg,
                         cmat=None):
    """Plain version of K5 mode SEL (see stress_op_lm_sel)."""
    return stress_op_lm_ref(
        d, u_lm, _select_tiles(panels, combo, None, selcfg), cmat=cmat)


# ---------------------------------------------------------------------------
# CUDA kernels

LIBRARY = CudaLibrary("seigen_lane", ("lane_kernels.cu",))

_P = ctypes.c_void_p


class LaneArgs(ctypes.Structure):
    """Mirror of ``struct LaneArgs`` in csrc/lane_kernels.cu."""

    _fields_ = [(n, _P) for n in (
        "field", "tr", "combo", "sign", "perms", "ginv", "nrm", "fsc",
        "coef", "mat0", "mat1", "cmat", "fnodes", "out")] + [
        ("E", ctypes.c_longlong)] + [(n, ctypes.c_int) for n in (
            "npp", "ftpp", "rows_pad", "cstride", "G", "mode")] + [
        ("tab", _P)]


@functools.lru_cache(maxsize=16)
def _perm_table(perms: tuple, device: torch.device) -> torch.Tensor:
    """(G, n_fp) int32 device copy of a selcfg's node permutations."""
    return torch.as_tensor(perms, dtype=torch.int32, device=device)


def check_select(name, d: LaneOpData, selcfg, combo):
    """Validate a select plan against the operator data and return
    (rows_pad, cstride, (G, n_fp) int32 device table of the permutations)
    for a kernel launch."""
    C, nf, nfp, cstride, ftpp, rows_pad, _, perms = selcfg
    if (C, nf, nfp, ftpp) != (d.dim, d.nf, d.n_fp, d.ftpp) \
            or cstride < d.ftp or rows_pad < C * cstride:
        raise ValueError(f"{name}: selcfg does not match the operator "
                         f"data: {selcfg[:6]}")
    if len(perms) > MAX_PERMS:
        raise ValueError(f"{name}: {len(perms)} orientation groups, the "
                         f"kernel holds {MAX_PERMS}")
    dev = d.ginv.device
    if combo.dtype != torch.int32 or combo.shape != (8, d.E) \
            or not combo.is_contiguous() or combo.device != dev:
        raise ValueError(f"{name}: combo must be a contiguous int32 "
                         f"(8, {d.E}) tensor on {dev}")
    return rows_pad, cstride, _perm_table(perms, dev)


class LaneKernel:
    """ctypes binding of K4 (``lane_vel``) or K5 (``lane_stress``), with
    its launch counts: ``launches`` grows by one per kernel launch and
    nowhere else; ``launches_c`` counts the launches among them that ran
    the general Hooke law (K5 with ``cmat``)."""

    def __init__(self, symbol: str, name: str, vel: bool):
        self.symbol = symbol
        self.name = name
        self.vel = vel
        self.launches = 0
        self.launches_c = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            lib = LIBRARY.load()
            size = lib.seigen_lane_args_size()
            if size != ctypes.sizeof(LaneArgs):
                raise RuntimeError(
                    f"LaneArgs layout mismatch: C {size} B, ctypes "
                    f"{ctypes.sizeof(LaneArgs)} B")
            fn = getattr(lib, self.symbol)
            fn.argtypes = [ctypes.POINTER(LaneArgs), ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, _P]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def build(self):
        """Compile/load the library now; returns the build seconds."""
        self._function()
        return LIBRARY.build_seconds

    def __call__(self, d: LaneOpData, field, tr, mode, combo=None,
                 sign=None, selcfg=None, cmat=None):
        dev = field.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: the kernel takes CUDA tensors, "
                             f"got {dev}")
        if cmat is not None and self.vel:
            raise ValueError(f"{self.name}: the velocity operator has no "
                             "material law and takes no cmat")
        E = d.E
        sel = mode == (VEL_SEL if self.vel else STRESS_SEL)
        C_in, C_out = ((d.n_sig, d.dim) if self.vel else (d.dim, d.n_sig))
        if sel:
            rows_pad, cstride, perm_t = check_select(self.name, d, selcfg,
                                                     combo)
            tr_rows = d.nf * rows_pad
        else:
            rows_pad, cstride, perm_t = 0, 0, None
            sig = self.vel and mode == VEL_SIG
            tr_rows = (d.n_sig if sig else d.dim) * d.ftpp
        checks = [(field, C_in * d.npp), (tr, tr_rows),
                  (d.ginv, d.dim * d.dim), (d.nrm, d.dim * d.ftpp),
                  (d.fsc, d.ftpp)]
        if self.vel:
            checks += [(d.beta, d.ftpp), (d.irho, 8)]
            if sel:
                checks.append((sign, 8))
        elif cmat is not None:
            check_cmat(self.name, d, cmat)
            checks += [(d.delta, d.ftpp), (cmat, d.n_sig * 8)]
        else:
            checks += [(d.delta, d.ftpp), (d.lam, 8), (d.mu, 8)]
        check_operands(self.name, dev, E, checks)
        out = torch.empty((C_out * d.npp, E), dtype=field.dtype, device=dev)

        def ptr(x):
            return None if x is None else x.data_ptr()

        args = LaneArgs(
            field=ptr(field), tr=ptr(tr), combo=ptr(combo) if sel else None,
            sign=ptr(sign) if sel and self.vel else None, perms=ptr(perm_t),
            ginv=ptr(d.ginv), nrm=ptr(d.nrm), fsc=ptr(d.fsc),
            coef=ptr(d.beta if self.vel else d.delta),
            mat0=ptr(d.irho if self.vel else d.lam),
            mat1=None if self.vel else ptr(d.mu), cmat=ptr(cmat),
            fnodes=ptr(d.kfn), out=ptr(out), E=E, npp=d.npp, ftpp=d.ftpp,
            rows_pad=rows_pad, cstride=cstride,
            G=0 if perm_t is None else perm_t.shape[0], mode=mode,
            tab=ptr(d.ktile),
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = self._function()(ctypes.byref(args), d.dim, d.n_p, d.n_fp,
                               stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: " + (
                f"no instantiation for dim={d.dim} n_p={d.n_p}" if err == -1
                else f"bad mode {mode}" if err == -2
                else f"cudaError {err}"))
        self.launches += 1
        self.launches_c += int(cmat is not None)
        return out


LANE_VEL = LaneKernel("seigen_lane_vel", "lane_vel", vel=True)
LANE_STRESS = LaneKernel("seigen_lane_stress", "lane_stress", vel=False)


def _on_cuda(x):
    return x.device.type == "cuda"


def vel_op_lm(d: LaneOpData, sig_lm, tr_lm):
    """Lane-major velocity operator: sigma (n_sig*npp, E) and neighbour
    sigma traces tr_lm (n_sig*ftpp, E), contracted in the operator with
    the CONSUMER normals -> (dim*npp, E).  CUDA tensors launch K4 (mode
    SIG); CPU tensors run vel_op_lm_ref."""
    if _on_cuda(sig_lm):
        return LANE_VEL(d, sig_lm, tr_lm, VEL_SIG)
    return vel_op_lm_ref(d, sig_lm, tr_lm)


def vel_op_lm_trac(d: LaneOpData, sig_lm, tr_lm):
    """vel_op_lm taking pre-contracted neighbour tractions (dim*ftpp, E),
    already sign-flipped to the consumer normal (K4 mode TRAC)."""
    if _on_cuda(sig_lm):
        return LANE_VEL(d, sig_lm, tr_lm, VEL_TRAC)
    return vel_op_lm_trac_ref(d, sig_lm, tr_lm)


def vel_op_lm_trac_sel(d: LaneOpData, sig_lm, panels, combo, sign, selcfg):
    """vel_op_lm_trac with the (f2, pi)-select in the operator: ``panels``
    (nf*rows_pad, E) raw traction lane-takes, ``combo`` (8, E) int32
    per-face codes, ``sign`` (8, E) (K4 mode SEL)."""
    if _on_cuda(sig_lm):
        return LANE_VEL(d, sig_lm, panels, VEL_SEL, combo=combo, sign=sign,
                        selcfg=selcfg)
    return vel_op_lm_trac_sel_ref(d, sig_lm, panels, combo, sign, selcfg)


def stress_op_lm(d: LaneOpData, u_lm, tr_lm, cmat=None):
    """Lane-major stress operator: u (dim*npp, E) and neighbour u traces
    (dim*ftpp, E) -> (n_sig*npp, E).  Isotropic Hooke law (d.lam, d.mu),
    or with ``cmat`` (n_sig*8, E), row c*8 + k = Voigt C[c, k], the general
    one.  CUDA tensors launch K5 (mode TR); CPU tensors run
    stress_op_lm_ref."""
    if _on_cuda(u_lm):
        return LANE_STRESS(d, u_lm, tr_lm, STRESS_TR, cmat=cmat)
    return stress_op_lm_ref(d, u_lm, tr_lm, cmat=cmat)


def stress_op_lm_sel(d: LaneOpData, u_lm, panels, combo, selcfg, cmat=None):
    """stress_op_lm with the u-trace (f2, pi)-select in the operator (K5
    mode SEL, no sign); ``cmat`` as in stress_op_lm."""
    if _on_cuda(u_lm):
        return LANE_STRESS(d, u_lm, panels, STRESS_SEL, combo=combo,
                           selcfg=selcfg, cmat=cmat)
    return stress_op_lm_sel_ref(d, u_lm, panels, combo, selcfg, cmat=cmat)


_OPS = {f.__name__: (f, r) for f, r in (
    (vel_op_lm, vel_op_lm_ref),
    (vel_op_lm_trac, vel_op_lm_trac_ref),
    (vel_op_lm_trac_sel, vel_op_lm_trac_sel_ref),
    (stress_op_lm, stress_op_lm_ref),
    (stress_op_lm_sel, stress_op_lm_sel_ref))}


def lane_op(name: str, impl: str):
    """Operator ``name`` for a runner's impl: the public operator (which
    launches the kernel on CUDA tensors) for "kernel", its plain version
    for "reference"."""
    return _OPS[name][0 if impl == "kernel" else 1]
