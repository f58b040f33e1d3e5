"""Operator data for the trace-carrying lane-major operators.

Port of ``seigen_tpu/ops/fused_kernels.py:FusedOpData``, ``build_fused_data``
and ``build_packed_fused_data``.  The tables keep the JAX package's row
layout, so ``geo``, ``drr``, ``lift``, ``damp`` and ``gexp`` compare row for
row with the reference:

  geo row layout (8-aligned sections; offsets in ``off``):
    ginv  dim*dim rows (r*dim+d)
    nrm   dim sections of 8 rows each, rows f<nf hold normal component d
    scb   0.5 * Fscale            (rows f<nf)
    bfs   beta_t * Fscale
    dfs   delta_u * Fscale
    mat   row 0 = 1/rho, row 1 = lambda, row 2 = mu
    C     (only with ``stiffness``) n_sig sections of 8 rows each, row
          c*8 + k = Voigt C[c, k], rows n_sig..7 of a section zero

  drr   (dim*npp + ftpp, npp): [Dr stack; own-face restriction R]
  lift  (npp, ftpp)

The PACKED layout (``n_par = 2``, ``build_packed_fused_data``; P1 only,
n_p <= 4 and nf <= 4, isotropic): two elements per lane, the one of parity
par on rows par*4 + i of each 8-row state block (npp = 8); face-trace rows
par*ftq + f*n_fp + k with ftq = nf*n_fp per parity (ftp = 2*ftq, ftpp its
roundup); the geo face sections hold rows par*4 + f; ginv is stored
compact, row o_ginv + 2*(r*dim + d) + par, and the mat section holds rows
o_mat + 2*j + par for j = 0, 1, 2 (1/rho, lambda, mu); damp (8, B) rows
par*4 + i.  ``drr``/``lift`` are block-diagonal over the two parities, and
``gexp`` is the reference's one-hot expansion of the compact ginv and mat
rows to per-row operands (``ops/merged_kernels.py:_geo_rows``).  The
kernels' ``tables`` keep the element's own Dr/LIFT/fnodes: a CUDA thread
owns one (lane, parity) and finds its rows from the parity.

Flux/BC semantics are those of ops/elastic.py (jump = 0.5*nbr +
beta/delta*own with Fscale folded: scb = 0.5*Fscale, bfs = beta_t*Fscale,
dfs = delta_u*Fscale).

The CUDA kernels compute in plain FP32 FFMA, so the JAX package's bf16
three-pass in-kernel matmul scheme has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .elastic import ElasticParams


def _rup(x, m=8):
    return ((x + m - 1) // m) * m


def stiffness_array(stiffness, E: int, n_sig: int) -> np.ndarray:
    """(E, n_sig, n_sig) float64 host view of a Voigt stiffness given as
    one matrix or one per element (numpy or tensor)."""
    if isinstance(stiffness, torch.Tensor):
        stiffness = stiffness.detach().cpu().numpy()
    return np.broadcast_to(np.asarray(stiffness, dtype=np.float64),
                           (E, n_sig, n_sig))


@dataclass(frozen=True)
class KernelTables:
    """The element tables of the CUDA operator kernels, float32 on the
    operator data's device: Dr (dim, n_p, n_p), LIFT (n_p, nf*n_fp), the
    volume node of each face node (nf, n_fp) int32, and ``tile``, the
    product table of the K1/K2 tile kernels (``tile_table``)."""

    dr: torch.Tensor
    lift: torch.Tensor
    fnodes: torch.Tensor
    tile: torch.Tensor


TILE_PAD = 4  # the tile kernels' table rows: n_p padded to a multiple of 4


def tile_table(Dr, LIFT) -> np.ndarray:
    """The product table [Dr_1 .. Dr_dim | LIFT], transposed, of the K1/K2
    tile kernels: (dim*n_p + nf*n_fp, npi) with the node index i padded to
    npi = roundup(n_p, TILE_PAD) (pad columns zero); row j*dim + r holds
    Dr_r[i, j], row dim*n_p + q holds LIFT[i, q] (csrc/merged_tile.cuh
    copies it in 16-byte pieces and reads a thread's nodes as pairs)."""
    Dr, LIFT = np.asarray(Dr), np.asarray(LIFT)
    dim, n_p = Dr.shape[0], Dr.shape[1]
    npi = _rup(n_p, TILE_PAD)
    tab = np.zeros((dim * n_p + LIFT.shape[1], npi))
    tab[: dim * n_p, :n_p] = Dr.transpose(2, 0, 1).reshape(dim * n_p, n_p)
    tab[dim * n_p :, :n_p] = LIFT.T
    return tab


@dataclass(frozen=True)
class FusedOpData:
    """Operator data for the lane-major operators (see module docstring)."""

    drr: torch.Tensor  # (dim*npp + ftpp, npp): [Dr stack; own-face restriction]
    lift: torch.Tensor  # (npp, ftpp)
    geo: torch.Tensor  # (G_ROWS, E)
    damp: torch.Tensor | None  # (npp, E) or None
    dim: int
    n_p: int
    npp: int
    ftp: int
    ftpp: int
    n_sig: int
    E: int
    nf: int
    n_fp: int
    off: tuple  # (ginv, nrm, scb, bfs, dfs, mat, C or -1, total)
    fnodes: tuple  # ((...face0 node ids...), ...)
    tables: KernelTables
    n_par: int = 1  # elements per lane (2: the packed P1 layout)
    gexp: torch.Tensor | None = None  # packed: one-hot ginv/mat expansion


def _host(x):
    """A tensor or array as a float64 NumPy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _kernel_tables(p: ElasticParams) -> KernelTables:
    """The element's own Dr/LIFT/fnodes, float32 on p's device."""
    def f32(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=p.device).to(
            dtype)

    return KernelTables(dr=f32(_host(p.Dr)), lift=f32(_host(p.LIFT)),
                        fnodes=f32(np.array(p.fnodes), torch.int32),
                        tile=f32(tile_table(_host(p.Dr), _host(p.LIFT))))


def build_fused_data(p: ElasticParams, damp=None, stiffness=None,
                     packed: bool = False) -> FusedOpData:
    """Fused operator data on p's device and dtype, columns in p's element
    order.  ``damp``: optional (E, n_p) sponge factors (numpy or tensor).
    ``stiffness``: optional (E, n_sig, n_sig) (or broadcastable) per-element
    Voigt stiffness (engineering strains, ops/anisotropic.py conventions)
    in the SAME element order as p — adds the ``C`` section, which switches
    the stress operators to the general Hooke law.  ``packed``: the P1
    two-elements-per-lane layout with elements (2j, 2j+1) of p on lane j
    (``build_packed_fused_data``; isotropic only)."""
    if packed:
        if stiffness is not None:
            raise ValueError("the packed layout is isotropic only")
        E = p.Ginv.shape[0]
        return build_packed_fused_data(p, np.arange(0, E, 2),
                                       np.arange(1, E, 2), damp=damp)
    dim, n_p = p.dim, p.n_p
    npp = _rup(n_p)
    nf, n_fp = p.n_faces, p.n_fp
    ftp = nf * n_fp
    ftpp = _rup(ftp)
    E = p.Ginv.shape[0]
    host = _host

    Dr = np.zeros((dim * npp, npp), dtype=np.float64)
    for r in range(dim):
        Dr[r * npp : r * npp + n_p, :n_p] = host(p.Dr[r])
    LIFT = np.zeros((npp, ftpp), dtype=np.float64)
    LIFT[:n_p, :ftp] = host(p.LIFT)
    fn = np.array(p.fnodes).reshape(-1)
    R = np.zeros((ftpp, npp), dtype=np.float64)
    R[np.arange(ftp), fn] = 1.0

    # geo sections
    o_ginv = 0
    o_nrm = o_ginv + _rup(dim * dim)
    o_scb = o_nrm + 8 * dim
    o_bfs = o_scb + 8
    o_dfs = o_bfs + 8
    o_mat = o_dfs + 8
    n_sig = p.n_sig
    o_C = o_mat + 8 if stiffness is not None else -1
    total = o_mat + 8 + (n_sig * 8 if stiffness is not None else 0)
    geo = np.zeros((total, E), dtype=np.float64)
    geo[: dim * dim] = host(p.Ginv).transpose(1, 2, 0).reshape(dim * dim, E)
    fsc = host(p.Fscale)  # (E, nf)
    nrm = host(p.normals)
    for d in range(dim):
        geo[o_nrm + 8 * d : o_nrm + 8 * d + nf] = nrm[:, :, d].T
    geo[o_scb : o_scb + nf] = (0.5 * fsc).T
    geo[o_bfs : o_bfs + nf] = (host(p.beta_t) * fsc).T
    geo[o_dfs : o_dfs + nf] = (host(p.delta_u) * fsc).T
    geo[o_mat + 0] = host(p.inv_rho)
    geo[o_mat + 1] = host(p.lam)
    geo[o_mat + 2] = host(p.mu)
    if stiffness is not None:
        C = stiffness_array(stiffness, E, n_sig)
        for c in range(n_sig):
            geo[o_C + c * 8 : o_C + c * 8 + n_sig] = C[:, c, :].T

    def dev(a):
        return torch.as_tensor(a, device=p.device).to(p.dtype)

    dmp = None
    if damp is not None:
        dn = np.zeros((npp, E), dtype=np.float64)
        dn[:n_p] = host(damp).T
        dmp = dev(dn)

    return FusedOpData(
        drr=dev(np.concatenate([Dr, R], axis=0)),
        lift=dev(LIFT),
        geo=dev(geo),
        damp=dmp,
        dim=dim,
        n_p=n_p,
        npp=npp,
        ftp=ftp,
        ftpp=ftpp,
        n_sig=p.n_sig,
        E=E,
        nf=nf,
        n_fp=n_fp,
        off=(o_ginv, o_nrm, o_scb, o_bfs, o_dfs, o_mat, o_C, total),
        fnodes=p.fnodes,
        tables=_kernel_tables(p),
    )


def build_packed_fused_data(p: ElasticParams, pair0, pair1,
                            damp=None) -> FusedOpData:
    """Two-elements-per-lane P1 operator data (the packed layout of the
    module docstring) on p's device and dtype.

    pair0/pair1: (B,) element indices into p's order placed on parities 0
    and 1 of lane j; the caller owns the pairing (the merged runner pairs
    classes (2u, 2u+1) of one supercell).  ``damp``: optional (E, n_p) in
    p's element order.  Raises ValueError unless n_p <= 4 and nf <= 4."""
    dim, n_p = p.dim, p.n_p
    nf, n_fp = p.n_faces, p.n_fp
    if n_p > 4 or nf > 4:
        raise ValueError("packed layout requires P1 (n_p<=4, nf<=4)")
    npp = 8
    ftq = nf * n_fp  # per-parity face-trace rows
    ftp = 2 * ftq
    ftpp = _rup(ftp)
    pairs = (np.asarray(pair0), np.asarray(pair1))
    B = len(pairs[0])
    if len(pairs[1]) != B:
        raise ValueError("pair0 and pair1 differ in length")
    host = _host

    Dr = np.zeros((dim * npp, npp), dtype=np.float64)
    LIFT = np.zeros((npp, ftpp), dtype=np.float64)
    R = np.zeros((ftpp, npp), dtype=np.float64)
    fn = np.array(p.fnodes).reshape(-1)
    for par in range(2):
        for r in range(dim):
            Dr[r * npp + par * 4 : r * npp + par * 4 + n_p,
               par * 4 : par * 4 + n_p] = host(p.Dr[r])
        LIFT[par * 4 : par * 4 + n_p,
             par * ftq : par * ftq + ftq] = host(p.LIFT)
        R[par * ftq + np.arange(ftq), par * 4 + fn] = 1.0

    # geo: compact ginv pair rows + per-(par, face) sections + compact mat
    gci = _rup(2 * dim * dim)
    o_ginv = 0
    o_nrm = gci
    o_scb = o_nrm + 8 * dim
    o_bfs = o_scb + 8
    o_dfs = o_bfs + 8
    o_mat = o_dfs + 8
    total = o_mat + 8
    geo = np.zeros((total, B), dtype=np.float64)
    Ginv, fsc, nrm = host(p.Ginv), host(p.Fscale), host(p.normals)
    beta = np.broadcast_to(host(p.beta_t), fsc.shape)
    delta = np.broadcast_to(host(p.delta_u), fsc.shape)
    mats = (host(p.inv_rho), host(p.lam), host(p.mu))
    for par, pe in enumerate(pairs):
        for rd in range(dim * dim):
            geo[o_ginv + 2 * rd + par] = Ginv[pe, rd // dim, rd % dim]
        sec = slice(par * 4, par * 4 + nf)
        for d in range(dim):
            geo[o_nrm + 8 * d :][sec] = nrm[pe][:, :, d].T
        geo[o_scb:][sec] = 0.5 * fsc[pe].T
        geo[o_bfs:][sec] = (beta * fsc)[pe].T
        geo[o_dfs:][sec] = (delta * fsc)[pe].T
        for j, mat in enumerate(mats):
            geo[o_mat + 2 * j + par] = mat[pe]

    # one-hot expansion: gm = gexp @ [geo[ginv:+gci]; geo[mat:+8]], rows
    # [ginv rd-major npp rows][irho npp][lam npp][mu npp][lam_f ftpp]
    # [mu_f ftpp]
    G = dim * dim * npp
    gexp = np.zeros((G + 3 * npp + 2 * ftpp, gci + 8), dtype=np.float64)
    for par in range(2):
        for rd in range(dim * dim):
            gexp[rd * npp + par * 4 : rd * npp + par * 4 + 4,
                 2 * rd + par] = 1.0
        for j in range(3):  # irho, lam, mu volume rows
            gexp[G + j * npp + par * 4 : G + j * npp + par * 4 + 4,
                 gci + 2 * j + par] = 1.0
        for j in range(2):  # lam_f, mu_f face-node rows
            r0 = G + 3 * npp + j * ftpp + par * ftq
            gexp[r0 : r0 + ftq, gci + 2 * (j + 1) + par] = 1.0

    def dev(a):
        return torch.as_tensor(a, device=p.device).to(p.dtype)

    dmp = None
    if damp is not None:
        dn = np.zeros((npp, B), dtype=np.float64)
        da = host(damp)
        for par, pe in enumerate(pairs):
            dn[par * 4 : par * 4 + n_p] = da[pe].T
        dmp = dev(dn)

    return FusedOpData(
        drr=dev(np.concatenate([Dr, R], axis=0)),
        lift=dev(LIFT),
        geo=dev(geo),
        damp=dmp,
        dim=dim,
        n_p=n_p,
        npp=npp,
        ftp=ftp,
        ftpp=ftpp,
        n_sig=p.n_sig,
        E=2 * B,
        nf=nf,
        n_fp=n_fp,
        off=(o_ginv, o_nrm, o_scb, o_bfs, o_dfs, o_mat, -1, total),
        fnodes=p.fnodes,
        tables=_kernel_tables(p),
        n_par=2,
        gexp=dev(gexp),
    )
