"""Unstructured lane-major trace exchange — the general-mesh fast path.

Port of ``seigen_tpu/ops/unstructured_exchange.py``.  On a conforming DG
mesh the face pairing is a bijection: every interior consumer face (e, f)
has one producer face (e2, f2) and a node permutation k2 from a small
orientation set (the symmetries of the facet simplex); boundary faces
self-pair with the identity, so ghost/BC semantics stay in the flux
coefficients (ops/elastic.py beta/delta).

The host planning (``FacePairing``, ``derive_face_pairing``,
``permute_pairing``, ``orientation_groups``) is a NumPy copy.  The device side is PyTorch data movement, as the JAX package leaves
it to XLA:

- ``make_unstructured_exchange_lm`` and
  ``make_unstructured_traction_exchange`` assemble consumer-ordered traces
  (C*ftpp, E) with ONE precomputed-index gather per exchange;
- ``make_panel_gather`` builds raw per-face panels (one lane take per
  face) and the static plan of the in-operator select
  (ops/lane_kernels.py ``*_sel``).

Own face traces are extracted by row indexing (the JAX package's one-hot
restriction matmul is exact only at HIGHEST precision; a row index is
exact at any).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .fused_kernels import _rup

@dataclass(frozen=True)
class FacePairing:
    """Face-bijection form of a mesh's trace connectivity.

    e2/f2: producer element/face per consumer face (E, nf); k2 (E, nf, nfp):
    consumer node k reads producer face node k2.  Boundary faces self-pair
    (e2 = e, f2 = f, k2 = identity).
    """

    e2: np.ndarray
    f2: np.ndarray
    k2: np.ndarray
    n_p: int
    n_faces: int
    n_fp: int


def derive_face_pairing(nbr: np.ndarray, n_p: int, fnodes) -> FacePairing:
    """Decode (E, nf, nfp) neighbour NODE ids into the face bijection.

    ``nbr`` indexes the flat (E*n_p) node space (ops/elastic.py
    ElasticParams.nbr); every node of a consumer face must come from one
    producer element and one producer face (conforming mesh).
    """
    nbr = np.asarray(nbr)
    E, nf, nfp = nbr.shape
    fn = np.asarray(fnodes)  # (nf, nfp)
    e2 = nbr[:, :, 0] // n_p
    assert (nbr // n_p == e2[:, :, None]).all(), "face spans elements"
    ln = nbr % n_p  # producer-local node ids (E, nf, nfp)

    # f2: the unique producer face whose node set matches
    key = np.sort(ln, axis=2)  # (E, nf, nfp)
    fkey = np.sort(fn, axis=1)  # (nf, nfp)
    match = (key[:, :, None, :] == fkey[None, None, :, :]).all(axis=3)
    assert (match.sum(axis=2) == 1).all(), "no unique producer face"
    f2 = match.argmax(axis=2).astype(np.int64)

    # k2: position of each consumer-slot node within fnodes[f2]
    pos = np.full((nf, n_p), -1, dtype=np.int64)
    for f in range(nf):
        pos[f, fn[f]] = np.arange(nfp)
    k2 = pos[f2[:, :, None], ln]
    assert (k2 >= 0).all()
    return FacePairing(e2=e2, f2=f2, k2=k2, n_p=n_p, n_faces=nf, n_fp=nfp)


def permute_pairing(pr: FacePairing, old_of_new: np.ndarray,
                    new_of_old: np.ndarray) -> FacePairing:
    """Re-express a pairing under an element permutation."""
    return FacePairing(
        e2=new_of_old[pr.e2[old_of_new]],
        f2=pr.f2[old_of_new],
        k2=pr.k2[old_of_new],
        n_p=pr.n_p, n_faces=pr.n_faces, n_fp=pr.n_fp,
    )


def orientation_groups(pr: FacePairing):
    """Group consumer faces by their node permutation k2.

    Returns (gid (E, nf) int group ids, perms (G, nfp)): k2[e, f] ==
    perms[gid[e, f]].  G is bounded by the facet symmetry count (+identity).
    """
    E, nf, nfp = pr.k2.shape
    flat = pr.k2.reshape(E * nf, nfp)
    perms, gid = np.unique(flat, axis=0, return_inverse=True)
    return gid.reshape(E, nf), perms


def _source_rows(pr: FacePairing, fnodes):
    """(nf*nfp, E) producer-local volume node of every consumer (face
    node, lane): fnodes[f2, k2]."""
    fn = np.asarray(fnodes)
    node = fn[pr.f2[:, :, None], pr.k2]  # (E, nf, nfp)
    E = node.shape[0]
    return node.reshape(E, -1).T


def _gather_plan(rows: np.ndarray, lanes: np.ndarray, row_len: int,
                 device) -> torch.Tensor:
    """Flat gather index rows*row_len + lanes, (ftp*E,) int64 on device."""
    return torch.as_tensor((rows * row_len + lanes).reshape(-1),
                           device=device)


def _gather_traces(x, idx, C, ftp, ftpp, E):
    """One gather of the (C, n*E) component planes of x at the flat
    (ftp*E,) index idx -> (C*ftpp, E), pad rows zero."""
    out = torch.gather(x.reshape(C, -1), 1, idx.expand(C, -1))
    out = out.view(C, ftp, E)
    if ftpp != ftp:
        out = torch.nn.functional.pad(out, (0, 0, 0, ftpp - ftp))
    return out.reshape(C * ftpp, E)


def _own_rows(f_lm, fn_idx, C, npp):
    """(C*npp, E) field -> own face-node rows (C, ftp, E), by row index."""
    return f_lm.reshape(C, npp, -1).index_select(1, fn_idx)


def _contract(T, nrm_lm, voigt, dim, ftpp, ftp):
    """Producer-normal traction contraction (n_sig, ftp, E) ->
    (dim, ftp, E): t_c = sum_d n_d sigma_{V[c,d]}."""
    trac = []
    for c in range(dim):
        acc = None
        for d in range(dim):
            term = nrm_lm[d * ftpp : d * ftpp + ftp] * T[int(voigt[c, d])]
            acc = term if acc is None else acc + term
        trac.append(acc)
    return torch.stack(trac, dim=0)


def _boundary_sign(pr: FacePairing):
    """(E, nf) +1 on self-paired (boundary) faces, -1 on interior ones
    (the consumer normal is minus the producer's)."""
    E, nf = pr.e2.shape
    boundary = (pr.e2 == np.arange(E)[:, None]) & (
        pr.f2 == np.arange(nf)[None, :])
    return np.where(boundary, 1.0, -1.0)


def make_unstructured_exchange_lm(pr: FacePairing, ftpp: int, C: int,
                                  E: int, fnodes, device="cuda"):
    """(C*npp, E) field -> (C*ftpp, E) consumer traces: row c*ftpp +
    f*nfp + k of lane L is field row c*npp + fnodes[f2, k2] of lane e2
    (one gather; pad rows zero)."""
    nfp = pr.n_fp
    ftp = pr.n_faces * nfp
    idx = _gather_plan(_source_rows(pr, fnodes), pr.e2.T.repeat(nfp, axis=0),
                       E, device)

    def exchange(f_lm: torch.Tensor) -> torch.Tensor:
        return _gather_traces(f_lm, idx, C, ftp, ftpp, E)

    return exchange


def make_unstructured_traction_exchange(
        pr: FacePairing, npp: int, ftpp: int, dim: int, n_sig: int,
        E: int, fnodes, nrm_lm: torch.Tensor, voigt: np.ndarray):
    """(n_sig*npp, E) sigma field -> (dim*ftpp, E) NEIGHBOUR TRACTIONS
    t_c = n_consumer . sigma_nbr in consumer order.

    The contraction happens on the PRODUCER side with its own normals
    (n_consumer = -n_producer on conforming faces, so interior lanes flip
    sign; boundary self-pairs keep +), which halves the exchanged payload
    from n_sig to dim rows per face node; pairs with
    ops/lane_kernels.vel_op_lm_trac.  ``nrm_lm``: (dim*ftpp, E) lane-major
    face-node-expanded normals (LaneOpData.nrm, already element-permuted
    by the runner).
    """
    nf, nfp = pr.n_faces, pr.n_fp
    ftp = nf * nfp
    dev = nrm_lm.device
    fn_idx = torch.as_tensor(np.asarray(fnodes).reshape(-1), device=dev)
    prod_row = (pr.f2[:, :, None] * nfp + pr.k2).reshape(E, -1).T
    idx = _gather_plan(prod_row, pr.e2.T.repeat(nfp, axis=0), E, dev)
    sign_rows = torch.as_tensor(
        np.repeat(_boundary_sign(pr).T, nfp, axis=0), device=dev).to(
            nrm_lm.dtype)  # (ftp, E)

    def exchange(sig_lm: torch.Tensor) -> torch.Tensor:
        T = _contract(_own_rows(sig_lm, fn_idx, n_sig, npp), nrm_lm, voigt,
                      dim, ftpp, ftp)
        out = torch.gather(T.reshape(dim, -1), 1, idx.expand(dim, -1))
        out = out.view(dim, ftp, E) * sign_rows
        if ftpp != ftp:
            out = torch.nn.functional.pad(out, (0, 0, 0, ftpp - ftp))
        return out.reshape(dim * ftpp, E)

    return exchange


def make_panel_gather(
        pr: FacePairing, npp: int, ftpp: int, C: int, E: int, fnodes,
        nrm_lm: torch.Tensor | None = None,
        voigt: np.ndarray | None = None, n_sig: int | None = None,
        device="cuda"):
    """Raw per-face lane-take panels + static plan for the IN-OPERATOR
    select (ops/lane_kernels.py vel_op_lm_trac_sel / stress_op_lm_sel).

    Own face rows (+ the producer traction contraction when ``nrm_lm`` is
    given) are extracted once; each consumer face then takes its producer
    lanes in one index_select; the (f2, pi)-select and the sign flip run
    in the operator.

    Returns (panels_fn: field_lm -> (nf*rows_pad, E), combo (8, E) int32,
    sign (8, E) in nrm_lm's dtype or None, selcfg).  ``panels_fn`` carries
    its two halves as attributes: ``own_rows_fn`` (field -> own-face rows)
    and ``takes_fn`` (own-face rows -> panels).
    """
    nf, nfp = pr.n_faces, pr.n_fp
    ftp = nf * nfp
    if nrm_lm is not None:
        device = nrm_lm.device
    Cin = n_sig if nrm_lm is not None else C
    rows_pad = _rup(C * ftp, 8)
    fn_idx = torch.as_tensor(np.asarray(fnodes).reshape(-1), device=device)

    gid, perms_np = orientation_groups(pr)
    combo_np = pr.f2 * perms_np.shape[0] + gid  # (E, nf)
    take_e2 = torch.as_tensor(pr.e2.T.copy(), device=device)  # (nf, E)
    combo = np.zeros((8, E), dtype=np.int32)
    combo[:nf] = combo_np.T
    combo = torch.as_tensor(combo, device=device)
    face_combos = tuple(
        tuple(int(x) for x in np.unique(combo_np[:, f])) for f in range(nf))
    perms = tuple(tuple(int(x) for x in row) for row in perms_np)
    selcfg = (C, nf, nfp, ftp, ftpp, rows_pad, face_combos, perms)

    sign = None
    if nrm_lm is not None:
        s = np.zeros((8, E), dtype=np.float64)
        s[:nf] = _boundary_sign(pr).T
        sign = torch.as_tensor(s, device=device).to(nrm_lm.dtype)

    def own_rows_fn(f_lm: torch.Tensor) -> torch.Tensor:
        """Own-face rows (rows_pad, E): the row-index restriction (+ the
        traction contraction on the sigma side) — the half an operator
        can emit itself (ops/lane_upwind_kernels.py, ``emit=True``)."""
        T = _own_rows(f_lm, fn_idx, Cin, npp)  # (Cin, ftp, E)
        if nrm_lm is not None:
            T = _contract(T, nrm_lm, voigt, C, ftpp, ftp)
        T = T.reshape(C * ftp, E)
        if rows_pad != C * ftp:
            T = torch.nn.functional.pad(T, (0, 0, 0, rows_pad - C * ftp))
        return T

    def takes_fn(T: torch.Tensor) -> torch.Tensor:
        """The nf neighbour lane takes of own-face rows T (rows, E), in
        consumer order -> (nf*rows, E)."""
        panels = torch.empty((nf,) + tuple(T.shape), dtype=T.dtype,
                             device=T.device)
        for f in range(nf):
            torch.index_select(T, 1, take_e2[f], out=panels[f])
        return panels.reshape(nf * T.shape[0], E)

    def panels_fn(f_lm: torch.Tensor) -> torch.Tensor:
        return takes_fn(own_rows_fn(f_lm))

    panels_fn.own_rows_fn = own_rows_fn
    panels_fn.takes_fn = takes_fn
    return panels_fn, combo, sign, selcfg
