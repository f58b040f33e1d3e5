"""Mesh partitioning and the halo-exchange plan of the general sharded
path, computed once on the host.

Port of ``seigen_tpu/parallel/partition.py``.  The Morton sort and the
halo needs take the ``mesh/native`` C++ path whenever
``native.available()``, as the JAX package does; ``morton_argsort_numpy``
and ``halo_needs_numpy`` are their oracles:

  1. Elements are ordered along a Morton space-filling curve and split
     into P equal contiguous blocks, padded with inert self-connected
     elements at the end when P does not divide E.  Each rank owns one
     block.
  2. Every neighbour-trace reference that crosses a block boundary becomes
     a halo entry: for each ordered pair of blocks, the sorted unique face
     nodes one needs of the other.
  3. The block-pair graph is edge-coloured into K rounds of matchings;
     round k is one ``Comm.permute`` on the device.
  4. Each block's ``nbr`` is remapped into [local nodes | K*H ghost pool],
     so the einsum operators run unchanged on a block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def morton_order(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting points along a Morton (Z-order) curve.

    Uses the native C++ path when available; ``morton_argsort_numpy`` is
    the oracle (the two agree exactly).
    """
    p = points - points.min(axis=0)
    scale = p.max(axis=0)
    scale[scale == 0] = 1.0
    q = np.minimum((p / scale * (2**bits - 1)).astype(np.uint64), 2**bits - 1)

    from ..mesh import native

    if native.available():
        return native.morton_argsort(q.astype(np.uint32), bits=bits)
    return morton_argsort_numpy(q, bits)


def morton_argsort_numpy(q: np.ndarray, bits: int = 16) -> np.ndarray:
    """(n, dim) uint64 quantized coords -> Morton-order permutation, by a
    NumPy bit interleave and a stable argsort."""
    dim = q.shape[1]
    code = np.zeros(len(q), dtype=np.uint64)
    for b in range(bits):
        for d in range(dim):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * dim + d
            )
    return np.argsort(code, kind="stable")


def halo_needs_numpy(gids: np.ndarray, src: np.ndarray, dst: np.ndarray,
                     P: int) -> dict:
    """Directed cross-shard needs {(src, dst): sorted unique gids}, by a
    lexsort and a np.unique per pair."""
    order = np.lexsort((gids, src, dst))
    gids, src, dst = gids[order], src[order], dst[order]
    key = dst * P + src
    bounds = np.r_[0, np.nonzero(np.diff(key))[0] + 1, len(key)]
    return {(int(src[a]), int(dst[a])): np.unique(gids[a:b])
            for a, b in zip(bounds[:-1], bounds[1:])}


def _edge_color(pairs: list[tuple[int, int]]) -> list[int]:
    """Greedy edge colouring: a round for each undirected pair such that
    no shard appears twice in one round."""
    busy: list[set[int]] = []
    colors = []
    for a, b in pairs:
        k = 0
        while k < len(busy) and (a in busy[k] or b in busy[k]):
            k += 1
        if k == len(busy):
            busy.append(set())
        busy[k].update((a, b))
        colors.append(k)
    return colors


@dataclass(frozen=True)
class Plan:
    """Host-side sharding plan (all NumPy)."""

    n_shards: int
    perm: np.ndarray  # (E,) original element id per new slot (pre-padding)
    E: int  # original element count
    E_pad: int  # padded to n_shards * block
    block: int  # elements per shard
    n_rounds: int  # K halo-exchange rounds
    halo_max: int  # H: padded per-round send-list length
    send_idx: np.ndarray  # (P, K, H) int32 local flat node ids to send
    round_perms: tuple  # K tuples of (src, dst) pairs, one permute each
    nbr_local: np.ndarray  # (E_pad, n_faces, n_fp) int32 into local+ghosts


def make_plan(dm, n_shards: int) -> Plan:
    """The partition and halo plan of ``dm`` (a DiscreteMesh) over
    ``n_shards`` blocks."""
    re = dm.re
    E, n_p = dm.num_elements, re.n_p
    P = n_shards

    perm = morton_order(dm.coords.mean(axis=1))
    block = -(-E // P)
    E_pad = block * P
    inv = np.full(E, -1, dtype=np.int64)
    inv[perm] = np.arange(E)

    # nbr in the permuted node numbering; pad elements (slots E..E_pad-1)
    # are self-connected
    old_nbr = np.asarray(dm.nbr)
    new_nbr = (inv[old_nbr // n_p] * n_p + old_nbr % n_p).astype(np.int64)
    nbr_perm = new_nbr[perm]
    fnodes = np.asarray(re.fnodes)
    pad_rows = np.broadcast_to(
        fnodes[None], (E_pad - E, re.n_faces, re.n_fp)
    ) + (np.arange(E, E_pad) * n_p)[:, None, None]
    nbr_full = np.concatenate([nbr_perm, pad_rows], axis=0)

    # directed needs (q -> p): sorted unique global node ids
    shard_of_elem = np.arange(E_pad) // block
    shard_of_node = np.repeat(shard_of_elem, n_p)
    owner = shard_of_node[nbr_full.reshape(-1)].reshape(nbr_full.shape)
    my_shard = shard_of_elem[:, None, None]
    needs: dict[tuple[int, int], np.ndarray] = {}
    cross = owner != my_shard
    if cross.any():
        ce = np.nonzero(cross)
        gids = nbr_full[ce]
        src = owner[ce]
        dst = np.broadcast_to(my_shard, nbr_full.shape)[ce]
        from ..mesh import native

        if native.available():
            needs = native.halo_needs(gids, src, dst, P)
        else:
            needs = halo_needs_numpy(gids, src, dst, P)

    # undirected pairs, edge-coloured into rounds
    und = sorted({tuple(sorted(k)) for k in needs})
    colors = _edge_color(und)
    K = max(colors) + 1 if colors else 0
    H = max((len(v) for v in needs.values()), default=1)

    send_idx = np.zeros((P, max(K, 1), H), dtype=np.int32)
    round_perms: list[tuple] = [tuple() for _ in range(max(K, 1))]
    recv_map: dict[tuple[int, int], int] = {}  # (dst, k) -> src
    for (a, b), k in zip(und, colors):
        pairs = list(round_perms[k])
        for q, p_ in ((a, b), (b, a)):
            lst = needs.get((q, p_))
            if lst is not None and len(lst):
                local = (lst - q * block * n_p).astype(np.int32)
                assert local.min() >= 0 and local.max() < block * n_p
                send_idx[q, k, : len(lst)] = local
                pairs.append((q, p_))
                recv_map[(p_, k)] = q
        round_perms[k] = tuple(pairs)

    # nbr remapped into [local nodes | K*H ghost pool]
    pool_base = block * n_p
    nbr_local = np.empty(nbr_full.shape, dtype=np.int32)
    flat = nbr_full.reshape(E_pad, -1)
    out = nbr_local.reshape(E_pad, -1)
    for p_ in range(P):
        rows = slice(p_ * block, (p_ + 1) * block)
        sub = flat[rows]
        res = np.empty_like(sub, dtype=np.int32)
        own = shard_of_node[sub.reshape(-1)].reshape(sub.shape) == p_
        res[own] = (sub[own] - p_ * block * n_p).astype(np.int32)
        if not own.all():
            rem = ~own
            gids = sub[rem]
            pos = np.empty(len(gids), dtype=np.int32)
            done = np.zeros(len(gids), dtype=bool)
            for k in range(K):
                q = recv_map.get((p_, k))
                if q is None:
                    continue
                lst = needs[(q, p_)]
                sel = shard_of_node[gids] == q
                if sel.any():
                    idx = np.searchsorted(lst, gids[sel])
                    assert np.array_equal(lst[idx], gids[sel])
                    pos[sel] = pool_base + k * H + idx
                    done |= sel
            assert done.all(), "halo remap missed entries"
            res[rem] = pos
        out[rows] = res

    return Plan(n_shards=P, perm=perm, E=E, E_pad=E_pad, block=block,
                n_rounds=K, halo_max=H, send_idx=send_idx,
                round_perms=tuple(round_perms), nbr_local=nbr_local)
