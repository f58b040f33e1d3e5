"""P1 two-elements-per-lane packing probe: K11 and the op-level A/B.

Port of ``seigen_tpu/bench/p1_pack_probe.py``.  P1 tetrahedra have n_p = 4
nodes, padded to npp = 8 rows in the lane layout, so half of every state
block is padding.  The packed layout puts elements 2j and 2j+1 on lane j,
element par on rows par*4 + i of each 8-row block, with block-diagonal
operator tables.  This module keeps the reference's stand-alone probe of
that layout: its own packed geo (``build_packed_vel_data``; pairs (2j,
2j+1), B = E/2 lanes):

  sig   (6*8, B)   rows c*8 + par*4 + i
  tr    (3*24, B)  rows c*24 + par*12 + f*3 + k   (signed tractions)
  out u (3*8, B);  trout (3*24, B) traces of out
  geo   (72, B)    ginv rows 2*(r*3 + d) + par; normal, scb, bfs sections
                   rows par*4 + f; 1/rho rows o_irho + par*4 + i

— FusedOpData's packed layout (ops/fused_kernels.py) but for the 1/rho
rows.  ``packed_vel_op`` runs the probe's velocity operator, K11
``p1_pack_vel`` (csrc/merged_kernels.cu: the packed 3D P1 instantiation of
K8 entered through its own symbol, reading 1/rho at parity stride 4), for
CUDA tensors and ``packed_vel_op_ref`` (ops/merged_kernels.py:vel_body on
the same tables) for CPU tensors.  K11's launch count is
``PACK_VEL_KERNEL.launches``.

``main`` times, on one GPU at E = 196 608 (box_mesh(32, 32, 32) P1), the
padded v2 velocity operator K8 against K11 — the reference's A/B — and
beside them the packed K8 on FusedOpData and the padded and packed v2
stress operator K9, each in ms per op beside its bytes bound:

    python -m seigen_tpu_torch.bench.p1_pack_probe [E] [steps]

It prints one JSON line with the GPU's name and power limit, and needs a
CUDA device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.elastic import ElasticParams
from ..ops.fused_kernels import FusedOpData, _host, _kernel_tables
from ..ops.fused_ops import emit_components, exchanged_rows
from ..ops.merged_kernels import MergedKernel, vel_body

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak


def build_packed_vel_data(p: ElasticParams) -> FusedOpData:
    """The probe's packed P1/3D velocity-operator data (module docstring):
    drr, lift, geo and off as the reference's tables, built in float32 on
    the host as there, then cast to p's dtype; ``gexp`` rows 0..71 are the
    reference's one-hot ginv expansion, and the 1/rho rows of the
    expansion read the probe's irho rows."""
    dim, n_p, nf, n_fp = p.dim, p.n_p, p.n_faces, p.n_fp
    if (dim, n_p) != (3, 4):
        raise ValueError("the packed probe is the P1/3D experiment")
    ftp = nf * n_fp  # 12
    E = p.Ginv.shape[0]
    if E % 2:
        raise ValueError("the packed probe needs an even element count")
    B = E // 2

    f32 = np.float32
    Dr = np.zeros((dim * 8, 8), f32)
    for r in range(dim):
        for par in range(2):
            Dr[r * 8 + par * 4 : r * 8 + par * 4 + n_p,
               par * 4 : par * 4 + n_p] = _host(p.Dr[r])
    fn = np.array(p.fnodes).reshape(-1)
    R = np.zeros((2 * ftp, 8), f32)
    lift = np.zeros((8, 2 * ftp), f32)
    for par in range(2):
        R[par * ftp + np.arange(ftp), par * 4 + fn] = 1.0
        lift[par * 4 : par * 4 + n_p, par * ftp : (par + 1) * ftp] = (
            _host(p.LIFT))

    # ginv pair rows (2*9 -> 24 rows) and their one-hot expansion to 9 x
    # (8, B); the irho rows of the expansion (as FusedOpData's gexp, rows
    # 72 + par*4 + i) read column 24 + par*4, the probe's 1/rho row
    Ginv = _host(p.Ginv)
    gexp = np.zeros((dim * dim * 8 + 3 * 8 + 2 * 2 * ftp, 24 + 8), f32)
    geo = np.zeros((24 + dim * 8 + 8 + 8 + 8, B), f32)
    for rd in range(dim * dim):
        for par in range(2):
            geo[2 * rd + par] = Ginv[par::2, rd // dim, rd % dim]
            gexp[rd * 8 + par * 4 : rd * 8 + par * 4 + 4, 2 * rd + par] = 1.0
    for par in range(2):
        gexp[72 + par * 4 : 72 + par * 4 + 4, 24 + par * 4] = 1.0

    # per-(pair, face) rows: normals (3 sections), scb, bfs; per-pair irho
    fsc, nrm = _host(p.Fscale), _host(p.normals)
    beta = np.broadcast_to(_host(p.beta_t), fsc.shape)
    o_nrm = 24
    o_scb = o_nrm + dim * 8
    o_bfs = o_scb + 8
    o_irho = o_bfs + 8
    for par in range(2):
        sec = slice(par * 4, par * 4 + nf)
        for d in range(dim):
            geo[o_nrm + d * 8 :][sec] = nrm[par::2, :, d].T
        geo[o_scb:][sec] = 0.5 * fsc[par::2].T
        geo[o_bfs:][sec] = (beta * fsc)[par::2].T
        geo[o_irho + par * 4 : o_irho + par * 4 + 4] = _host(
            p.inv_rho)[par::2]

    def dev(a):
        return torch.as_tensor(a, device=p.device).to(p.dtype)

    return FusedOpData(
        drr=dev(np.concatenate([Dr, R], axis=0)),
        lift=dev(lift),
        geo=dev(geo),
        damp=None,
        dim=dim,
        n_p=n_p,
        npp=8,
        ftp=2 * ftp,
        ftpp=2 * ftp,
        n_sig=p.n_sig,
        E=E,
        nf=nf,
        n_fp=n_fp,
        off=(0, o_nrm, o_scb, o_bfs, -1, o_irho, -1, geo.shape[0]),
        fnodes=p.fnodes,
        tables=_kernel_tables(p),
        n_par=2,
        gexp=dev(gexp),
    )


def packed_vel_op_ref(d: FusedOpData, sig_p, tr_p):
    """Plain version of K11: du = (1/rho)(div sigma + LIFT(scb*tr +
    bfs*t_own)) on the probe's layout; returns (u (24, B), traces of u
    (72, B))."""
    return vel_body(d, sig_p, lambda t_own: exchanged_rows(d, tr_p),
                    lambda t: emit_components(d, t))


class PackVelKernel(MergedKernel):
    """ctypes binding of K11 ``p1_pack_vel`` with its launch count."""

    def __call__(self, d: FusedOpData, sig_p, tr_p):
        return self.launch(d, sig_p, tr_p, d.dim * d.ftpp, d.ftpp,
                           irho_par=4)


PACK_VEL_KERNEL = PackVelKernel("seigen_p1_pack_vel", "p1_pack_vel",
                                vel=True)


def packed_vel_op(d: FusedOpData, sig_p, tr_p):
    """The probe's packed velocity operator (K11) on ``build_packed_vel_data``
    tables: CUDA tensors launch K11, CPU tensors run packed_vel_op_ref."""
    if sig_p.device.type == "cuda":
        return PACK_VEL_KERNEL(d, sig_p, tr_p)
    return packed_vel_op_ref(d, sig_p, tr_p)


def pack_state(x, rows):
    """(E, n_p<=4, C) -> packed (C*8, E/2) with parity sub-rows."""
    E, m, C = x.shape
    out = np.zeros((C * 8, E // 2), x.dtype)
    for c in range(C):
        for par in range(2):
            out[c * 8 + par * 4 : c * 8 + par * 4 + m] = x[par::2, :, c].T
    return out


def pack_traces(t):
    """(E, dim, ftp=12) -> packed (dim*24, E/2)."""
    E, dim, ftp = t.shape
    out = np.zeros((dim * 2 * ftp, E // 2), t.dtype)
    for c in range(dim):
        for par in range(2):
            out[c * 2 * ftp + par * ftp : c * 2 * ftp + (par + 1) * ftp] = (
                t[par::2, c, :].T)
    return out


def unpack_state(y, m, C, E):
    """packed (C*8, E/2) -> (E, m, C)."""
    out = np.zeros((E, m, C), y.dtype)
    for c in range(C):
        for par in range(2):
            out[par::2, :, c] = y[c * 8 + par * 4 : c * 8 + par * 4 + m].T
    return out


def bytes_bound_ms(d: FusedOpData, vel: bool) -> float:
    """Least time of one v2 operator launch at 3.35 TB/s: per element the
    live state rows in, the consumer trace rows, the geometry once per
    face (Ginv, normals, scb, bfs or dfs) and the material rows in; the
    output block and its trace rows written (per lane, npp and dim*ftpp
    rows hold n_par elements)."""
    dim, nf, n_par = d.dim, d.nf, d.n_par
    ftq = d.ftp // n_par
    c_in, c_out = (d.n_sig, dim) if vel else (dim, d.n_sig)
    geo = dim * dim + dim * nf + 2 * nf + (1 if vel else 2)
    rows = (n_par * (c_in * d.n_p + dim * ftq + geo)
            + c_out * d.npp + dim * d.ftpp)
    return 4.0 * rows * (d.E // n_par) / HBM_BYTES_PER_S * 1e3


def events_ms(fn, n_steps):
    """ms per call of fn: the best of 3 runs of n_steps calls, CUDA events,
    after a warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        start.record()
        for _ in range(n_steps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / n_steps)
    return best


def main(E: int = 196608, n_steps: int = 300, device: str = "cuda",
         p: ElasticParams | None = None) -> dict:
    """Time padded K8 against K11 (and packed K8, padded and packed K9) at
    E elements of box_mesh(n, n, n) P1, n = round((E/6)^(1/3)), float32
    random inputs from default_rng(0); ``p``: P1/3D parameters on the CUDA
    device to reuse instead.  Returns the JSON record."""
    from ..mesh import box_mesh, build_discrete
    from ..ops import Material, build_params
    from ..ops.fused_kernels import build_fused_data
    from ..ops.fused_ops import stress2_op, vel2_op
    from .throughput import gpu_name_and_power_limit

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the pack probe measures a CUDA device; none is "
                           "available")
    if p is None:
        n = round((E / 6) ** (1 / 3))
        dm = build_discrete(box_mesh(n, n, n), 1)
        p = build_params(dm, Material(rho=1.0, vp=2.0, vs=1.0),
                         dtype=torch.float32, device=device)
    E = p.Ginv.shape[0]
    d_pad = build_fused_data(p)
    d_pk = build_fused_data(p, packed=True)  # pairs (2j, 2j+1), as the probe
    d_pr = build_packed_vel_data(p)
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((E, 4, 6)).astype(np.float32)
    u = rng.standard_normal((E, 4, 3)).astype(np.float32)
    trc = rng.standard_normal((E, 3, 12)).astype(np.float32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=p.device)

    def padded(x, rows):  # (E, n, C) -> (C*rows, E), pad rows 0
        out = np.zeros((x.shape[2], rows, E), np.float32)
        out[:, : x.shape[1]] = x.transpose(2, 1, 0)
        return dev(out.reshape(-1, E))

    sig_lm, u_lm = padded(sig, 8), padded(u, 8)
    tr_lm = padded(trc.transpose(0, 2, 1), 16)
    sig_p, u_p, tr_p = (dev(pack_state(sig, 4)), dev(pack_state(u, 4)),
                        dev(pack_traces(trc)))
    ops = {
        "padded K8 fused_vel2": (lambda: vel2_op(d_pad, sig_lm, tr_lm),
                                 bytes_bound_ms(d_pad, True)),
        "packed K8 fused_vel2": (lambda: vel2_op(d_pk, sig_p, tr_p),
                                 bytes_bound_ms(d_pk, True)),
        "K11 p1_pack_vel": (lambda: packed_vel_op(d_pr, sig_p, tr_p),
                            bytes_bound_ms(d_pk, True)),
        "padded K9 fused_stress2": (lambda: stress2_op(d_pad, u_lm, tr_lm),
                                    bytes_bound_ms(d_pad, False)),
        "packed K9 fused_stress2": (lambda: stress2_op(d_pk, u_p, tr_p),
                                    bytes_bound_ms(d_pk, False)),
    }
    rows = {}
    for name, (fn, bound) in ops.items():
        ms = events_ms(fn, n_steps)
        rows[name] = {"ms_per_op": ms, "bytes_bound_ms": bound}
        print(f"{name}: {ms:.4f} ms/op at E={E}, bytes bound {bound:.4f} "
              f"ms", flush=True)
    gpu, limit = gpu_name_and_power_limit(torch.device(device).index or 0)
    return {"probe": "p1_pack", "elements": E, "steps": n_steps, "gpu": gpu,
            "power_limit": limit, "ops": rows}


if __name__ == "__main__":
    print(json.dumps(main(*(int(a) for a in sys.argv[1:]))))
