"""Compulsory bytes and operations of the port's kernels, and the byte
model of the merged LF4 step.

Port of ``seigen_tpu/bench/roofline.py`` for the port's layout, and the
one home of the port's bound arithmetic (``chip_smoke.py``, the pack probe
and the curvilinear A/B call it).  A kernel launch's bound is the larger
of its compulsory bytes — each input read once, each output written once,
at the shapes of the operator data it is given — over the H100's published
3.35 TB/s, and its Dr and LIFT matrix-product FLOPs over the published 67
TFLOP/s FP32 rate.  Rows are float32 rows per lane: one lane holds one
element (``n_par`` of them on the packed P1 layout).

``itemize`` counts the bytes of one merged LF4 step (``MergedLaneRunner``,
solver/timestep.py:compose_lf_step_traced): six K1/K2 launches — vel with
the kernel-fused source, stress, vel + axpy, stress + source, vel, stress
+ axpy + sponge — at their variants' compulsory rows, and the end-of-step
u damping multiply.  The port's merged plan reads each neighbour trace
once through an indexed link table: there are no windows, and the
constant tables are a few KiB read through the cache, so they are not
counted.  Host-side only (builds the runner on the CPU):

    python -m seigen_tpu_torch.bench.roofline --n 24 --degree 3 \\
        [--measured-ms 0.72] [--bw 3.35e12]
"""

from __future__ import annotations

import argparse
import json

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peaks
FP32_FLOPS_PER_S = 67e12


def bound_of(rows: float, flops: float, lanes: int,
             bw: float = HBM_BYTES_PER_S) -> tuple:
    """(bound_ms, "bytes" | "operations"): ``rows`` float32 rows and
    ``flops`` FLOPs per lane over ``lanes`` lanes."""
    t_bytes = 4.0 * rows * lanes / bw * 1e3
    t_ops = float(flops) * lanes / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _product_flops(dim, n_p, nft, c_out, n_par=1):
    """Dr and LIFT products of one lane: 2 x (c_out dim n_p^2 + c_out n_p
    nft) per element."""
    return 2 * n_par * (c_out * dim * n_p * n_p + c_out * n_p * nft)


def bound_rows(d, plan, kname, aniso=False, variant="plain"):
    """Float rows per lane that one launch of K1 (``merged_vel``), K2
    (``merged_stress``) or K3 (``upwind_rhs``) must move: the live rows of
    its input (n_p per component), the neighbour payload rows, the
    geo/impedance/mask rows the operator reads, each per element (n_par of
    them a lane), and the variant's own operands — the axpy rows ax0 and
    ax1 (C_out x n_p live rows each), the damping rows (n_p) and the dense
    source rows (C_out x n_p a group) — plus the full output and trace
    arrays written.  aniso: K2 reads the n_sig^2 stiffness rows instead of
    lambda and mu."""
    dim, n_p, nf, nfp, npp = d.dim, d.n_p, d.nf, d.n_fp, d.npp
    nft = nf * nfp
    geo = dim * dim + dim * nf  # Ginv, normals
    if kname == "merged_vel":  # sigma in, u out; scb, bfs, 1/rho
        c_in, c_out, geo = d.n_sig, dim, geo + 2 * nf + 1
    elif kname == "merged_stress":  # u in, sigma out; scb, dfs, lam, mu
        c_in, c_out = dim, d.n_sig
        geo += 2 * nf + (d.n_sig * d.n_sig if aniso else 2)
    else:  # u, sigma in and out; scb, 1/rho, lam, mu; 4*nf + 2 uwg rows
        c_in = c_out = dim + d.n_sig
        geo += nf + 3 + 4 * nf + 2
    extra = 0
    if variant.startswith("axpy"):
        extra += 2 * c_out * n_p + (n_p if variant == "axpy_damp" else 0)
    elif variant.startswith("inject"):
        extra += int(variant[-1]) * c_out * n_p
    return d.n_par * (c_in * n_p + plan.pay * nft + geo + nf + extra) \
        + c_out * npp + nf * plan.rtf


def merged_flops(d, kname):
    """FLOPs per lane of one K1/K2/K3 launch."""
    c_out = {"merged_vel": d.dim, "merged_stress": d.n_sig}.get(
        kname, d.dim + d.n_sig)
    return _product_flops(d.dim, d.n_p, d.nf * d.n_fp, c_out, d.n_par)


def bound(d, plan, kname, aniso=False, variant="plain"):
    """(bound_ms, "bytes" | "operations") of one launch of a K1/K2/K3
    variant at these shapes: the bytes of ``bound_rows`` over the memory
    rate, and the Dr and LIFT matrix-product FLOPs of every element over
    the FP32 rate."""
    return bound_of(bound_rows(d, plan, kname, aniso, variant),
                    merged_flops(d, kname), plan.Ls)


LANE_VEL_MODES = ("SIG", "TRAC", "SEL vel")  # K4; "TR", "SEL stress": K5


def lane_bound(d, mode, aniso=False):
    """(bound_ms, "bytes" | "operations") of one launch of a K4/K5 mode:
    compulsory bytes (state rows n_p per component, the neighbour payload
    rows the mode reads — for SEL the selected panel rows, the combo and
    the sign rows —, the geometry counted per face as in ``bound`` (Ginv,
    normals, Fscale, beta or delta; the kernel reads them expanded to face
    nodes) and the material rows, the output written at npp rows) over
    the memory rate, and the Dr and LIFT FLOPs over the FP32 rate.  aniso:
    a stress mode reads the n_sig^2 stiffness rows instead of lambda and
    mu."""
    dim, n_p, ftp, npp, n_sig = d.dim, d.n_p, d.ftp, d.npp, d.n_sig
    nf = d.nf
    vel = mode in LANE_VEL_MODES
    c_in, c_out = (n_sig, dim) if vel else (dim, n_sig)
    payload = {"SIG": n_sig * ftp, "TRAC": dim * ftp, "TR": dim * ftp,
               "SEL vel": dim * ftp + 2 * nf,
               "SEL stress": dim * ftp + nf}[mode]
    geo = dim * dim + dim * nf + 2 * nf + (
        1 if vel else n_sig * n_sig if aniso else 2)
    rows = c_in * n_p + payload + geo + c_out * npp
    return bound_of(rows, _product_flops(dim, n_p, ftp, c_out), d.E)


UPWIND_U_MODES = {  # mode -> None (K6) or K7's (stage, damp, groups, emit)
    "rhs": None,
    "stage": (True, False, 0, False),
    "final": (False, False, 0, False),
    "final damp": (False, True, 0, False),
    "stage inject1": (True, False, 1, False),
    "final damp inject2": (False, True, 2, False),
    "stage emit": (True, False, 0, True),
    "final damp emit": (False, True, 0, True)}


def upwind_u_rows(d, mode):
    """Float rows per lane that one launch of K6 or a K7 mode must move:
    u and sigma, and for K7 the accumulator, the base state, the sponge
    row and the dense patterns the mode reads, at n_p rows per component;
    the selected rows of both panels; the geometry counted per face as in
    ``lane_bound`` — Ginv, normals, Fscale, the neighbour impedances, the
    combo and both sign rows — and the material and own-impedance rows;
    the output, with the emitted panels, as written."""
    dim, n_p, ftp, npp, nf = d.dim, d.n_p, d.ftp, d.npp, d.nf
    c = dim + d.n_sig
    spec = UPWIND_U_MODES[mode] or (False, False, 0, False)
    stage, damp, n_inj, emit = spec
    axpy = UPWIND_U_MODES[mode] is not None
    state_in = c * n_p * (1 + axpy + stage + n_inj) + (n_p if damp else 0)
    geo = dim * dim + dim * nf + nf + 3 + 2 * nf + 2 + 3 * nf
    out = c * npp * (2 if stage else 1) + (2 * dim * d.ftpp if emit else 0)
    return state_in + 2 * dim * ftp + geo + out


def upwind_u_bound(d, mode):
    """(bound_ms, "bytes" | "operations") of one launch of K6 or a K7
    mode: the bytes of ``upwind_u_rows`` over the memory rate, and the Dr
    and LIFT FLOPs over the FP32 rate."""
    return bound_of(upwind_u_rows(d, mode),
                    _product_flops(d.dim, d.n_p, d.ftp, d.dim + d.n_sig),
                    d.E)


def fused_rows(d, kname, aniso=False, variant="plain"):
    """Float rows per lane that one launch of a K8/K9 variant or of K10
    must move.  K8/K9: state rows n_p per component, the dim*ftp consumer
    trace rows, the geometry once per face (Ginv, normals, scb, bfs or dfs)
    and the material rows (1/rho; lambda and mu, or the n_sig^2 stiffness
    rows), and the variant's own axpy rows (2 x C_out x n_p) and sponge
    row (n_p), each per element (n_par of them a lane); the output at npp
    and its dim*ftpp trace rows written.  K10: dim*ftp rows and nf mask
    rows read, dim*ftpp rows written."""
    dim, n_p, nf, npp, n_sig = d.dim, d.n_p, d.nf, d.npp, d.n_sig
    ftp, ftpp = d.ftp // d.n_par, d.ftpp
    if kname == "trace_exchange":
        return dim * ftp + nf + dim * ftpp
    geo = dim * dim + dim * nf + 2 * nf
    if kname == "fused_vel2":
        c_in, c_out, geo = n_sig, dim, geo + 1
    else:
        c_in, c_out = dim, n_sig
        geo += n_sig * n_sig if aniso else 2
    extra = 0
    if variant.startswith("axpy"):
        extra = 2 * c_out * n_p + (n_p if variant == "axpy_damp" else 0)
    return d.n_par * (c_in * n_p + dim * ftp + geo + extra) + c_out * npp \
        + dim * ftpp


def fused_bound(d, kname, aniso=False, variant="plain"):
    """(bound_ms, "bytes" | "operations") of one launch of a K8/K9 variant
    or of K10 at these shapes: the bytes of ``fused_rows`` over the memory
    rate, and the Dr and LIFT FLOPs over the FP32 rate (K10 does no
    arithmetic)."""
    flops = 0
    if kname != "trace_exchange":
        c_out = d.dim if kname == "fused_vel2" else d.n_sig
        flops = _product_flops(d.dim, d.n_p, d.ftp // d.n_par, c_out,
                               d.n_par)
    return bound_of(fused_rows(d, kname, aniso, variant), flops,
                    d.E // d.n_par)


def curvi_step_bound(E, dim, n_p, nf, nfq, n_sig):
    """(bound_ms, "bytes" | "operations", bytes bound ms, FP32 bound ms)
    of one curvilinear LF4 step (ops/curvilinear.py): 6 operator
    applications, each dominated by the per-element De (E, dim, n_p, n_p)
    and Lf (E, nf, n_p, nfq) contractions (vel and stress averaged) and
    their table reads, with the face normals at the quadrature points."""
    flops = 6 * 2 * (dim * n_p * n_p + nf * n_p * nfq) * (n_sig + dim) / 2
    rows = 6 * (dim * n_p * n_p + nf * n_p * nfq + nf * nfq * dim)
    t_bytes, t_ops = bound_of(rows, 0, E)[0], bound_of(0, flops, E)[0]
    return (*bound_of(rows, flops, E), t_bytes, t_ops)


# the merged LF4 step: (op, kernel, variant of the step's launch)
STEP_OPS = (("vel1(+src)", "merged_vel", "src"),
            ("stress1", "merged_stress", "plain"),
            ("vel_axpy", "merged_vel", "axpy"),
            ("stress_src", "merged_stress", "src"),
            ("vel2", "merged_vel", "plain"),
            ("stress_axpy", "merged_stress", "axpy_damp"))


def step_rows(runner) -> dict:
    """Float rows per lane of each launch of one merged LF4 step of
    ``runner`` (a MergedLaneRunner) and of its u damping multiply (read
    u, write u, one damping row block)."""
    d, plan = runner.d, runner.plan
    groups = len(runner.src_dense) if runner.src_dense is not None else 0
    damp = d.damp is not None
    aniso = d.off[6] >= 0  # the C section: K2's general Hooke law
    rows = {}
    for op, kname, variant in STEP_OPS:
        if variant == "src":
            variant = f"inject{groups}" if groups else "plain"
        elif variant == "axpy_damp" and not damp:
            variant = "axpy"
        rows[op] = bound_rows(d, plan, kname, aniso, variant)
    rows["damp_u"] = (2 * d.dim * d.npp + d.npp) * d.n_par if damp else 0
    return rows


def itemize(n=24, degree=3, packed=False) -> dict:
    """Bytes and FLOPs of one merged LF4 step on the throughput bench's
    case (``setup_case(n, degree)``, 3D, the sponge and one blob source),
    built on the CPU."""
    from ..ops.structured_exchange import detect_structured
    from ..solver.lane_merged import MergedLaneRunner
    from .throughput import setup_case

    dm, p, src, damp, dt, _ = setup_case(n=n, degree=degree, device="cpu")
    r = MergedLaneRunner(p, detect_structured(dm), dt, src=src, damp=damp,
                         impl="reference", packed=packed)
    rows = step_rows(r)
    Ls = r.plan.Ls
    flops = sum(merged_flops(r.d, kname) for _, kname, _ in STEP_OPS) * Ls
    total = 4 * sum(rows.values()) * Ls
    return {
        "config": {"n": n, "degree": degree, "dim": 3, "E": dm.num_elements,
                   "packed": bool(r.n_par == 2), "lanes": Ls,
                   "npp": r.d.npp, "rtf": r.plan.rtf,
                   "src_groups": (len(r.src_dense) if r.src_dense is not None
                                  else 0)},
        "rows_per_lane": rows,
        "per_op_MB": {k: 4 * v * Ls / 1e6 for k, v in rows.items()},
        "bytes_per_step": total,
        "MB_per_step": total / 1e6,
        "flops_per_step": flops,
    }


def main(n=24, degree=3, packed=False, bw=HBM_BYTES_PER_S,
         measured_ms=None) -> dict:
    """``itemize`` plus the step's bound at ``bw`` and, given the measured
    step time, the share of it the bound explains."""
    out = itemize(n=n, degree=degree, packed=packed)
    out["bw_GBs"] = bw / 1e9
    out["bytes_bound_ms"] = out["bytes_per_step"] / bw * 1e3
    out["fp32_bound_ms"] = out["flops_per_step"] / FP32_FLOPS_PER_S * 1e3
    out["roofline_ms"] = max(out["bytes_bound_ms"], out["fp32_bound_ms"])
    if measured_ms is not None:
        out["measured_ms"] = measured_ms
        out["roofline_fraction"] = out["roofline_ms"] / measured_ms
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--packed", action="store_true",
                    help="the P1 two-elements-per-lane layout")
    ap.add_argument("--bw", type=float, default=HBM_BYTES_PER_S,
                    help="memory rate, B/s (default: the H100's published "
                    "3.35e12)")
    ap.add_argument("--measured-ms", type=float, default=None,
                    help="a measured merged LF4 step, ms (bench/"
                    "throughput.py --impl merged)")
    a = ap.parse_args()
    print(json.dumps(main(a.n, a.degree, a.packed, a.bw, a.measured_ms),
                     indent=1))
