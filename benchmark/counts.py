"""What a step of the explosive-source runs must compute and move.

Everything here is worked out from the shapes of the problem (dimension,
nodes per element, faces, face nodes, elements) and never from a runner:

- ``dof``: field coefficients advanced by one step, E n_p (dim + n_sig);
- ``step_flops``: the least FLOPs of a step, per element — one operator
  application costs 2 (dim^2 n_p^2 + C_out n_p nf n_fp) with the Dr
  products taken after the Ginv contraction; LF4 applies 3 velocity and 3
  stress operators, upwind RK4 four coupled right-hand sides of
  2 (2 dim^2 n_p^2 + (dim + n_sig) n_p nf n_fp);
- ``kernel_bound_ms``: the least time of a step's launches of one kernel
  family, each the larger of its compulsory bytes over the memory rate and
  its least FLOPs over the FP32 rate.  The byte rows per lane are a frozen
  copy of the port's compulsory-row counts of K1/K2/K3 and K4/K5 at the
  layout's padded row counts (npp = n_p rounded up to 8; a face's trace
  block roundup(pay n_fp, 8) rows).

The peaks are NVIDIA's published H100 SXM figures.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def n_sig(dim: int) -> int:
    return 3 if dim == 2 else 6


def _rup(x: int, m: int = 8) -> int:
    return (x + m - 1) // m * m


def dof(E: int, n_p: int, dim: int) -> int:
    """Field coefficients a step advances."""
    return E * n_p * (dim + n_sig(dim))


def op_flops(dim, n_p, nf, n_fp, c_out) -> int:
    """Least FLOPs of one central-flux operator on one element."""
    return 2 * (dim * dim * n_p * n_p + c_out * n_p * nf * n_fp)


def step_flops(scheme: str, dim, n_p, nf, n_fp) -> int:
    """Least FLOPs of one step on one element: "lf4" or "rk4"."""
    if scheme == "lf4":
        return 3 * (op_flops(dim, n_p, nf, n_fp, dim)
                    + op_flops(dim, n_p, nf, n_fp, n_sig(dim)))
    if scheme == "rk4":
        return 4 * 2 * (2 * dim * dim * n_p * n_p
                        + (dim + n_sig(dim)) * n_p * nf * n_fp)
    raise ValueError(f"unknown scheme {scheme!r}")


def merged_rows(dim, n_p, nf, n_fp, kname, variant="plain") -> int:
    """Float rows per lane one launch of K1 ("vel"), K2 ("stress") or K3
    ("upwind") must move: the live input rows, the neighbour payload rows,
    the geometry, impedance and mask rows, the variant's own rows (axpy:
    2 C_out n_p, + n_p with the sponge; inject<g>: g C_out n_p), and the
    padded output and trace arrays written."""
    nft, npp, ns = nf * n_fp, _rup(n_p), n_sig(dim)
    geo = dim * dim + dim * nf
    if kname == "vel":
        c_in, c_out, pay, geo = ns, dim, dim, geo + 2 * nf + 1
    elif kname == "stress":
        c_in, c_out, pay, geo = dim, ns, dim, geo + 2 * nf + 2
    elif kname == "upwind":
        c_in = c_out = dim + ns
        pay, geo = 2 * dim, geo + nf + 3 + 4 * nf + 2
    else:
        raise ValueError(kname)
    extra = 0
    if variant.startswith("axpy"):
        extra = 2 * c_out * n_p + (n_p if variant == "axpy_damp" else 0)
    elif variant.startswith("inject"):
        extra = int(variant[len("inject"):]) * c_out * n_p
    rtf = _rup(pay * n_fp)
    return c_in * n_p + pay * nft + geo + nf + extra + c_out * npp \
        + nf * rtf


def lane_sel_rows(dim, n_p, nf, n_fp, kname) -> int:
    """Float rows per lane one launch of K4 TRAC SEL ("vel") or K5 SEL
    ("stress") must move: state rows, the selected panel rows with the
    combo and sign rows, the geometry per face, the material rows and the
    padded output."""
    ftp, npp, ns = nf * n_fp, _rup(n_p), n_sig(dim)
    vel = kname == "vel"
    c_in, c_out = (ns, dim) if vel else (dim, ns)
    payload = dim * ftp + (2 * nf if vel else nf)
    geo = dim * dim + dim * nf + 2 * nf + (1 if vel else 2)
    return c_in * n_p + payload + geo + c_out * npp


# a step's launches of each kernel family: (kernel, variant) in order
STEPS = {
    # MergedLaneRunner's LF4: K1 with the fused source, K2, K1 + axpy,
    # K2 with the fused source, K1, K2 + axpy + sponge
    "merged": (("vel", "inject1"), ("stress", "plain"), ("vel", "axpy"),
               ("stress", "inject1"), ("vel", "plain"),
               ("stress", "axpy_damp")),
    # UnstructuredLaneRunner's LF4: 3 K4 TRAC SEL, 3 K5 SEL
    "lane_sel": (("vel", "sel"),) * 3 + (("stress", "sel"),) * 3,
    # UpwindLaneRunner's RK4: 4 K3, each with the fused source
    "upwind": (("upwind", "inject1"),) * 4,
}


def launch_bound_ms(family, dim, n_p, nf, n_fp, E, kname, variant):
    if family == "lane_sel":
        rows = lane_sel_rows(dim, n_p, nf, n_fp, kname)
    else:
        rows = merged_rows(dim, n_p, nf, n_fp, kname, variant)
    if kname == "upwind":
        flops = step_flops("rk4", dim, n_p, nf, n_fp) // 4
    else:
        flops = op_flops(dim, n_p, nf, n_fp,
                         dim if kname == "vel" else n_sig(dim))
    return 1e3 * max(4.0 * rows * E / HBM_BYTES_PER_S,
                     float(flops) * E / FP32_FLOPS_PER_S)


def kernel_bound_ms(family: str, dim, n_p, nf, n_fp, E) -> float:
    """Least milliseconds of one step's launches of a kernel family."""
    return sum(launch_bound_ms(family, dim, n_p, nf, n_fp, E, k, v)
               for k, v in STEPS[family])
