"""What decides ``correct``: the program's chunks against the reference.

The reference (``reference/``) builds its own mesh, operator data,
source, sponge and receivers from the run's inputs and follows two of
the program's chunks: the first from the zero state, and the window's
last from the state the program handed to it.  Five numbers are
compared, each against the cell's limit:

- ``start_u``, ``start_s``, ``last_u``, ``last_s``: the relative L2 gap
  of the chunk's final velocity and stress;
- ``last_seis``: the widest gap of a seismogram sample of the last chunk,
  over the reference's largest sample there, or over a thousandth of the
  reference's largest velocity where the receivers see less (a receiver
  on a face is held to the closest of the elements that share it).  The
  first chunk's seismograms are not compared: the source's pulse has not
  reached the receivers by then.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .inputs import Inputs
from .reference import physics
from .reference.mesh import build_mesh

NUMBERS = ("start_u", "start_s", "last_u", "last_s", "last_seis")
SEIS_FLOOR = 1e-3  # of the largest velocity: receivers that see less


class Reference:
    """The reference's case for a run's inputs."""

    def __init__(self, inp: Inputs, scheme: str, device, dtype=torch.float32,
                 tf32: bool = False):
        self.tf32 = tf32  # True only for the control
        self.mesh = m = build_mesh(inp.vertices, inp.cells, inp.degree,
                                   top=inp.extents[-1][1])
        self.p = physics.params(m, inp.rho, inp.vp, inp.vs, dtype, device)
        self.p.tf32 = tf32
        self.src = physics.explosive_source(m, inp.source, inp.f0,
                                            inp.radius, dtype, device)
        self.damp = torch.as_tensor(physics.sponge(
            m, inp.absorb_sides, inp.sponge_width), device=device).to(dtype)
        self.rcv = physics.receivers(m, inp.receivers, dtype, device)
        self.step = physics.SCHEMES[scheme]
        self.dt = inp.dt
        self.dtype, self.device = dtype, device

    def run(self, u, s, k: int, step0: int):
        """k steps from (u, s); returns (u, s, samples (k, R, kmax, dim)).
        Float32 products run with TF32 off; the control's operands are
        rounded to TF32 and the card's TF32 products are allowed."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            with torch.no_grad():
                return self.step(self.p, self.src, self.damp, self.rcv,
                                 u.to(self.device, self.dtype),
                                 s.to(self.device, self.dtype), self.dt, k,
                                 step0)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double(), ref.to(a.device).double()
    return _finite(float(torch.linalg.vector_norm(a - ref)
                         / torch.linalg.vector_norm(ref)))


def seis_gap(seis, ref_samples: torch.Tensor, u_ref: torch.Tensor) -> float:
    """Widest sample gap, per receiver at the closest of its candidate
    elements, over max(largest reference sample, SEIS_FLOOR max|u_ref|)."""
    ref = ref_samples.double()
    prog = torch.as_tensor(np.asarray(seis), dtype=torch.float64,
                           device=ref.device)  # (k, R, dim)
    gap = (prog[:, :, None, :] - ref).abs().amax(dim=(0, 3))  # (R, kmax)
    scale = max(float(ref.abs().max()),
                SEIS_FLOOR * float(u_ref.double().abs().max()))
    return _finite(float(gap.amin(dim=1).max()) / scale)


def gaps(chunk: str, ref_out, st_out, seis) -> dict:
    """The chunk's numbers against the reference's ``(u, s, samples)``
    (``last`` also its seismograms)."""
    u, s, samples = ref_out
    out = {f"{chunk}_u": rel_l2(st_out.u.to(u.device), u),
           f"{chunk}_s": rel_l2(st_out.s.to(s.device), s)}
    if chunk == "last":
        out["last_seis"] = seis_gap(seis, samples, u)
    return out


def compare(ref: Reference, chunk: str, st_in, st_out, seis, k, step0):
    """The chunk's numbers, the reference run from ``st_in``."""
    return gaps(chunk, ref.run(st_in.u, st_in.s, k, step0), st_out, seis)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, chunks that failed, {name: {"value", "limit"}}); a number
    with no limit, or not finite, fails."""
    out, bad = {}, set()
    for name in NUMBERS:
        v, lim = numbers.get(name, math.inf), limits.get(name)
        out[name] = {"value": v, "limit": lim}
        if lim is None or not math.isfinite(v) or v > lim:
            bad.add(name.split("_")[0])
    return not bad, len(bad), out
