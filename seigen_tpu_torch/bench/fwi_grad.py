"""A/B of the FWI gradient formulations: autograd through the roll-exchange
einsum step against the energy-conjugation engines (solver/lane_diff.py).

Port of ``seigen_tpu/bench/fwi_grad.py``.  Builds the layered 3D
acquisition of the FWI program (unit cube, free top, sponge on the other
five sides, two layers; shots on a line at depth 0.85, 16 receivers at
0.9), then per gradient path:

  vg_seconds    best wall time of one value-and-gradient over all shots
                (after a warm-up evaluation, unless ``warmup=False``)
  fwd_seconds   best wall time of one forward sweep over all shots, no
                autograd (the same path's operators)
  grad_to_fwd   vg_seconds / fwd_seconds
  peak_bytes    torch.cuda.max_memory_allocated during one gradient
                (None on the CPU)
  value         the misfit

and, for every path beside ``roll``, the cosine and the relative L2 (and
max) difference of its vp gradient against roll's.  Paths: ``roll``
(einsum autograd), ``lane`` (K4 SIG / K5 TR), ``merged`` (K1 / K2),
``merged_pk`` (K1pk / K2pk, P1) and ``lane_u`` (K4 TRAC SEL / K5 SEL on the
same mesh).  The observed data are numpy-seeded noise: the gradient of a
misfit, not an inversion.

    python -m seigen_tpu_torch.bench.fwi_grad [n] [degree] [steps] [repeats]

prints one JSON line per path and the record, with the GPU's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

PATHS = ("roll", "lane", "merged", "merged_pk", "lane_u")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(n, degree, n_steps, shots, segment, seed, dtype, device):
    """The layered 3D acquisition (module docstring)."""
    from ..mesh import box_mesh, build_discrete
    from ..ops import build_params
    from ..ops.structured_exchange import detect_structured
    from ..solver import PointSource, absorbing_bc_fn, build_receivers, \
        build_sources, cfl_dt, line, sponge_mask
    from ..solver.models import Layer, layered_model

    dm = build_discrete(
        box_mesh(n, n, n), degree,
        bc_fn=absorbing_bc_fn(((0.0, 1.0),) * 3, free_sides=[(2, "hi")]))
    mat0 = layered_model(dm, [
        Layer(bottom=-0.01, top=0.5, rho=1.2, vp=2.4, vs=1.2),
        Layer(bottom=0.5, top=1.01, rho=1.0, vp=2.0, vs=1.0)])
    p0 = build_params(dm, mat0, dtype=dtype, device=device)
    h = float(dm.h.min())
    dt = cfl_dt(h, 2.4, degree, 0.4)
    if segment:
        if n_steps < segment:
            raise ValueError(f"n_steps {n_steps} < segment {segment}")
        n_steps -= n_steps % segment
    f0 = 0.15 * 2.4 / h / (degree + 1)
    src_list = [
        build_sources(dm, [PointSource(position=(float(x), 0.5, 0.85), f0=f0,
                                       radius=2 * h)],
                      dtype=dtype, device=device)
        for x in np.linspace(0.25, 0.75, shots)]
    rcv = build_receivers(dm, line((0.1, 0.5, 0.9), (0.9, 0.5, 0.9), 16),
                          dtype=dtype, device=device)
    damp = torch.as_tensor(sponge_mask(
        dm, [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")],
        width=0.15), device=device).to(dtype)
    rng = np.random.default_rng(seed)
    obs = 0.01 * rng.standard_normal((shots, n_steps, 16, 3))
    return dict(dm=dm, p0=p0, ex=detect_structured(dm), dt=dt,
                n_steps=n_steps, src_list=src_list, rcv=rcv, damp=damp,
                obs=obs)


def roll_engine(c, segment):
    """(vg, fwd) of the roll path: autograd through the einsum step on the
    structured roll exchange, one shot after the other."""
    from ..ops.structured_exchange import make_structured_ops
    from ..solver import State
    from ..solver.adjoint import make_fwi_gradient, run_segmented, \
        with_material

    dm, p0 = c["dm"], c["p0"]
    E, n_p = dm.num_elements, dm.re.n_p
    st0 = State(u=p0.Ginv.new_zeros((E, n_p, 3)),
                s=p0.Ginv.new_zeros((E, n_p, 6)))
    vo, so = make_structured_ops(c["ex"])
    vgs = [make_fwi_gradient(p0, st0, c["dt"], c["n_steps"], s, c["rcv"],
                             c["obs"][k], fields=("vp",), damp=c["damp"],
                             segment=segment, vel_op=vo, stress_op=so)[0]
           for k, s in enumerate(c["src_list"])]

    def vg(th):
        tot_v, tot_g = 0.0, None
        for vg_k in vgs:
            v, g = vg_k(th)
            tot_v += v
            tot_g = g if tot_g is None else {k: tot_g[k] + g[k] for k in g}
        return tot_v, tot_g

    @torch.no_grad()
    def fwd(th):
        p = with_material(p0, **th)
        return [run_segmented(p, st0, c["dt"], c["n_steps"], src=s,
                              damp=c["damp"], receivers=c["rcv"],
                              vel_op=vo, stress_op=so)[1].cpu()
                for s in c["src_list"]]

    return vg, fwd


def lane_engine(c, path, segment):
    """(vg, fwd) of a LaneDiffFwi engine."""
    from ..solver.lane_diff import LaneDiffFwi
    from ..solver.shots import stack_shots

    ldf = LaneDiffFwi(
        c["p0"], c["dm"], c["ex"], c["dt"], c["n_steps"],
        stack_shots(c["src_list"]), c["rcv"], c["obs"], damp=c["damp"],
        segment=segment, engine="merged" if path == "merged_pk" else path,
        packed=path == "merged_pk")
    return ldf.vg_factory(None), ldf.synth


def best_seconds(fn, dev, repeats):
    best, out = float("inf"), None
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def run(n=24, degree=1, n_steps=200, repeats=2, shots=2, segment=20,
        seed=0, paths=("roll", "lane", "merged"), device="cuda",
        dtype=torch.float32, out_path=None, log=print, warmup=True):
    """Measure ``paths`` (module docstring); returns the record.
    ``warmup=False`` skips the warm-up evaluation (the kernels must be
    built already, as in chip_smoke.py)."""
    from ..solver.adjoint import theta_of_params

    dev = torch.device(device)
    c = setup(n, degree, n_steps, shots, segment, seed, dtype, dev)
    E = c["dm"].num_elements
    theta = {"vp": theta_of_params(c["p0"])["vp"].detach()}
    out = {"E": E, "degree": degree, "n_steps": c["n_steps"],
           "shots": shots, "segment": segment, "device": str(dev)}
    if dev.type == "cuda":
        from .throughput import gpu_name_and_power_limit

        out["gpu"], out["power_limit"] = gpu_name_and_power_limit(
            dev.index or 0)
    grads = {}
    for path in paths:
        if path not in PATHS:
            raise ValueError(f"unknown path {path!r}; one of {PATHS}")
        vg, fwd = (roll_engine(c, segment) if path == "roll"
                   else lane_engine(c, path, segment))
        if warmup:
            vg(theta)  # kernel builds, allocator
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t_vg, (v, g) = best_seconds(lambda: vg(theta), dev, repeats)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        t_fwd, _ = best_seconds(lambda: fwd(theta), dev, repeats)
        grads[path] = g["vp"].detach().double().cpu().numpy()
        out[path] = {"vg_seconds": t_vg, "fwd_seconds": t_fwd,
                     "grad_to_fwd": t_vg / t_fwd, "peak_bytes": peak,
                     "value": v}
        log(json.dumps({path: out[path]}))
        del vg, fwd
    if "roll" in grads:
        a = grads["roll"]
        for path, b in grads.items():
            if path == "roll":
                continue
            out[path]["grad_cosine_vs_roll"] = float(
                np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                + 1e-300))
            out[path]["grad_rel_l2_vs_roll"] = float(
                np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-300))
            out[path]["grad_rel_maxdiff_vs_roll"] = float(
                np.abs(a - b).max() / (np.abs(a).max() + 1e-300))
    log(json.dumps(out))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=24)
    ap.add_argument("degree", type=int, nargs="?", default=1)
    ap.add_argument("steps", type=int, nargs="?", default=200)
    ap.add_argument("repeats", type=int, nargs="?", default=2)
    ap.add_argument("--shots", type=int, default=2)
    ap.add_argument("--segment", type=int, default=20)
    ap.add_argument("--paths", type=str, default="roll,lane,merged")
    ap.add_argument("--out", type=str, default=None,
                    help="write the record JSON here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the gradient A/B measures a CUDA device; none is "
                         "available")
    torch.backends.cuda.matmul.allow_tf32 = False
    run(n=a.n, degree=a.degree, n_steps=a.steps, repeats=a.repeats,
        shots=a.shots, segment=a.segment, paths=tuple(a.paths.split(",")),
        out_path=a.out)
