"""Throughput benchmark: DOF-updates/s on one GPU, 3D explosive source.

Port of ``seigen_tpu/bench/throughput.py`` for the lane runners: the
merged LF4 runner (impl "merged"; "merged_pk" forces its P1
two-elements-per-lane layout, run it with ``--degree 1``), the v2
exchange-fused LF4 runner (impl "fused"), the v1 lane-major LF2/LF4 runner (impl
"lane", ``--order``), the unstructured lane runner (impl "lane_u", on the
scrambled case: cells randomly permuted, structure dropped, Morton order
from the cell centroids), the upwind-RK4 lane runner (impl "upwind_lane")
and the unstructured upwind-RK4 runner (impl "upwind_lane_u", on the
scrambled case; ``--panel-emit`` and ``--no-fused-axpy`` select its
panel-emission and glue steppers).  ``--vti`` hands the central-flux
runners (merged, fused, lane, lane_u) a per-element VTI Voigt stiffness,
so their stress kernels run the general Hooke law; any other impl refuses
rather than time isotropic physics under a row labelled vti.  A "DOF update" is
one field coefficient advanced one full timestep; the per-step DOF count is
E * n_p * (dim + n_sig).  The timed region is the runner's ``run_lm`` over
``n_steps`` steps, best of 3 after one warm-up run, each ending in
``torch.cuda.synchronize()``.

    python -m seigen_tpu_torch.bench.throughput            # n=24, P3, 100 steps
    python -m seigen_tpu_torch.bench.throughput --impl fused [--vti]
    python -m seigen_tpu_torch.bench.throughput --impl merged_pk --degree 1 \
        --n 32                # and --impl merged at the same size
    python -m seigen_tpu_torch.bench.throughput --impl lane --order 2
    python -m seigen_tpu_torch.bench.throughput --impl lane_u
    python -m seigen_tpu_torch.bench.throughput --impl lane_u --vti
    python -m seigen_tpu_torch.bench.throughput --impl upwind_lane
    python -m seigen_tpu_torch.bench.throughput --impl upwind_lane_u
    python -m seigen_tpu_torch.bench.throughput --kernel-impl reference

prints one JSON line.  The measurement needs a CUDA device and refuses to
run without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..mesh import box_mesh, build_discrete
from ..ops import Material, build_params, build_upwind_data, n_sig_for
from ..ops.anisotropic import vti_stiffness
from ..ops.structured_exchange import detect_structured
from ..solver.damping import absorbing_bc_fn, sponge_mask
from ..solver.lane_fused import FusedLaneRunner
from ..solver.lane_major import LaneMajorRunner
from ..solver.lane_merged import MergedLaneRunner
from ..solver.lane_unstructured import UnstructuredLaneRunner
from ..solver.lane_upwind import UpwindLaneRunner
from ..solver.lane_upwind_u import UnstructuredUpwindRunner
from ..solver.source import PointSource, build_sources
from ..solver.timestep import State, cfl_dt

# ONE material for the whole bench surface (the JAX bench's BENCH_MAT): the
# elastic parameters and the Godunov impedances stay consistent
BENCH_MAT = Material(rho=1.0, vp=2.0, vs=1.0)
IMPLS = ("merged", "upwind_lane", "lane", "lane_u", "upwind_lane_u",
         "fused", "merged_pk")
SCRAMBLED_IMPLS = ("lane_u", "upwind_lane_u")  # run on the scrambled case
RK4_IMPLS = ("upwind_lane", "upwind_lane_u")
# central flux: these take a stiffness
VTI_IMPLS = ("merged", "lane", "lane_u", "fused")


def scheme_name(impl: str, order: int) -> str:
    return "RK4" if impl in RK4_IMPLS else f"LF{order}"


@dataclass
class BenchResult:
    dof_updates_per_sec: float
    steps_per_sec: float
    n_elements: int
    n_dof: int
    degree: int
    n_steps: int
    seconds: float


def setup_case(
    n: int = 24,
    degree: int = 3,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    scramble: bool = False,
):
    """3D explosive-source case: unit box, free top, absorbing elsewhere.

    ``scramble`` randomly permutes the cell order (``default_rng(0)``) and
    drops the structure metadata, as the JAX ``setup_case`` does: the
    stand-in for a Gmsh unstructured import of the same geometry and
    physics (the ``lane_u`` and ``upwind_lane_u`` case).
    Returns (dm, p, src, damp, dt, state0) like the JAX ``setup_case``.
    """
    dim = 3
    absorb = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
    bc_fn = absorbing_bc_fn(((0.0, 1.0),) * dim, free_sides=[(2, "hi")])
    topo = box_mesh(n, n, n)
    if scramble:
        rng = np.random.default_rng(0)
        topo = replace(
            topo, cells=topo.cells[rng.permutation(topo.num_cells)],
            structure=None)
    dm = build_discrete(topo, degree, bc_fn=bc_fn)
    p = build_params(dm, BENCH_MAT, dtype=dtype, device=device)
    h_elem = float(dm.h.min())
    src = build_sources(
        dm,
        [PointSource(position=(0.5, 0.5, 0.8), f0=0.25 / h_elem,
                     radius=2 * h_elem)],
        dtype=dtype, device=device,
    )
    damp = torch.as_tensor(
        sponge_mask(dm, absorb, width=0.15), device=device).to(dtype)
    dt = cfl_dt(h_elem, 2.0, degree, cfl=0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    state0 = State(
        u=torch.zeros((E, n_p, dim), dtype=dtype, device=device),
        s=torch.zeros((E, n_p, n_sig_for(dim)), dtype=dtype, device=device),
    )
    return dm, p, src, damp, dt, state0


def bench_stiffness(impl: str, n_elements: int) -> np.ndarray:
    """The bench's (E, 6, 6) VTI stiffness (the JAX bench's Thomsen
    parameters on the bench material).  Refuses the impls that cannot run
    it: the upwind Riemann solver is isotropy-specific."""
    if impl not in VTI_IMPLS:
        raise ValueError(
            f"vti=True needs a central-flux lane runner {VTI_IMPLS}; "
            f"{impl!r} would time isotropic physics under a row labelled vti")
    C = vti_stiffness(2.0, 1.0, 1.0, epsilon=0.15, delta=0.05, gamma=0.1)
    return np.broadcast_to(C, (n_elements, 6, 6)).copy()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_runner(impl, dm, p, src, damp, dt, kernel_impl=None, visco=None,
                order=4, vti=False, **upwind_u):
    """The bench's lane runner: "merged" (LF4, MergedLaneRunner),
    "merged_pk" (the same with packed=True: P1 only), "fused"
    (LF4, FusedLaneRunner: K8/K9 and the K10 exchange), "lane"
    (LF ``order``, LaneMajorRunner), "lane_u" (LF ``order``,
    UnstructuredLaneRunner in Morton order of the cell centroids),
    "upwind_lane" (Godunov RK4, UpwindLaneRunner) or "upwind_lane_u"
    (Godunov RK4, UnstructuredUpwindRunner in Morton order; ``upwind_u``:
    its ``fused_axpy``/``panel_emit``).  The upwind runners take the bench
    material's impedances and ``visco`` (optional ViscoData); ``order``
    does not apply to them.  ``vti``: the stress operators of the four
    LF runners take ``bench_stiffness``.  kernel_impl: "kernel" (CUDA
    kernels) or "reference" (their plain PyTorch versions); default by
    device."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    stiffness = bench_stiffness(impl, dm.num_elements) if vti else None
    if impl in ("merged", "merged_pk", "fused") and order != 4:
        raise ValueError(f"the {impl} runner is LF4 only")
    if impl == "lane_u":
        return UnstructuredLaneRunner(
            p, dt, order=order, src=src, damp=damp, impl=kernel_impl,
            centroids=dm.coords.mean(axis=1), stiffness=stiffness)
    if impl == "upwind_lane_u":
        w = build_upwind_data(dm, BENCH_MAT, dtype=p.dtype, device=p.device)
        return UnstructuredUpwindRunner(
            p, w, dt, src=src, damp=damp, impl=kernel_impl, visco=visco,
            centroids=dm.coords.mean(axis=1), **upwind_u)
    ex = detect_structured(dm)
    if ex is None:
        raise ValueError(f"{impl} impl requires a structured mesh")
    if impl in ("merged", "merged_pk"):
        # merged_pk forces the packed layout; plain "merged" stays unpacked
        # at every degree, so the two compare at P1
        return MergedLaneRunner(p, ex, dt, src=src, damp=damp,
                                impl=kernel_impl, stiffness=stiffness,
                                packed=(impl == "merged_pk"))
    if impl == "fused":
        return FusedLaneRunner(p, ex, dt, src=src, damp=damp,
                               impl=kernel_impl, stiffness=stiffness)
    if impl == "lane":
        return LaneMajorRunner(p, ex, dt, order=order, src=src, damp=damp,
                               impl=kernel_impl, stiffness=stiffness)
    w = build_upwind_data(dm, BENCH_MAT, dtype=p.dtype, device=p.device)
    return UpwindLaneRunner(p, ex, w, dt, src=src, damp=damp,
                            impl=kernel_impl, visco=visco)


def measure(p, src, damp, dt, state0, dm, n_steps: int = 50,
            impl: str = "merged", kernel_impl: str | None = None,
            order: int = 4, vti: bool = False, **upwind_u) -> BenchResult:
    """Time ``n_steps`` of a lane runner (see make_runner), best of 3 after
    a warm-up."""
    runner = make_runner(impl, dm, p, src, damp, dt, kernel_impl,
                         order=order, vti=vti, **upwind_u)
    ulm, slm = runner.to_lm_state(state0)
    runner.run_lm(ulm, slm, n_steps)  # warm-up
    _sync(p.device)
    dt_wall = float("inf")
    for _ in range(3):
        _sync(p.device)
        t0 = time.perf_counter()
        runner.run_lm(ulm, slm, n_steps)
        _sync(p.device)
        dt_wall = min(dt_wall, time.perf_counter() - t0)
    dim = p.dim
    E, n_p = state0.u.shape[0], state0.u.shape[1]
    n_dof = E * n_p * (dim + n_sig_for(dim))
    return BenchResult(
        dof_updates_per_sec=n_dof * n_steps / dt_wall,
        steps_per_sec=n_steps / dt_wall,
        n_elements=E,
        n_dof=n_dof,
        degree=p.degree,
        n_steps=n_steps,
        seconds=dt_wall,
    )


def gpu_name_and_power_limit(device_index: int = 0):
    """(name, power limit) as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device_index}"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (x.strip() for x in out.split(",", 1))
    return name, limit


def report(res: BenchResult, impl: str, kernel_impl: str,
           device: torch.device | str = "cuda", order: int = 4,
           vti: bool = False, **upwind_u) -> dict:
    """The JSON line: the JAX bench's metric and detail keys, plus the
    GPU's name and power limit, which operator implementation ran, whether
    the VTI stiffness was on and the ``upwind_lane_u`` stepper options that
    were set."""
    dev = torch.device(device)
    name, limit = gpu_name_and_power_limit(dev.index or 0)
    return {
        "metric": "dof_updates_per_sec_per_chip_3d_explosive",
        "value": res.dof_updates_per_sec,
        "unit": "DOF-updates/s/chip",
        "vs_baseline": None,
        "detail": {
            "elements": res.n_elements,
            "dof": res.n_dof,
            "degree": res.degree,
            "steps": res.n_steps,
            "seconds": res.seconds,
            "steps_per_sec": res.steps_per_sec,
            "backend": "cuda",
            "impl": impl,
            "scheme": scheme_name(impl, order),
            "gpu": name,
            "power_limit": limit,
            "kernel_impl": kernel_impl,
            "vti": bool(vti),
            **upwind_u,
        },
    }


def add_vti_argument(ap) -> None:
    ap.add_argument("--vti", action="store_true",
                    help="merged, fused, lane, lane_u: a per-element VTI "
                    "stiffness (general Hooke law in the stress kernels)")


def add_upwind_u_arguments(ap) -> None:
    """The command-line switches of the ``upwind_lane_u`` steppers."""
    ap.add_argument("--panel-emit", action="store_true",
                    help="upwind_lane_u: the panel-emission stepper")
    ap.add_argument("--no-fused-axpy", action="store_true",
                    help="upwind_lane_u: the glue stepper (K6 + PyTorch "
                    "stage arithmetic)")


def upwind_u_options(a) -> dict:
    """Parsed switches -> the runner options that differ from the default
    stepper's (they also label the JSON line)."""
    opts = {"panel_emit": True} if a.panel_emit else {}
    if a.no_fused_axpy:
        opts["fused_axpy"] = False
    return opts


def main(n: int = 24, degree: int = 3, n_steps: int = 100,
         impl: str = "merged", device: str = "cuda",
         kernel_impl: str = "kernel", case=None, order: int = 4,
         vti: bool = False, **upwind_u) -> dict:
    """Measure a lane runner (``impl``, see measure) on the CUDA device;
    returns the JSON record.  ``case``: a ``setup_case`` result to reuse
    (impls "lane_u" and "upwind_lane_u" build the scrambled case)."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the throughput bench measures a CUDA device; "
                           "none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dm, p, src, damp, dt, state0 = case or setup_case(
        n=n, degree=degree, device=device,
        scramble=(impl in SCRAMBLED_IMPLS))
    res = measure(p, src, damp, dt, state0, dm, n_steps=n_steps, impl=impl,
                  kernel_impl=kernel_impl, order=order, vti=vti, **upwind_u)
    return report(res, impl, kernel_impl, device, order, vti=vti, **upwind_u)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--impl", default="merged", choices=IMPLS)
    ap.add_argument("--kernel-impl", default="kernel",
                    choices=("kernel", "reference"))
    ap.add_argument("--order", type=int, default=4, choices=(2, 4),
                    help="LF order of the lane and lane_u runners")
    add_vti_argument(ap)
    add_upwind_u_arguments(ap)
    a = ap.parse_args()
    opts = upwind_u_options(a)
    print(json.dumps(main(n=a.n, degree=a.degree, n_steps=a.steps,
                          impl=a.impl, kernel_impl=a.kernel_impl,
                          order=a.order, vti=a.vti, **opts)))
