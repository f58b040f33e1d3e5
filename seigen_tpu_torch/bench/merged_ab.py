"""Operator kernels of two source trees, timed in turns.

    python -m seigen_tpu_torch.bench.merged_ab --trees parent=_archive/parent,change=.
    python -m seigen_tpu_torch.bench.merged_ab --family upwind --trees ...
    python -m seigen_tpu_torch.bench.merged_ab --family fused --trees ...
    python -m seigen_tpu_torch.bench.merged_ab --family lane --trees ...
    python -m seigen_tpu_torch.bench.merged_ab --family packed --trees ...

Each tree is a checkout of the repository (``git archive <commit> | tar -x
-C _archive/parent`` puts an older one beside this one).  The trees run in
the turns parent, change, change, parent (the first tree named is the
"parent"), one process each: a process imports ``seigen_tpu_torch`` from its
tree, builds that tree's kernels and, on the bench case
(``throughput.setup_case``, n=24 P3 by default), times every variant of K1
and K2 that the LF4 main path launches on numpy-seeded operands in the
runner's layout — K1 plain, axpy, 1 and 2 source groups; K2 plain, axpy,
axpy + damping, 1 and 2 source groups, and with the bench's VTI stiffness
(general Hooke law) plain and axpy + damping — with CUDA events (mean over
``--reps`` launches after 3 warm-up launches); then it runs the throughput
bench (impl "merged", and with ``--vti``).

``--family upwind`` times the two Godunov kernels instead: every variant
of K3 upwind_rhs (plain, 1 and 2 source groups, and plain on an acoustic
vs = 0 half of the mesh) on the bench case in the ``upwind_lane`` runner's
layout, and K6 and every K7 mode (stage, final, final + sponge row, 1 and
2 source groups, panel emission) on its scrambled copy in the
``upwind_lane_u`` runner's layout; then the benches ``upwind_lane``,
``upwind_lane_u``, ``upwind_lane_u --panel-emit`` and ``upwind_lane_u
--no-fused-axpy`` (the glue stepper, K6), and in each tree's first turn
``profile_step.profile`` of the same four steps.

``--family fused`` times the v2 engine's operator kernels: every variant
of K9 fused_stress2 that the ``fused`` step launches — plain, axpy, axpy
+ damping, and with the bench's VTI stiffness plain and axpy + damping —
and K8 fused_vel2 plain and axpy, on the bench case in the ``fused``
runner's layout; then the benches ``fused`` and ``fused --vti``, and in
each tree's first turn ``profile_step.profile`` of the ``fused`` step.

``--family lane`` times the v1 lane engine's kernels: every mode of K5
lane_stress that a step launches — TR on the bench case in the ``lane``
runner's layout, SEL on its scrambled copy in the ``lane_u`` runner's, and
both with the bench's VTI stiffness (general Hooke law) — and every mode
of K4 lane_vel, SIG on the bench case, TRAC and SEL on its scrambled copy;
then the benches ``lane --order 2``, ``lane`` (LF4),
``lane_u`` and ``lane --vti``, and in each tree's first turn
``profile_step.profile`` of ``lane --order 2`` and ``lane_u``.

``--family packed`` runs at n=32 P1 (unless ``--n``/``--degree`` say
otherwise) and times the packed tile kernels on the P1 layout of two
elements a lane: K1pk in the ``merged_pk`` runner's layout — plain, axpy,
1 and 2 source groups —, K9pk and K8pk on numpy-seeded packed v2
operands — K9pk plain, axpy, axpy + damping; K8pk plain and axpy —, K11
on the same sigma and traces with the P1 pack probe's geo
(``p1_pack_probe.build_packed_vel_data``), and as controls K2pk plain and
axpy + damping and the unpacked K1 plain on the same case; then the
benches ``merged_pk`` and ``merged``, and in each tree's first turn
``profile_step.profile`` of the ``merged_pk`` step.

Each process prints one JSON line; ``drive`` prints a table of each
variant's mean over the turns of each tree, and the GPU's name and power
limit.  Needs a CUDA device.

    python <this file> --worker --root DIR     # one tree, one JSON line
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

VARIANTS = (("vel", "plain"), ("vel", "axpy"), ("vel", "inject1"),
            ("vel", "inject2"), ("stress", "plain"), ("stress", "axpy"),
            ("stress", "axpy_damp"), ("stress", "inject1"),
            ("stress", "inject2"), ("stress_c", "plain"),
            ("stress_c", "axpy_damp"))
# K6 (None) or K7's (stage, damp, source groups, emit) of each mode
UPWIND_U_MODES = {"rhs": None, "stage": (True, False, 0, False),
                  "final": (False, False, 0, False),
                  "final damp": (False, True, 0, False),
                  "stage inject1": (True, False, 1, False),
                  "final damp inject2": (False, True, 2, False),
                  "stage emit": (True, False, 0, True),
                  "final damp emit": (False, True, 0, True)}
UPWIND_VARIANTS = (
    *(("upwind_rhs", v) for v in ("plain", "inject1", "inject2",
                                  "acoustic")),
    *(("lane_upwind_rhs" if m == "rhs" else "lane_upwind_axpy", m)
      for m in UPWIND_U_MODES))
FUSED_VARIANTS = (("fused_stress2", "plain"), ("fused_stress2", "axpy"),
                  ("fused_stress2", "axpy_damp"),
                  ("fused_stress2[C]", "plain"),
                  ("fused_stress2[C]", "axpy_damp"),
                  ("fused_vel2", "plain"), ("fused_vel2", "axpy"))
LANE_VARIANTS = (("lane_stress", "TR"), ("lane_stress", "SEL"),
                 ("lane_stress[C]", "TR"), ("lane_stress[C]", "SEL"),
                 ("lane_vel", "SIG"), ("lane_vel", "TRAC"),
                 ("lane_vel", "SEL"))
PACKED_VARIANTS = (("merged_vel[pk]", "plain"), ("merged_vel[pk]", "axpy"),
                   ("merged_vel[pk]", "inject1"),
                   ("merged_vel[pk]", "inject2"),
                   ("fused_stress2[pk]", "plain"),
                   ("fused_stress2[pk]", "axpy"),
                   ("fused_stress2[pk]", "axpy_damp"),
                   ("fused_vel2[pk]", "plain"), ("fused_vel2[pk]", "axpy"),
                   ("p1_pack_vel", "plain"),
                   ("merged_stress[pk]", "plain"),
                   ("merged_stress[pk]", "axpy_damp"),
                   ("merged_vel", "plain"))
FAMILIES = {"merged": VARIANTS, "upwind": UPWIND_VARIANTS,
            "fused": FUSED_VARIANTS, "lane": LANE_VARIANTS,
            "packed": PACKED_VARIANTS}
# each family's benches: label (the bench's command line) -> impl, options,
# and whether the first turn of each tree profiles that step
STEPS = {
    "merged": (("merged", "merged", {}, False),
               ("merged --vti", "merged", {"vti": True}, False)),
    "upwind": (("upwind_lane", "upwind_lane", {}, True),
               ("upwind_lane_u", "upwind_lane_u", {}, True),
               ("upwind_lane_u --panel-emit", "upwind_lane_u",
                {"panel_emit": True}, True),
               ("upwind_lane_u --no-fused-axpy", "upwind_lane_u",
                {"fused_axpy": False}, True)),
    "fused": (("fused", "fused", {}, True),
              ("fused --vti", "fused", {"vti": True}, False)),
    "lane": (("lane --order 2", "lane", {"order": 2}, True),
             ("lane", "lane", {}, False),
             ("lane_u", "lane_u", {}, True),
             ("lane --vti", "lane", {"vti": True}, False)),
    "packed": (("merged_pk", "merged_pk", {}, True),
               ("merged", "merged", {}, False)),
}


def worker(root: str, n: int, degree: int, reps: int, bench_steps: int,
           family: str = "merged", profile: bool = False):
    """Time the variants and run the benches of the tree at ``root``."""
    root = str(Path(root).resolve())
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [root] + [p for p in sys.path if p != here]
    import torch

    import seigen_tpu_torch
    from seigen_tpu_torch.bench import throughput

    if not torch.cuda.is_available():
        raise RuntimeError("merged_ab times a CUDA device; none is available")
    if not str(Path(seigen_tpu_torch.__file__).resolve()).startswith(root):
        raise RuntimeError(f"imported {seigen_tpu_torch.__file__}, not the "
                           f"tree at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def time_ms(fn):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    run = {"merged": _merged_family, "upwind": _upwind_family,
           "fused": _fused_family, "lane": _lane_family,
           "packed": _packed_family}[family]
    times, cases = run(throughput, dev, n, degree, time_ms)
    bench, profiles = _steps(throughput, family, cases, n, degree,
                             bench_steps, profile)
    name, limit = throughput.gpu_name_and_power_limit(0)
    return {"root": root, "family": family, "gpu": name,
            "power_limit": limit, "n": n, "degree": degree, "reps": reps,
            "times_ms": times, "bench_dof_updates_per_s": bench,
            "profiles": profiles}


def _steps(throughput, family, cases, n, degree, bench_steps, profile):
    """The family's benches (``STEPS``) on ``cases`` ({scrambled: the
    bench case}), and with ``profile`` the step profiles it marks."""
    bench, profiles = {}, {}
    for label, impl, opts, _ in STEPS[family]:
        case = cases[impl in throughput.SCRAMBLED_IMPLS]
        bench[label] = throughput.main(n=n, degree=degree,
                                       n_steps=bench_steps, impl=impl,
                                       case=case, **opts)["value"]
    if profile:
        from seigen_tpu_torch.bench import profile_step

        for label, impl, opts, prof in STEPS[family]:
            if prof:
                profiles[label] = profile_step.profile(
                    impl=impl, n=n, degree=degree, **opts)
    return bench, profiles


def _merged_operands(run, rng, dev):
    """numpy-seeded K1/K2 operands in a merged runner's layout (packed:
    the live rows of each parity block): the inputs x and four outputs'
    worth of axpy and source rows y of each operator."""
    import numpy as np
    import torch

    d, plan = run.d, run.plan

    def field(C):
        a = rng.standard_normal((C, d.n_par, d.npp // d.n_par, plan.Ls)
                                ).astype(np.float32)
        a[:, :, d.n_p:] = 0.0
        return torch.as_tensor(a.reshape(C * d.npp, plan.Ls), device=dev)

    x = {"vel": field(d.n_sig), "stress": field(d.dim),
         "trs": torch.as_tensor(rng.standard_normal(
             (plan.nf * plan.rtf, plan.Ls)).astype(np.float32), device=dev)}
    y = {"vel": [field(d.dim) for _ in range(4)],
         "stress": [field(d.n_sig) for _ in range(4)]}
    return x, y


def _merged_call(run, x, y, base, variant, dt):
    """One launch of K1 (base "vel") or K2 ("stress") variant on a merged
    runner's plan and data, as a function of no arguments."""
    import dataclasses

    from seigen_tpu_torch.ops import merged_kernels as mk

    od = run.d
    pair = y[base]
    kw = {}
    if variant.startswith("axpy"):
        kw = dict(axpy=(pair[0], pair[1]), dt=float(dt),
                  c3=float(dt) ** 3 / 24.0)
    elif variant.startswith("inject"):
        kw = dict(inject=[(pair[2 + g], (0.7, -1.3)[g])
                          for g in range(int(variant[-1]))])
    if base == "vel":
        kern = mk.VEL_KERNEL
    else:
        if variant == "axpy":
            od = dataclasses.replace(od, damp=None)
        kw["damp"] = od.damp if variant == "axpy_damp" else None
        kern = mk.STRESS_KERNEL
    args = (run.plan, od, x[base], x["trs"], run.mask)
    return lambda: kern(*args, **kw)


def _merged_family(throughput, dev, n, degree, time_ms):
    """K1/K2 variants; returns (times, {False: the bench case})."""
    import numpy as np

    case = throughput.setup_case(n=n, degree=degree, device=dev)
    dm, p, src, damp, dt, _ = case
    runners = {v: throughput.make_runner("merged", dm, p, src, damp, dt,
                                         "kernel", vti=v)
               for v in (False, True)}
    x, y = _merged_operands(runners[False], np.random.default_rng(24), dev)

    def call(op, variant):
        base = "vel" if op == "vel" else "stress"
        return _merged_call(runners[op == "stress_c"], x, y, base, variant,
                            dt)

    times = {f"{op} {v}": time_ms(call(op, v)) for op, v in VARIANTS}
    return times, {False: case}


def _packed_family(throughput, dev, n, degree, time_ms):
    """K1pk, K9pk and K8pk variants and K11, K2pk and the unpacked K1 as
    controls; returns (times, {False: the bench case})."""
    import numpy as np

    from seigen_tpu_torch.bench import p1_pack_probe as probe

    case = throughput.setup_case(n=n, degree=degree, device=dev)
    dm, p, src, damp, dt, _ = case
    rng = np.random.default_rng(32)
    ops = {}
    for pk in (True, False):
        run = throughput.make_runner("merged_pk" if pk else "merged", dm, p,
                                     src, damp, dt, "kernel")
        ops[pk] = (run, *_merged_operands(run, rng, dev))
    d_pk = ops[True][0].d
    v2pk = (d_pk, *_fused_operands(d_pk, rng, dev))
    d_pr, sig_p, tr_p = (probe.build_packed_vel_data(p),
                         v2pk[1]["fused_vel2"], v2pk[3])

    def call(name, variant):
        if name == "p1_pack_vel":
            return lambda: probe.PACK_VEL_KERNEL(d_pr, sig_p, tr_p)
        if name.startswith("fused_"):
            return _fused_call(*v2pk, name.removesuffix("[pk]"), variant, dt)
        base = "vel" if name.startswith("merged_vel") else "stress"
        return _merged_call(*ops[name.endswith("[pk]")], base, variant, dt)

    times = {f"{op} {v}": time_ms(call(op, v)) for op, v in PACKED_VARIANTS}
    return times, {False: case}


def _lane_family(throughput, dev, n, degree, time_ms):
    """K5 modes (both Hooke laws) and K4 modes; returns (times, {False: the
    bench case, True: its scrambled copy})."""
    import numpy as np
    import torch

    from seigen_tpu_torch.ops import lane_kernels as lk

    cases = {s: throughput.setup_case(n=n, degree=degree, device=dev,
                                      scramble=s) for s in (False, True)}
    runners = {}
    for s, impl in ((False, "lane"), (True, "lane_u")):
        dm, p, src, damp, dt, _ = cases[s]
        for vti in (False, True):
            runners[s, vti] = throughput.make_runner(impl, dm, p, src, damp,
                                                     dt, "kernel", vti=vti)
    rng = np.random.default_rng(26)
    d = runners[False, False].d

    def rows(C, used, pad):
        a = rng.standard_normal((C, pad, d.E)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * pad, d.E), device=dev)

    x = {"sig": rows(d.n_sig, d.n_p, d.npp), "u": rows(d.dim, d.n_p, d.npp),
         "tr_sig": rows(d.n_sig, d.ftp, d.ftpp),
         "tr_u": rows(d.dim, d.ftp, d.ftpp),
         "panels": rows(d.nf, d.dim * d.ftp, (d.dim * d.ftp + 7) // 8 * 8)}

    def call(name, mode):
        aniso = name.endswith("[C]")
        # SIG and TR on the bench case, TRAC and SEL on its scrambled copy
        run = runners[mode not in ("SIG", "TR"), aniso]
        rd = run.d
        if name == "lane_vel":
            if mode == "SEL":
                _, combo, sign, cfg = run._pg_t
                return lambda: lk.LANE_VEL(rd, x["sig"], x["panels"],
                                           lk.VEL_SEL, combo=combo,
                                           sign=sign, selcfg=cfg)
            tr, m = ((x["tr_sig"], lk.VEL_SIG) if mode == "SIG"
                     else (x["tr_u"], lk.VEL_TRAC))
            return lambda: lk.LANE_VEL(rd, x["sig"], tr, m)
        cmat = run.cmat if aniso else None
        if mode == "TR":
            return lambda: lk.LANE_STRESS(rd, x["u"], x["tr_u"], lk.STRESS_TR,
                                          cmat=cmat)
        _, combo, _, cfg = run._pg_u
        return lambda: lk.LANE_STRESS(rd, x["u"], x["panels"], lk.STRESS_SEL,
                                      combo=combo, selcfg=cfg, cmat=cmat)

    times = {f"{op} {v}": time_ms(call(op, v)) for op, v in LANE_VARIANTS}
    return times, cases


def _upwind_family(throughput, dev, n, degree, time_ms):
    """K3 variants and K6/K7 modes; returns (times, {False: the bench
    case, True: its scrambled copy})."""
    import dataclasses

    import numpy as np
    import torch

    from seigen_tpu_torch.ops import build_params, build_upwind_data
    from seigen_tpu_torch.ops import lane_upwind_kernels as luk
    from seigen_tpu_torch.ops import upwind_kernels as uk
    from seigen_tpu_torch.ops.structured_exchange import detect_structured
    from seigen_tpu_torch.solver.lane_upwind import UpwindLaneRunner

    rng = np.random.default_rng(31)

    def rows(C, used, pad, lanes):
        a = rng.standard_normal((C, pad, lanes)).astype(np.float32)
        a[:, used:] = 0.0
        return torch.as_tensor(a.reshape(C * pad, lanes), device=dev)

    times = {}
    case = throughput.setup_case(n=n, degree=degree, device=dev)
    dm, p, src, damp, dt, _ = case
    r = throughput.make_runner("upwind_lane", dm, p, src, damp, dt, "kernel")
    mat = dataclasses.replace(throughput.BENCH_MAT, vs=np.where(
        dm.coords.mean(axis=1)[:, 0] < 0.5, 0.0, throughput.BENCH_MAT.vs))
    acoustic = UpwindLaneRunner(build_params(dm, mat, device=dev), r.ex,
                                build_upwind_data(dm, mat, device=dev), dt,
                                impl="kernel")
    d, Ls = r.d, r.plan.Ls
    u, s = rows(d.dim, d.n_p, d.npp, Ls), rows(d.n_sig, d.n_p, d.npp, Ls)
    trs = rows(d.nf, 2 * d.dim * d.n_fp, r.plan.rtf, Ls)
    inj = [(rows(d.dim, d.n_p, d.npp, Ls), rows(d.n_sig, d.n_p, d.npp, Ls),
            (0.7, -1.3)[g]) for g in range(2)]
    for v in ("plain", "inject1", "inject2", "acoustic"):
        run = acoustic if v == "acoustic" else r
        args = (run.plan, run.d, run.uwg, u, s, trs, run.mask)
        kw = {"inject": inj[: int(v[-1])] if v.startswith("inject") else []}
        times[f"upwind_rhs {v}"] = time_ms(
            lambda: uk.UPWIND_KERNEL(*args, **kw))
    del r, acoustic, u, s, trs, inj

    scase = throughput.setup_case(n=n, degree=degree, device=dev,
                                  scramble=True)
    dm, p, src, damp, dt, _ = scase
    r = throughput.make_runner("upwind_lane_u", dm, p, src, damp, dt,
                               "kernel")
    d, E = r.d, r.d.E
    state = [(rows(d.dim, d.n_p, d.npp, E), rows(d.n_sig, d.n_p, d.npp, E))
             for _ in range(5)]
    rows_pad = r.selcfg[5]
    pan = [rows(d.nf, d.dim * d.ftp, rows_pad, E) for _ in range(2)]
    pan_e = [rows(d.nf * d.dim, d.ftp, d.ftpp, E) for _ in range(2)]
    for mode, spec in UPWIND_U_MODES.items():
        emit = spec is not None and spec[3]
        args = (d, r.uw, *state[0], *(pan_e if emit else pan), r.combo,
                r.sign_u, r.sign_t,
                luk.emitted_selcfg(r.selcfg) if emit else r.selcfg)
        if spec is None:
            kern, kw = luk.LANE_UPWIND_RHS, {}
        else:
            stage, dmp, n_inj, _ = spec
            kern = luk.LANE_UPWIND_AXPY
            args += (*state[1], 0.21)
            kw = dict(base_u=state[2][0] if stage else None,
                      base_s=state[2][1] if stage else None,
                      cs=0.37 if stage else None,
                      inject=[(*state[3 + g], (0.7, -1.3)[g])
                              for g in range(n_inj)],
                      damp_row=r.damp_u[: d.npp] if dmp else None,
                      emit=emit)
        name = "lane_upwind_rhs" if spec is None else "lane_upwind_axpy"
        times[f"{name} {mode}"] = time_ms(lambda: kern(*args, **kw))
    return times, {False: case, True: scase}


def _fused_operands(d, rng, dev):
    """(x, y, tr): numpy-seeded K8/K9 operands in the v2 lane layout of
    the operator data d (packed: the live rows of each parity block) — the
    inputs x, two outputs' worth of axpy rows y of each operator, and the
    exchanged traces tr."""
    import numpy as np
    import torch

    lanes = d.E // d.n_par

    def rows(C, used, pad, blocks=1):
        a = rng.standard_normal((C, blocks, pad // blocks, lanes)
                                ).astype(np.float32)
        a[:, :, used:] = 0.0
        return torch.as_tensor(a.reshape(C * pad, lanes), device=dev)

    tr = rows(d.dim, d.ftp, d.ftpp)
    x = {"fused_vel2": rows(d.n_sig, d.n_p, d.npp, d.n_par),
         "fused_stress2": rows(d.dim, d.n_p, d.npp, d.n_par)}
    y = {"fused_vel2": tuple(rows(d.dim, d.n_p, d.npp, d.n_par)
                             for _ in range(2)),
         "fused_stress2": tuple(rows(d.n_sig, d.n_p, d.npp, d.n_par)
                                for _ in range(2))}
    return x, y, tr


def _fused_call(od, x, y, tr, base, variant, dt):
    """One launch of a K8 (base "fused_vel2") or K9 ("fused_stress2")
    variant on operator data od, as a function of no arguments."""
    import dataclasses

    from seigen_tpu_torch.ops import fused_ops as fo

    kw = {}
    if variant.startswith("axpy"):
        kw = dict(axpy=y[base], dt=float(dt), c3=float(dt) ** 3 / 24.0)
    if base == "fused_vel2":
        return lambda: fo.VEL2_KERNEL(od, x[base], tr, **kw)
    if variant == "axpy":  # the stress update without a sponge
        od = dataclasses.replace(od, damp=None)
    kw["damp"] = od.damp if variant == "axpy_damp" else None
    return lambda: fo.STRESS2_KERNEL(od, x[base], tr, **kw)


def _fused_family(throughput, dev, n, degree, time_ms):
    """K9 and K8 variants; returns (times, {False: the bench case})."""
    import numpy as np

    case = throughput.setup_case(n=n, degree=degree, device=dev)
    dm, p, src, damp, dt, _ = case
    data = {v: throughput.make_runner("fused", dm, p, src, damp, dt,
                                      "kernel", vti=v).d
            for v in (False, True)}
    x, y, tr = _fused_operands(data[False], np.random.default_rng(25), dev)

    def call(name, variant):
        return _fused_call(data[name.endswith("[C]")], x, y, tr,
                           name.removesuffix("[C]"), variant, dt)

    times = {f"{op} {v}": time_ms(call(op, v)) for op, v in FUSED_VARIANTS}
    return times, {False: case}


def drive(trees, n, degree, reps, bench_steps, family="merged"):
    """Run the workers in turns A, B, B, A and print the table; the first
    turn of each tree also profiles (the steps ``STEPS`` marks)."""
    (la, ra), (lb, rb) = trees
    order = ((la, ra), (lb, rb), (lb, rb), (la, ra))
    recs = []
    for turn, (label, root) in enumerate(order):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               "--root", root, "--n", str(n), "--degree", str(degree),
               "--reps", str(reps), "--bench-steps", str(bench_steps),
               "--family", family] + (["--profile"] if turn < 2 else [])
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"worker {label} ({root}) failed:\n"
                               f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["label"] = label
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    print(f"GPU: {recs[0]['gpu']}, {recs[0]['power_limit']}; n={n} P{degree}"
          f"; turns {', '.join(lb for lb, _ in order)}")

    def mean(label, get):
        vals = [get(r) for r in recs if r["label"] == label]
        return sum(vals) / len(vals), vals

    print(f"{'variant':<36s} {la + ' ms':>12s} {lb + ' ms':>12s} "
          f"{lb + '/' + la:>10s}   each turn")
    for op, v in FAMILIES[family]:
        k = f"{op} {v}"
        ma, va = mean(la, lambda r: r["times_ms"][k])
        mb, vb = mean(lb, lambda r: r["times_ms"][k])
        print(f"{k:<36s} {ma:12.4f} {mb:12.4f} {mb / ma:10.3f}   "
              f"{' '.join(f'{t:.4f}' for t in va + vb)}")
    for k in recs[0]["bench_dof_updates_per_s"]:
        ma, va = mean(la, lambda r: r["bench_dof_updates_per_s"][k])
        mb, vb = mean(lb, lambda r: r["bench_dof_updates_per_s"][k])
        print(f"bench {k:<30s} {ma:12.4e} {mb:12.4e} {mb / ma:10.3f}   "
              f"{' '.join(f'{t:.4e}' for t in va + vb)}  DOF-updates/s")
    for rec in recs:
        for impl, prof in rec["profiles"].items():
            top = list(prof["device_ms_per_step_by_group"].items())[:4]
            print(f"profile {rec['label']} {impl}: wall "
                  f"{prof['wall_ms_per_step']:.4f} ms, enqueue "
                  f"{prof['host_enqueue_ms_per_step']:.4f}, device busy "
                  f"{prof['device_busy_ms_per_step']:.4f}, idle "
                  f"{prof['device_idle_share']:.3f}; "
                  + ", ".join(f"{g} {t:.4f}" for g, t in top))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="parent=_archive/parent,change=.",
                    help="two label=root pairs; the first runs first and "
                    "last")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--root", default=".")
    ap.add_argument("--n", type=int, default=None,
                    help="mesh size (default: 32 for the packed family, "
                    "else 24)")
    ap.add_argument("--degree", type=int, default=None,
                    help="degree (default: 1 for the packed family, else 3)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--bench-steps", type=int, default=100)
    ap.add_argument("--family", default="merged", choices=tuple(FAMILIES),
                    help="merged: K1/K2; upwind: K3, K6/K7; fused: K9, K8; "
                    "lane: K5, K4; packed: K1pk, K9pk, K8pk, K11, K2pk (and "
                    "profiles)")
    ap.add_argument("--profile", action="store_true",
                    help="worker: also profile the steps STEPS marks")
    a = ap.parse_args(argv)
    # the packed layout is P1 only: its family runs the n=32 P1 case
    n, degree = (32, 1) if a.family == "packed" else (24, 3)
    a.n = n if a.n is None else a.n
    a.degree = degree if a.degree is None else a.degree
    if a.worker:
        print(json.dumps(worker(a.root, a.n, a.degree, a.reps,
                                a.bench_steps, a.family, a.profile)),
              flush=True)
        return
    trees = [tuple(t.split("=", 1)) for t in a.trees.split(",")]
    if len(trees) != 2:
        raise SystemExit("--trees takes two label=root pairs")
    drive(trees, a.n, a.degree, a.reps, a.bench_steps, a.family)


if __name__ == "__main__":
    main()
