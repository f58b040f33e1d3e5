"""Full-waveform inversion: recover velocity structure from surface
seismograms by descent through the differentiable solver.

Port of ``scripts/fwi.py`` with the same flags and defaults: the production
loop (solver/fwi.py: Adam / L-BFGS / max-normalised descent, gradient
smoothing, frequency continuation, bounds, multi-shot batching) over one of
the gradient engines (``--grad-path``): ``roll``, autograd through the
einsum step on the structured roll exchange (``einsum`` on other meshes);
``lane``, ``merged`` and ``lane_u``, the energy-conjugation engines of
solver/lane_diff.py (K4 SIG / K5 TR, K1 / K2, K4 TRAC SEL / K5 SEL on the
card; their plain versions with ``--cpu``).

    python -m seigen_tpu_torch.cli.fwi --n 24 --degree 2 --iters 30 --shots 4
    python -m seigen_tpu_torch.cli.fwi --dim 3 --n 24 --degree 1 --salt \\
        --iters 12 --shots 4 --bands 4,8 --T 1.4 --grad-path merged

``--grad-shards N`` lays the shots over N ranks (shot data parallelism:
``LaneDiffFwi.vg_factory_sharded``) and ``--dd-shards N`` decomposes each
shot's domain over N ranks (parallel/: ``--grad-path lane`` the slab-sharded
lane operators, ``merged`` the slab-sharded merged ones, ``lane_u`` Morton
blocks), both with the lane engines only and not together.  The CLI spawns
the ranks itself (NCCL, one card a rank; gloo with ``--cpu``); every rank
runs the same inversion and gets the same sums, rank 0 prints and writes.

    python -m seigen_tpu_torch.cli.fwi --n 8 --degree 1 --iters 3 \
        --grad-path merged --dd-shards 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import pick_device, run_dtype

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=2, choices=[2, 3])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--shots", type=int, default=4)
    ap.add_argument("--receivers", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30,
                    help="iterations PER continuation band")
    ap.add_argument("--optimizer", choices=["adam", "lbfgs", "gd"],
                    default="adam")
    ap.add_argument("--lr", type=float, default=None,
                    help="adam step or gd max-normalised step (default "
                         "0.01)")
    ap.add_argument("--bands", type=str, default=None,
                    help="comma-separated low-pass cutoffs in Hz for "
                         "frequency continuation, e.g. '4,8' (a final "
                         "full-band stage is appended)")
    ap.add_argument("--smooth", type=int, default=2,
                    help="gradient-smoother Jacobi iterations (0 = off)")
    ap.add_argument("--areal", action="store_true",
                    help="3D: shots on a sqrt(S) x sqrt(S) areal grid and "
                         "receivers on a sqrt(R) x sqrt(R) areal patch "
                         "(instead of the y = 0.5 lines)")
    ap.add_argument("--vsp", type=int, default=0,
                    help="3D: add 4 vertical receiver strings of this many "
                         "receivers at the corners of the acquisition patch")
    ap.add_argument("--precond", choices=["none", "illum"], default="none",
                    help="'illum' = 1/(I + 0.01 Imax) from the source-side "
                         "illumination of a lane engine (mainly the "
                         "--optimizer gd depth-compensation lever)")
    ap.add_argument("--salt", action="store_true",
                    help="3D: layered background + salt body as the true "
                         "model; invert vp from the salt-free background")
    ap.add_argument("--T", type=float, default=1.2)
    ap.add_argument("--segment", type=int, default=None,
                    help="checkpoint segment length (adjoint memory)")
    ap.add_argument("--batch", choices=["vmap", "map", "host"],
                    default="vmap",
                    help="shot batching of the roll/einsum path: 'vmap' one "
                         "batched loop, 'map'/'host' one shot after the "
                         "other")
    ap.add_argument("--grad-path",
                    choices=["roll", "lane", "merged", "lane_u"],
                    default="roll",
                    help="gradient formulation: 'roll' = autograd through "
                         "the roll-exchange einsum step; 'lane'/'merged'/"
                         "'lane_u' = energy-conjugation engines over the "
                         "kernels (solver/lane_diff.py); lane_u works on "
                         "any conforming mesh")
    ap.add_argument("--grad-shards", type=int, default=0,
                    help="with --grad-path lane/merged/lane_u: lay the "
                         "shots over this many ranks (shot-parallel "
                         "gradients summed over the ranks)")
    ap.add_argument("--dd-shards", type=int, default=0,
                    help="domain-decompose each shot's forward and adjoint "
                         "sweeps over this many ranks (--grad-path lane: "
                         "slab-sharded lane ops; merged: slab-sharded "
                         "merged ops; lane_u: Morton-block unstructured "
                         "ops)")
    ap.add_argument("--inv-checkpoint", type=str, default=None,
                    help="inversion-state npz written every iteration; with "
                         "--inv-resume a killed inversion continues bitwise")
    ap.add_argument("--inv-resume", action="store_true")
    ap.add_argument("--invert-q", action="store_true",
                    help="attenuation FWI: observed data from a low-Q "
                         "anomaly, per-element (Q_kappa^-1, Q_mu^-1) "
                         "inverted by Adam through the viscoelastic "
                         "upwind-RK4 loop; ignores --grad-path")
    ap.add_argument("--est-source", action="store_true",
                    help="with --grad-path lane/merged/lane_u: the modeled "
                         "wavelet starts perturbed (amp x1.3, f0 x1.1, t0 "
                         "+1%% of T) and per-shot (amp, f0, t0) are "
                         "recovered by Adam before the velocity inversion")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain operator versions)")
    ap.add_argument("--out", type=str, default=None,
                    help="npz output (true/init/final vp, misfits)")
    return ap


def setup(args, dev, dtype):
    """Mesh, background and true models, shots, receivers, sponge, dt."""
    from ..mesh import box_mesh, build_discrete, rect_mesh
    from ..ops import Material, build_params
    from ..solver import PointSource, absorbing_bc_fn, build_receivers, \
        build_sources, cfl_dt, grid, line, sponge_mask
    from ..solver.models import Layer, add_ellipsoid_body, layered_model
    from ..solver.shots import stack_shots

    if args.dim == 2:
        extents = ((0.0, 2.0), (0.0, 1.0))
        dm = build_discrete(
            rect_mesh(2 * args.n, args.n, lx=2.0, ly=1.0), args.degree,
            bc_fn=absorbing_bc_fn(extents, free_sides=[(1, "hi")]))
        mat0 = Material(rho=1.0, vp=2.0, vs=1.0)
        src_depth, rcv_depth = 0.9, 0.95
        shot_line = (0.3, 1.7)
        rcv_line = ((0.15, rcv_depth), (1.85, rcv_depth))
        sponge = [(0, "lo"), (0, "hi"), (1, "lo")]
        vmax = 2.0
    else:
        extents = ((0.0, 1.0),) * 3
        dm = build_discrete(
            box_mesh(args.n, args.n, args.n), args.degree,
            bc_fn=absorbing_bc_fn(extents, free_sides=[(2, "hi")]))
        mat0 = layered_model(dm, [
            Layer(bottom=-0.01, top=0.5, rho=1.2, vp=2.4, vs=1.2),
            Layer(bottom=0.5, top=1.01, rho=1.0, vp=2.0, vs=1.0)])
        src_depth, rcv_depth = 0.85, 0.9
        shot_line = (0.25, 0.75)
        rcv_line = ((0.1, 0.5, rcv_depth), (0.9, 0.5, rcv_depth))
        sponge = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
        vmax = 3.2 if args.salt else 2.4

    h = float(dm.h.min())
    cent = np.asarray(dm.coords.mean(axis=1))
    p0 = build_params(dm, mat0, dtype=dtype, device=dev)
    if args.dim == 2:
        vp_true = 2.0 - 0.3 * np.exp(
            -(((cent[:, 0] - 1.0) ** 2 + (cent[:, 1] - 0.5) ** 2)
              / (2 * 0.15**2)))
    elif args.salt:
        vp_true = np.asarray(add_ellipsoid_body(
            dm, mat0, center=(0.5, 0.5, 0.55), radii=(0.22, 0.22, 0.16),
            rho=1.4, vp=3.0, vs=1.5).vp, np.float64)
    else:
        vp_true = np.asarray(mat0.vp, np.float64) - 0.3 * np.exp(
            -np.sum((cent - 0.5) ** 2, axis=1) / (2 * 0.15**2))

    f0 = 0.15 * vmax / h / (args.degree + 1)
    if args.dim == 2:
        shot_pos = [(float(x), src_depth)
                    for x in np.linspace(*shot_line, args.shots)]
    elif args.areal:
        g = max(1, int(round(np.sqrt(args.shots))))
        shot_pos = [tuple(map(float, q))
                    for q in grid(shot_line, shot_line, g, g, src_depth)]
        args.shots = g * g
    else:
        shot_pos = [(float(x), 0.5, src_depth)
                    for x in np.linspace(*shot_line, args.shots)]
    shots = stack_shots([
        build_sources(dm, [PointSource(position=q, f0=f0, radius=2 * h)],
                      dtype=dtype, device=dev)
        for q in shot_pos])
    if args.dim == 3 and (args.areal or args.vsp):
        pts = []
        if args.areal:
            gr = max(2, int(round(np.sqrt(args.receivers))))
            pts.append(grid((0.1, 0.9), (0.1, 0.9), gr, gr, rcv_depth))
        else:
            pts.append(line(*rcv_line, args.receivers))
        if args.vsp:
            # corner strings outside the 0.15 sponges, off the salt flank
            for x, y in ((0.25, 0.25), (0.25, 0.75),
                         (0.75, 0.25), (0.75, 0.75)):
                pts.append(line((x, y, 0.2), (x, y, 0.8), args.vsp))
        rcv_pts = np.concatenate([np.asarray(q, float) for q in pts])
    else:
        rcv_pts = line(*rcv_line, args.receivers)
    rcv = build_receivers(dm, rcv_pts, dtype=dtype, device=dev)
    damp = torch.as_tensor(sponge_mask(dm, sponge, width=0.15),
                           device=dev).to(dtype)
    dt = cfl_dt(h, vmax, args.degree, 0.4)
    n_steps = int(np.ceil(args.T / dt))
    if args.segment:
        n_steps -= n_steps % args.segment
    return dict(dm=dm, mat0=mat0, p0=p0, vp_true=vp_true, cent=cent,
                f0=f0, shots=shots, rcv=rcv, damp=damp, dt=dt,
                n_steps=n_steps, src_depth=src_depth)


def zero_state(dm, dtype, dev):
    from ..ops import n_sig_for
    from ..solver import State

    E, n_p, dim = dm.num_elements, dm.re.n_p, dm.dim
    return State(
        u=torch.zeros((E, n_p, dim), dtype=dtype, device=dev),
        s=torch.zeros((E, n_p, n_sig_for(dim)), dtype=dtype, device=dev))


def invert_q(args, c, dtype, dev, t_setup) -> int:
    """Attenuation FWI (Q^-1 tomography) through make_visco_fwi_gradient."""
    from ..ops.upwind import build_upwind_data
    from ..ops.viscoelastic import build_visco
    from ..solver.adjoint import make_visco_fwi_gradient
    from ..solver.fwi import make_smoother
    from ..solver.rk4 import run_rk4_visco
    from ..solver.shots import shot_at

    dm, p0, cent = c["dm"], c["p0"], c["cent"]
    E = dm.num_elements
    st0 = zero_state(dm, dtype, dev)
    w = build_upwind_data(dm, c["mat0"], dtype=dtype, device=dev)
    f_band = (c["f0"] / 3.0, 3.0 * c["f0"])
    # true model: background Q = 80 with a low-Q (Q = 10) anomaly on the
    # source-receiver propagation path
    c0 = cent.mean(axis=0)
    c0[-1] = c["src_depth"]
    r2 = np.sum((cent - c0) ** 2, axis=1)
    qinv_true = 1.0 / 80.0 + (1.0 / 10.0 - 1.0 / 80.0) * np.exp(
        -r2 / (2 * 0.2**2))
    v_true = build_visco(p0, 1.0 / qinv_true, 1.0 / qinv_true, *f_band)
    shots = [shot_at(c["shots"], k) for k in range(args.shots)]
    with torch.no_grad():
        obs = [run_rk4_visco(p0, w, v_true, st0, c["dt"], c["n_steps"],
                             src=sk, damp=c["damp"], receivers=c["rcv"])[2]
               for sk in shots]
    print(f"setup+observed(visco): {time.perf_counter() - t_setup:.1f} s",
          flush=True)
    vg, init_theta = make_visco_fwi_gradient(
        p0, w, st0, c["dt"], c["n_steps"], shots[0], c["rcv"], obs[0],
        f_band, q0=80.0, damp=c["damp"], segment=args.segment)
    theta = init_theta()
    smooth = make_smoother(p0, iters=args.smooth)
    # qinv lives in [1e-4, 0.2]: a small lr keeps Adam's unit-RMS steps a
    # few-% relative move per iteration
    opt = torch.optim.Adam(list(theta.values()),
                           lr=args.lr if args.lr is not None else 5e-4,
                           eps=1e-8)
    misfits = []
    t_inv = time.perf_counter()
    for it in range(args.iters):
        tot_v, tot_g = 0.0, None
        for sk, ok in zip(shots, obs):
            v, g = vg(theta, sk, ok)
            tot_v += v
            tot_g = g if tot_g is None else {k: tot_g[k] + g[k] for k in g}
        for k in theta:
            theta[k].grad = smooth(tot_g[k])
        opt.step()
        with torch.no_grad():
            for t in theta.values():
                t.clamp_(1e-4, 0.2)
        misfits.append(tot_v)
        print(f"q-iter={it} misfit={tot_v:.4e}", flush=True)
    qinv = (0.5 * (theta["qinv_kappa"] + theta["qinv_mu"])).detach().cpu(
        ).numpy().astype(np.float64)
    region = qinv_true > 1.5 / 80.0
    if not region.any():
        region = np.ones(E, dtype=bool)
    err0 = float(np.abs(1.0 / 80.0 - qinv_true)[region].mean())
    err = float(np.abs(qinv - qinv_true)[region].mean())
    summary = {
        "mode": "invert_q", "E": E, "n_steps": c["n_steps"],
        "shots": args.shots, "misfit_first": misfits[0],
        "misfit_last": misfits[-1], "qinv_err_init": err0,
        "qinv_err_final": err,
        "qinv_err_reduction": err / max(err0, 1e-30),
        "wall_s": time.perf_counter() - t_inv,
    }
    print(json.dumps(summary))
    if args.out:
        np.savez_compressed(args.out, qinv_true=qinv_true, qinv_final=qinv,
                            misfits=np.asarray(misfits), centroids=cent)
        print(f"model -> {args.out}")
    return 0 if misfits[-1] < misfits[0] else 1


def estimate_source(args, ldf, log=print):
    """Per-shot (amp, f0, t0) recovery by Adam on source_vg_factory from a
    perturbed wavelet, in the background model; installs the recovered
    wavelet in the engine and returns the report."""
    wav_true = {k: ldf.src[k].detach().cpu().numpy().astype(np.float64)
                for k in ("amp", "f0", "t0")}
    wav = {"amp": wav_true["amp"] * 1.3, "f0": wav_true["f0"] * 1.1,
           "t0": wav_true["t0"] + 0.01 * args.T}
    # relative variables: one Adam lr covers the different scales
    scale = {k: np.maximum(np.abs(v), 1e-12) for k, v in wav.items()}
    x = {k: torch.as_tensor(wav[k] / scale[k]) for k in wav}
    svg = ldf.source_vg_factory()
    opt = torch.optim.Adam(list(x.values()), lr=0.02, eps=1e-8)
    t_src = time.perf_counter()
    v_first = v = None
    for _ in range(40):
        v, gw = svg({k: x[k].numpy() * scale[k] for k in x}, {})
        for k in x:
            x[k].grad = torch.as_tensor(gw[k] * scale[k])
        opt.step()
        if v_first is None:
            v_first = v
    wav_rec = {k: x[k].detach().numpy() * scale[k] for k in x}
    for k in wav_rec:
        ldf.src[k] = ldf._tensor(wav_rec[k])

    def relerr(w):
        return float(np.mean([np.abs((w[k] - wav_true[k])
                                     / wav_true[k]).mean() for k in w]))

    rep = {"src_misfit_first": v_first, "src_misfit_last": v,
           "wav_err_init": relerr(wav), "wav_err_final": relerr(wav_rec),
           "src_wall_s": time.perf_counter() - t_src}
    log(f"source estimation: misfit {v_first:.3e} -> {v:.3e}, wavelet "
        f"rel-err {rep['wav_err_init']:.3f} -> {rep['wav_err_final']:.3f}",
        flush=True)
    return rep


def refuse_shards(args):
    """Exit non-zero for a sharded gradient the script does not run."""
    if args.grad_shards and args.dd_shards:
        raise SystemExit("--grad-shards (shot-DP) and --dd-shards (domain "
                         "decomposition) are exclusive")
    if args.grad_path == "roll" or args.invert_q:
        raise SystemExit("--grad-shards/--dd-shards need --grad-path "
                         "lane/merged/lane_u (and no --invert-q)")
    if args.dd_shards and args.est_source:
        raise SystemExit("--est-source runs on one device (no "
                         "--dd-shards)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    shards = max(args.grad_shards, args.dd_shards)
    if args.grad_shards or args.dd_shards:
        refuse_shards(args)
    if shards <= 1:
        return _rank_main(None, args)
    pick_device(args.cpu)
    from ..parallel.comm import spawn

    try:
        spawn(_rank_entry, shards, device="cpu" if args.cpu else "cuda",
              backend="gloo" if args.cpu else "nccl", args=(args,))
    except Exception as e:  # a rank failed: its error is printed
        print(f"sharded inversion failed: {e}", file=sys.stderr)
        return 1
    return 0


def _rank_entry(comm, args):
    rc = _rank_main(comm, args)
    if rc:
        raise SystemExit(rc)


def _engine(args, c, comm):
    """(gradient engine, its name): LaneDiffFwi, or with --dd-shards the
    domain-decomposed engine of --grad-path on ``comm``'s ranks."""
    from ..solver.lane_diff import LaneDiffFwi

    dm, p0, dt, n_steps = c["dm"], c["p0"], c["dt"], c["n_steps"]
    kw = dict(damp=c["damp"], segment=args.segment)
    if args.dd_shards > 1:
        from ..parallel import ShardedLaneDiffFwi, ShardedMergedDiffFwi, \
            ShardedUnstructuredDiffFwi

        args_ = (dt, n_steps, c["shots"], c["rcv"], None, args.dd_shards)
        if args.grad_path == "lane_u":
            ldf = ShardedUnstructuredDiffFwi(p0, dm, *args_, comm=comm, **kw)
        else:
            cls = (ShardedLaneDiffFwi if args.grad_path == "lane"
                   else ShardedMergedDiffFwi)
            ldf = cls(p0, dm, c["ex"], *args_, comm=comm, **kw)
        return ldf, f"{args.grad_path}_diff_dd{args.dd_shards}"
    ldf = LaneDiffFwi(p0, dm, c["ex"], dt, n_steps, c["shots"], c["rcv"],
                      None, engine=args.grad_path, **kw)
    name = f"{args.grad_path}_diff"
    if args.grad_shards > 1:
        name += f"_shot_dp{args.grad_shards}"
    return ldf, name


def _rank_main(comm, args) -> int:
    """The inversion; with ``comm`` one rank of a sharded run (only rank 0
    prints and writes; the others return 0 unless their model is not
    finite)."""
    rank0 = comm is None or comm.rank == 0
    dev = pick_device(args.cpu) if comm is None else comm.device
    dtype = run_dtype(args.f64)
    t_setup = time.perf_counter()
    c = setup(args, dev, dtype)
    if args.invert_q:
        return invert_q(args, c, dtype, dev, t_setup)

    def say(*a, **kw):
        if rank0:
            print(*a, **kw)

    from ..ops.structured_exchange import detect_structured, \
        make_structured_ops
    from ..solver.adjoint import theta_of_params, with_material
    from ..solver.fwi import invert
    from ..solver.shots import run_shots

    dm, p0, dt, n_steps = c["dm"], c["p0"], c["dt"], c["n_steps"]
    E = dm.num_elements
    shots, rcv, damp = c["shots"], c["rcv"], c["damp"]
    vp_true = torch.as_tensor(c["vp_true"], device=dev).to(dtype)
    st0 = zero_state(dm, dtype, dev)
    ex = c["ex"] = detect_structured(dm)
    vel_op = stress_op = ldf = None
    if args.grad_path in ("lane", "merged", "lane_u"):
        if ex is None and args.grad_path != "lane_u":
            raise SystemExit("--grad-path lane/merged needs a structured "
                             "mesh (lane_u works on any)")
        ldf, grad_ops = _engine(args, c, comm)
    elif ex is not None:
        vel_op, stress_op = make_structured_ops(ex)
        grad_ops = "roll"
    else:
        grad_ops = "einsum"
    say(f"E={E} steps={n_steps} shots={args.shots} f0={c['f0']:.1f} "
        f"grad_ops={grad_ops}")

    # observed data from the true model
    if ldf is not None:
        observed = ldf.synth({"vp": vp_true})
        ldf.observed = observed
    else:
        with torch.no_grad():
            _, observed = run_shots(
                with_material(p0, vp=vp_true), st0, dt, n_steps, shots,
                receivers=rcv, damp=damp, segment=args.segment,
                vel_op=vel_op, stress_op=stress_op, batch=args.batch)
    say(f"setup+observed: {time.perf_counter() - t_setup:.1f} s",
        flush=True)

    wav_report = None
    if args.est_source:
        if ldf is None:
            raise SystemExit("--est-source needs --grad-path lane/merged/"
                             "lane_u")
        wav_report = estimate_source(args, ldf, say)

    precond = None
    if args.precond == "illum":
        if ldf is None:
            raise SystemExit("--precond illum needs a lane-path gradient "
                             "engine (--grad-path lane/merged/lane_u)")
        t_il = time.perf_counter()
        illum = ldf.illumination()  # in the starting model p0
        precond = 1.0 / (illum + 0.01 * illum.max())
        precond = precond / precond.mean()
        say(f"illumination precond: {time.perf_counter() - t_il:.1f} s "
            f"(I range {illum.min():.3e}..{illum.max():.3e})", flush=True)

    bands = None
    if args.bands:
        bands = tuple(float(b) for b in args.bands.split(",")) + (None,)
    lr = args.lr if args.lr is not None else 0.01
    lo = float(vp_true.min()) - 0.3
    hi = float(vp_true.max()) + 0.3
    vg_factory = None
    if ldf is not None:
        vg_factory = (ldf.vg_factory_sharded(comm) if args.grad_shards > 1
                      else ldf.vg_factory)
    res = invert(
        p0, st0, dt, n_steps, shots, rcv, observed,
        fields=("vp",), optimizer=args.optimizer, lr=lr, iters=args.iters,
        bands=bands, smooth_iters=args.smooth, bounds={"vp": (lo, hi)},
        damp=damp, segment=args.segment, vel_op=vel_op, stress_op=stress_op,
        batch=args.batch, vg_factory=vg_factory, precond=precond,
        checkpoint_path=args.inv_checkpoint, resume=args.inv_resume,
        checkpoint_save=rank0, log=lambda s: say(s, flush=True))

    vp0 = theta_of_params(p0)["vp"].detach()
    vp = res.theta["vp"].detach()
    region = (vp_true - vp0).abs() > 0.05
    if not bool(region.any()):
        region = torch.ones_like(region)
    err0 = float((vp0 - vp_true).abs()[region].mean())
    err = float((vp - vp_true).abs()[region].mean())
    summary = {
        "E": E, "n_steps": n_steps, "shots": args.shots,
        "grad_path": args.grad_path, "optimizer": args.optimizer,
        "bands": args.bands, "misfit_first": res.misfits[0],
        "misfit_last": res.misfits[-1], "band_log": res.bands,
        "model_err_init": err0, "model_err_final": err,
        "model_err_reduction": err / max(err0, 1e-30),
        "wall_s": res.wall_s,
    }
    if wav_report is not None:
        summary.update(wav_report)
    ok = res.misfits[-1] < res.misfits[0] or err < err0
    if not rank0:
        return 0 if np.isfinite(err) else 1
    print(json.dumps(summary))
    if args.out:
        np.savez_compressed(
            args.out, vp_true=vp_true.cpu().numpy(),
            vp_init=vp0.cpu().numpy(), vp_final=vp.cpu().numpy(),
            misfits=np.asarray(res.misfits), centroids=c["cent"])
        print(f"model -> {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
