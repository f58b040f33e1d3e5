"""Reverse-time migration: image reflectors with the adjoint stack.

Port of ``scripts/rtm.py`` with the same flags and defaults.  The adjoint-
state identity makes RTM a one-evaluation special case of FWI: record
observed data in the TRUE (reflector-bearing) model, evaluate the
seismogram-misfit gradient in the smooth background, and the material
gradient is the zero-lag cross-correlation image of the forward and
back-propagated wavefields.  Every gradient engine works unchanged
(``--grad-path einsum|lane|merged|lane_u``; the lane engines run their
kernels on the card); this program adds the imaging post-processing
(solver/imaging.py): source-illumination compensation, acquisition mute and
graph-Laplacian low-wavenumber removal.

Demo model: homogeneous background; the true model adds a flat reflector
below ``--z-reflector`` (by default an impedance (rho) step, imaged through
the rho gradient).  The JSON summary reports how tightly the filtered image
localizes the interface: the |image|-weighted mean depth and RMS spread
against the truth, and the energy fraction within half a wavelength.

    python -m seigen_tpu_torch.cli.rtm --cpu --f64 --n 16 --grad-path einsum
    python -m seigen_tpu_torch.cli.rtm --dim 3 --areal --grad-path merged
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
    ap.add_argument("--receivers", type=int, default=24)
    ap.add_argument("--T", type=float, default=None,
                    help="record length (default: two-way time + wavelet)")
    ap.add_argument("--f0", type=float, default=None)
    ap.add_argument("--z-reflector", type=float, default=0.35,
                    help="interface depth coordinate (vertical axis)")
    ap.add_argument("--contrast", type=float, default=0.3,
                    help="relative jump of --reflect below the reflector")
    ap.add_argument("--reflect", choices=["rho", "vp"], default="rho",
                    help="the field that carries the reflector ('rho': an "
                         "impedance-only contrast, pure scattering "
                         "sensitivity; 'vp' adds the smooth transmission "
                         "kernel to the image)")
    ap.add_argument("--areal", action="store_true",
                    help="3D: shots on a sqrt(S) x sqrt(S) grid and "
                         "receivers on an areal patch (line acquisition "
                         "cannot image a 3D volume)")
    ap.add_argument("--free-top", action="store_true",
                    help="free surface on top (default absorbing: the "
                         "ghost-free idealization)")
    ap.add_argument("--grad-path",
                    choices=["einsum", "lane", "merged", "lane_u"],
                    default="lane",
                    help="gradient engine; merged is structured-only, "
                         "lane_u works on any mesh")
    ap.add_argument("--segment", type=int, default=None,
                    help="checkpoint-segment length for the adjoint")
    ap.add_argument("--filter-iters", type=int, default=1,
                    help="graph-Laplacian high-pass applications")
    ap.add_argument("--illum-comp", choices=["source", "none"],
                    default="source",
                    help="divide the image by the source-side illumination "
                         "(one forward per shot in the background)")
    ap.add_argument("--mute-radius", type=float, default=0.18,
                    help="acquisition mute radius around sources/receivers")
    ap.add_argument("--out", type=str, default=None,
                    help="npz output (image, filtered, models, centroids)")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain operator versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = pick_device(args.cpu)
    dtype = run_dtype(args.f64)

    from ..mesh import box_mesh, build_discrete, rect_mesh
    from ..ops import Material, build_params, n_sig_for
    from ..solver import PointSource, State, absorbing_bc_fn, \
        build_receivers, build_sources, cfl_dt, grid, line, sponge_mask
    from ..solver.imaging import acquisition_mute, laplacian_filter, \
        normalize, rtm_image, source_illumination
    from ..solver.shots import shot_at, stack_shots

    t0_wall = time.perf_counter()
    dim, n, q = args.dim, args.n, args.degree
    zr = args.z_reflector
    free = [(dim - 1, "hi")] if args.free_top else []
    if args.free_top:
        src_depth, rcv_depth, sp_w = 0.85, 0.9, 0.15
    else:  # acquisition below the top sponge
        src_depth, rcv_depth, sp_w = 0.76, 0.8, 0.12
    shot_line = (0.25, 0.75)
    if dim == 2:
        dm = build_discrete(
            rect_mesh(n, n), q,
            bc_fn=absorbing_bc_fn(((0.0, 1.0),) * 2, free_sides=free))
        sponge = [(0, "lo"), (0, "hi"), (1, "lo")]
        rcv_line = ((0.1, rcv_depth), (0.9, rcv_depth))
    else:
        dm = build_discrete(
            box_mesh(n, n, n), q,
            bc_fn=absorbing_bc_fn(((0.0, 1.0),) * 3, free_sides=free))
        sponge = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
        rcv_line = ((0.1, 0.5, rcv_depth), (0.9, 0.5, rcv_depth))
    if not args.free_top:
        sponge.append((dim - 1, "hi"))

    E, n_p = dm.num_elements, dm.re.n_p
    h = float(dm.h.min())
    cent = np.asarray(dm.coords.mean(axis=1))
    depth_ax = dim - 1
    below = cent[:, depth_ax] < zr
    bg = {"vp": np.full(E, 2.0), "rho": np.ones(E)}
    true_f = dict(bg)
    true_f[args.reflect] = bg[args.reflect] * (1.0 + args.contrast * below)
    p0 = build_params(dm, Material(rho=1.0, vp=2.0, vs=1.0), dtype=dtype,
                      device=dev)
    vmax = float(true_f["vp"].max())
    field = args.reflect

    f0 = args.f0 or 0.3 * vmax / h / (q + 1)
    # two-way time from the shots to the reflector and back up to the
    # receivers, plus the wavelet onset
    T = args.T or ((src_depth - zr) + (rcv_depth - zr)) / 2.0 + 2.0 / f0
    dt = cfl_dt(h, vmax, q, 0.4)
    n_steps = int(np.ceil(T / dt))
    if args.segment:
        n_steps -= n_steps % args.segment

    def pos(x):
        return ((float(x), src_depth) if dim == 2
                else (float(x), 0.5, src_depth))

    if dim == 3 and args.areal:
        g = max(1, int(round(np.sqrt(args.shots))))
        shot_pos = [tuple(map(float, s))
                    for s in grid(shot_line, shot_line, g, g, src_depth)]
        args.shots = g * g
        gr = max(2, int(round(np.sqrt(args.receivers))))
        rcv_pts = grid((0.1, 0.9), (0.1, 0.9), gr, gr, rcv_depth)
        args.receivers = gr * gr
    else:
        shot_pos = [pos(x) for x in np.linspace(*shot_line, args.shots)]
        rcv_pts = line(*rcv_line, args.receivers)
    shots = stack_shots([
        build_sources(dm, [PointSource(position=s, f0=f0, radius=1.5 * h)],
                      dtype=dtype, device=dev)
        for s in shot_pos])
    rcv = build_receivers(dm, rcv_pts, dtype=dtype, device=dev)
    damp = torch.as_tensor(sponge_mask(dm, sponge, width=sp_w),
                           device=dev).to(dtype)
    st0 = State(u=torch.zeros((E, n_p, dim), dtype=dtype, device=dev),
                s=torch.zeros((E, n_p, n_sig_for(dim)), dtype=dtype,
                              device=dev))
    print(f"E={E} steps={n_steps} shots={args.shots} f0={f0:.2f} "
          f"grad_path={args.grad_path}", flush=True)

    theta_bg = {field: bg[field]}
    theta_true = {field: true_f[field]}
    if args.grad_path == "einsum":
        from ..solver.adjoint import make_fwi_gradient, run_segmented, \
            with_material

        with torch.no_grad():
            observed = [run_segmented(
                with_material(p0, **theta_true), st0, dt, n_steps,
                src=shot_at(shots, k), damp=damp, receivers=rcv)[1]
                for k in range(args.shots)]
        vgs = [make_fwi_gradient(p0, st0, dt, n_steps, shot_at(shots, k),
                                 rcv, observed[k], fields=(field,),
                                 damp=damp, segment=args.segment)[0]
               for k in range(args.shots)]

        def vg(theta):
            tot_v, tot_g = 0.0, None
            for vg_k in vgs:
                v, g = vg_k(theta)
                tot_v += v
                tot_g = g if tot_g is None else {
                    k: tot_g[k] + g[k] for k in g}
            return tot_v, tot_g
    else:
        from ..ops.structured_exchange import detect_structured
        from ..solver.lane_diff import LaneDiffFwi

        ex = detect_structured(dm)
        if ex is None and args.grad_path != "lane_u":
            raise SystemExit("--grad-path lane/merged needs a structured "
                             "mesh (lane_u works on any)")
        ldf = LaneDiffFwi(p0, dm, ex, dt, n_steps, shots, rcv, None,
                          damp=damp, segment=args.segment,
                          engine=args.grad_path)
        ldf.observed = ldf.synth(theta_true)
        vg = ldf.vg_factory(None)

    misfit, raw = rtm_image(vg, theta_bg, field=field)
    if args.illum_comp == "source":
        if args.grad_path == "einsum":
            illum = source_illumination(p0, st0, dt, n_steps, shots,
                                        damp=damp)
        else:
            illum = ldf.illumination()  # the same quantity, lane loop
        raw = raw / (illum + 0.01 * illum.max())

    # post-processing: mute the acquisition imprint, remove the smooth
    # backscatter, normalize
    acq = np.concatenate([np.asarray(shot_pos), np.asarray(rcv_pts)])
    mute = acquisition_mute(cent, acq, args.mute_radius)
    img = normalize(raw * mute)
    filt = normalize(laplacian_filter(
        p0, torch.as_tensor(raw * mute), args.filter_iters).numpy() * mute)

    # localization: |image|-weighted mean depth against the truth, in the
    # interior imaging window away from the sponges
    win = np.ones(E, bool)
    for ax in range(dim - 1):
        win &= (cent[:, ax] > 0.2) & (cent[:, ax] < 0.8)
    win &= cent[:, depth_ax] > 0.18  # above the bottom sponge
    w = np.abs(filt) * win
    z = cent[:, depth_ax]
    z_hat = float((w * z).sum() / w.sum())
    z_rms = float(np.sqrt((w * (z - z_hat) ** 2).sum() / w.sum()))
    # focus: the fraction of windowed |image| within half a wavelength
    # (+ an element) of the true horizon
    band = vmax / f0 / 2 + h
    focus = float(w[np.abs(z - zr) <= band].sum() / w.sum())
    summary = {
        "mode": "rtm", "dim": dim, "E": E, "n_steps": n_steps,
        "shots": args.shots, "grad_path": args.grad_path,
        "f0": f0, "vmax": vmax, "h": h, "areal": bool(args.areal),
        "illum_comp": args.illum_comp,
        "misfit": misfit, "z_reflector": zr, "z_imaged": z_hat,
        "z_error": abs(z_hat - zr), "z_rms_spread": z_rms,
        "focus_band": band, "focus": focus,
        "wall_s": time.perf_counter() - t0_wall,
    }
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    if args.out:
        np.savez_compressed(
            args.out, image=img, filtered=filt, mute=mute,
            true_field=true_f[field], bg_field=bg[field], field=field,
            centroids=cent, z_reflector=zr)
        print(f"image -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
