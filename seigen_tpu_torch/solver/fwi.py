"""Production full-waveform-inversion loop.

Port of ``seigen_tpu/solver/fwi.py``, with ``torch.optim`` in place of
optax:

- **Optimizers**: ``"adam"`` is ``torch.optim.Adam(lr, eps=1e-8)`` — the
  same update as optax's ``adam(lr)`` (eps outside the square root), so at
  float64 the iterates match the JAX package's to roundoff; ``"gd"`` is
  ``torch.optim.SGD(lr=1.0)`` on the max-normalised gradient, optax's
  ``sgd(1.0)`` there; ``"lbfgs"`` is ``torch.optim.LBFGS`` with its strong-
  Wolfe line search, one L-BFGS update per iteration.  optax's L-BFGS takes
  a zoom line search instead: the two searches accept different steps, so
  L-BFGS iterates are NOT comparable across the packages — both are held
  to reducing the misfit only.
- **Gradient smoothing**: a face-adjacency Jacobi smoother (element-graph
  Laplacian) applied to the raw gradient.
- **Frequency continuation**: stages of low-pass-filtered misfits
  (Gaussian FIR along time, applied identically to synthetic and observed
  data) from low to full band.
- **Multi-shot batching** (solver/shots.py) or any ``vg_factory``, e.g.
  ``solver.lane_diff.LaneDiffFwi.vg_factory``: gradients through the CUDA
  kernels by energy conjugation.
- **Box bounds**, projected after every update; ``precond``, a per-element
  weight multiplied into the gradient before smoothing.
- **Inversion checkpoints**: band, iteration, theta, optimizer state and
  misfit history written atomically; a resume continues bitwise (adam and
  gd).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..ops.elastic import ElasticParams
from .adjoint import run_segmented, theta_of_params, to_like, \
    value_and_grad, with_material
from .receivers import ReceiverData
from .shots import run_shots, shot_at
from .source import SourceData
from .timestep import State


# --- frequency continuation: differentiable low-pass ----------------------
def lowpass_taps(dt: float, fmax: float, dtype=torch.float32,
                 device="cuda") -> torch.Tensor:
    """Gaussian FIR taps with -3 dB at ``fmax`` (normalized, odd length):
    a monotone frequency response and fast-decaying taps, sigma from
    |H(f)|^2 = 1/2 at fmax."""
    sigma_t = float(np.sqrt(np.log(2.0) / 2.0) / (np.pi * fmax))
    sigma_n = max(sigma_t / dt, 1e-3)
    half = max(int(np.ceil(4.0 * sigma_n)), 1)
    n = np.arange(-half, half + 1)
    taps = np.exp(-0.5 * (n / sigma_n) ** 2)
    return torch.as_tensor(taps / taps.sum(), device=device).to(dtype)


def lowpass(x: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply FIR ``taps`` along ``axis`` (same-length output, zero pad)."""
    x = torch.movedim(x, axis, -1)
    shp = x.shape
    taps = taps.to(device=x.device)
    half = taps.shape[0] // 2
    y = torch.nn.functional.conv1d(
        x.reshape(-1, 1, shp[-1]).to(taps.dtype), taps.reshape(1, 1, -1),
        padding=half)
    return torch.movedim(y.reshape(shp), -1, axis)


# --- gradient smoothing ----------------------------------------------------
def make_smoother(p: ElasticParams, iters: int = 2, weight: float = 0.5):
    """Element-graph Jacobi smoother g -> smoothed g ((E,) tensors):
    ``iters`` applications of g <- (1-w) g + w mean_f g[e2[:, f]], e2 the
    producer element of each face (boundary faces self-pair)."""
    e2 = p.nbr[:, :, 0] // p.n_p  # (E, nf)

    def smooth(g):
        for _ in range(iters):
            g = (1.0 - weight) * g + weight * g[e2.to(g.device)].mean(dim=1)
        return g

    return smooth


# --- the production loop ---------------------------------------------------
@dataclass
class FwiResult:
    theta: dict
    misfits: list = field(default_factory=list)
    bands: list = field(default_factory=list)
    wall_s: float = 0.0


def _save_npz(ck: Path, payload: dict):
    """Atomic npz write: write-then-rename."""
    tmp = ck.with_name(ck.stem + ".tmp.npz")
    np.savez(tmp, **payload)
    tmp.replace(ck)


def _opt_payload(opt: torch.optim.Optimizer) -> dict:
    """torch's own optimizer state_dict as npz entries: ``opt_state`` (JSON
    of the param groups and each parameter's state names) and one array
    ``opt_<param>_<name>`` per state tensor."""
    sd = opt.state_dict()
    out, names = {}, {}
    for i, st in sd["state"].items():
        names[str(i)] = sorted(st)
        for k in st:
            v = st[k]
            out[f"opt_{i}_{k}"] = (v.detach().cpu().numpy()
                                   if isinstance(v, torch.Tensor)
                                   else np.asarray(v))
    out["opt_state"] = json.dumps({"param_groups": sd["param_groups"],
                                   "names": names})
    return out


def _opt_restore(opt: torch.optim.Optimizer, data, device):
    meta = json.loads(str(data["opt_state"]))
    state = {int(i): {k: torch.as_tensor(data[f"opt_{i}_{k}"]).to(device)
                      for k in ks}
             for i, ks in meta["names"].items()}
    # Adam keeps its step counter on the host unless capturable
    for st in state.values():
        if "step" in st:
            st["step"] = st["step"].cpu()
    opt.load_state_dict({"state": state,
                         "param_groups": meta["param_groups"]})


def invert(
    p0: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    shots: SourceData,
    receivers: ReceiverData,
    observed,
    *,
    fields: tuple = ("vp",),
    optimizer: str = "adam",
    lr: float = 0.02,
    iters: int = 20,
    bands: tuple | None = None,
    smooth_iters: int = 2,
    smooth_weight: float = 0.5,
    bounds: dict | None = None,
    order: int = 4,
    damp: torch.Tensor | None = None,
    segment: int | None = None,
    vel_op=None,
    stress_op=None,
    batch: str = "vmap",
    theta0: dict | None = None,
    vg_factory=None,
    precond=None,
    log=None,
    checkpoint_path: str | None = None,
    resume: bool = False,
    checkpoint_save: bool = True,
    checkpoint_every: int = 1,
) -> FwiResult:
    """Multi-stage FWI: for each band (low -> full), minimize the
    low-passed multi-shot L2 misfit over ``theta`` = {field: (E,)}.

    ``shots``: stacked SourceData (solver.shots.stack_shots);
    ``observed``: (S, n_steps, R, C) seismograms from the true model.
    ``bands``: cutoff frequencies in Hz, e.g. (4.0, 8.0, None) — None is
    the unfiltered full band.  ``bounds``: {field: (lo, hi)} box
    projection.  ``optimizer``: "adam" | "lbfgs" | "gd" (max-normalised
    descent).  ``iters`` per band.  ``vg_factory(taps) -> vg``: a gradient
    engine in place of the einsum one (vg(theta) -> (misfit, grads)).

    ``checkpoint_path`` + ``resume``: the inversion state is written
    atomically every ``checkpoint_every`` iterations and restored on
    resume, so the resumed run is bitwise the uninterrupted one (adam and
    gd; L-BFGS carries line-search state).  The npz holds the JAX
    package's keys for the model and the history (``band_idx``, ``it``,
    ``misfits``, ``band_log``, ``theta_keys``, ``theta_<field>``); the
    optimizer state is torch's own ``state_dict`` (``opt_state`` and
    ``opt_<param>_<name>``), which does not interchange with optax's
    leaves.  ``checkpoint_save=False`` reads a resume but never writes
    (the ranks of a sharded inversion but the one that writes).

    ``precond``: per-element (E,) positive weights multiplied into every
    gradient field before smoothing (e.g. 1/(I + eps) from
    LaneDiffFwi.illumination).  Adam is per-coordinate scale-invariant, so
    a static diagonal precond reaches it only through the smoother's
    neighbour mixing; it is the 'gd' lever.

    Returns FwiResult: the final theta (tensors), per-iteration misfits,
    the band log and the wall-clock seconds.
    """
    dtype, dev = p0.dtype, p0.device
    if precond is not None:
        precond = to_like(precond, p0.Ginv)
    if bands is None:
        bands = (None,)
    obs_all = to_like(observed, p0.Ginv)
    full = theta0 if theta0 is not None else theta_of_params(p0)
    theta = {k: to_like(full[k], p0.Ginv).detach().clone()
             for k in (theta0 if theta0 is not None else fields)}
    smoothp = (make_smoother(p0, smooth_iters, smooth_weight)
               if smooth_iters else None)

    def project_(th):
        with torch.no_grad():
            for k, (lo, hi) in (bounds or {}).items():
                if k in th:
                    th[k].clamp_(lo, hi)

    def make_vg(taps):
        obs = obs_all if taps is None else lowpass(obs_all, taps, axis=1)
        if batch == "host":
            def loss_one(th, i):
                _, seis = run_segmented(
                    with_material(p0, **th), state0, dt, n_steps,
                    segment=segment, order=order, src=shot_at(shots, i),
                    damp=damp, receivers=receivers, vel_op=vel_op,
                    stress_op=stress_op)
                if taps is not None:
                    seis = lowpass(seis, taps, axis=0)
                r = seis - obs[i]
                return 0.5 * torch.sum(r * r)

            def vg(th):
                tot_v, tot_g = 0.0, None
                for i in range(shots.elems.shape[0]):
                    v, g = value_and_grad(lambda t: loss_one(t, i), th)
                    tot_v += v
                    tot_g = g if tot_g is None else {
                        k: tot_g[k] + g[k] for k in g}
                return tot_v, tot_g

            return vg

        def loss(th):
            _, seis = run_shots(
                with_material(p0, **th), state0, dt, n_steps, shots,
                receivers=receivers, order=order, damp=damp,
                segment=segment, vel_op=vel_op, stress_op=stress_op,
                batch=batch)
            if taps is not None:
                seis = lowpass(seis, taps, axis=1)
            r = seis - obs
            return 0.5 * torch.sum(r * r)

        return lambda th: value_and_grad(loss, th)

    misfits: list = []
    band_log: list = []

    # --- inversion-state checkpointing (adam/gd) ----------------------
    ck = None
    if checkpoint_path:
        if optimizer == "lbfgs":
            raise ValueError("checkpoint_path supports adam/gd only")
        ck = Path(checkpoint_path)
        if ck.suffix != ".npz":
            ck = ck.with_name(ck.name + ".npz")
    start_band, start_it = 0, 0
    resume_data = None
    if ck is not None and resume and ck.exists():
        data = np.load(ck)
        start_band = int(data["band_idx"])
        start_it = int(data["it"]) + 1
        misfits = [float(v) for v in data["misfits"]]
        band_log = json.loads(str(data["band_log"]))
        theta = {k: torch.as_tensor(data[f"theta_{k}"]).to(dev)
                 for k in json.loads(str(data["theta_keys"]))}
        resume_data = data
        if start_it >= iters:  # saved at a band boundary: the band-end
            # log entry is appended AFTER the save, so restore it here
            band_log.append({"fc": bands[start_band],
                             "misfit_end": misfits[-1]})
            start_band, start_it, resume_data = start_band + 1, 0, None
        if log:
            log(f"resumed from {ck}: band_idx={start_band} it={start_it}")

    def save_ck(band_idx, it, opt):
        payload = {
            "band_idx": band_idx, "it": it,
            "misfits": np.asarray(misfits, np.float64),
            "band_log": json.dumps(band_log),
            "theta_keys": json.dumps(list(theta.keys())),
        }
        for k, v in theta.items():
            payload[f"theta_{k}"] = v.detach().cpu().numpy()
        payload.update(_opt_payload(opt))
        _save_npz(ck, payload)

    def process(grad):
        """precond, smoothing and (gd) max normalisation of a gradient."""
        if precond is not None:
            grad = {k: v * precond for k, v in grad.items()}
        if smoothp is not None:
            grad = {k: smoothp(v) for k, v in grad.items()}
        if optimizer == "gd":
            gmax = max(float(v.abs().max()) for v in grad.values())
            grad = {k: (lr / max(gmax, 1e-30)) * v for k, v in grad.items()}
        return grad

    t_start = time.perf_counter()
    for band_idx, fc in enumerate(bands):
        if band_idx < start_band:
            continue
        taps = (None if fc is None
                else lowpass_taps(dt, float(fc), dtype=dtype, device=dev))
        vg = vg_factory(taps) if vg_factory is not None else make_vg(taps)
        params = [theta[k] for k in theta]

        if optimizer == "lbfgs":
            # raw gradients: smoothing would make the line search's values
            # and gradients inconsistent (L-BFGS builds its own
            # preconditioner)
            # one update per iteration; no early exits on small values
            # (the misfit's scale is the data's)
            opt = torch.optim.LBFGS(params, lr=1.0, max_iter=1, max_eval=25,
                                    tolerance_grad=0.0, tolerance_change=0.0,
                                    line_search_fn="strong_wolfe")

            def closure():
                v, g = vg({k: theta[k].detach() for k in theta})
                for k in theta:
                    theta[k].grad = g[k].to(dtype)
                return torch.as_tensor(v, dtype=dtype)

            for it in range(iters):
                value = float(opt.step(closure))
                project_(theta)
                misfits.append(value)
                if log:
                    log(f"band={fc} iter={it} misfit={value:.4e}")
        else:
            opt = (torch.optim.Adam(params, lr=lr, eps=1e-8)
                   if optimizer == "adam"
                   else torch.optim.SGD(params, lr=1.0))
            it_first = 0
            if band_idx == start_band and resume_data is not None:
                _opt_restore(opt, resume_data, dev)
                it_first = start_it
            for it in range(it_first, iters):
                value, grad = vg({k: theta[k].detach() for k in theta})
                grad = process(grad)
                for k in theta:
                    theta[k].grad = grad[k].to(dtype)
                opt.step()
                project_(theta)
                misfits.append(float(value))
                if log:
                    log(f"band={fc} iter={it} misfit={float(value):.4e}")
                if ck is not None and (it + 1 == iters
                                       or (it + 1) % checkpoint_every == 0):
                    if checkpoint_save:
                        save_ck(band_idx, it, opt)
        for k in theta:
            theta[k].grad = None
        band_log.append({"fc": fc, "misfit_end": misfits[-1]})

    return FwiResult(theta=theta, misfits=misfits, bands=band_log,
                     wall_s=time.perf_counter() - t_start)
