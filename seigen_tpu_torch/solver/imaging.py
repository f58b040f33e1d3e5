"""Seismic imaging post-processing on element fields (RTM support).

Port of ``seigen_tpu/solver/imaging.py``.  Reverse-time migration in the
adjoint-state formulation: the zero-lag cross-correlation image of the
forward and back-propagated wavefields IS the misfit gradient evaluated in
a smooth (reflector-free) background model, so imaging reuses the FWI
gradient engines unchanged.  What imaging adds is post-processing of the
raw gradient on per-element fields:

- :func:`laplacian_filter` — low-wavenumber artifact removal on the
  element graph (``g - mean(neighbours)``, ``iters`` times);
- :func:`acquisition_mute` — taper out the source/receiver imprint;
- :func:`normalize` — unit max-abs scaling;
- :func:`source_illumination` — the source-side illumination of the
  einsum loop (the compensation weight of a 3D image);
- :func:`rtm_image` — one gradient evaluation read as a migration.
"""

from __future__ import annotations

import numpy as np
import torch


def element_neighbours(p) -> np.ndarray:
    """(E, nf) producer-element index per face from the face pairing
    (boundary faces self-pair: implicit Neumann edges)."""
    nbr = p.nbr.cpu().numpy() if isinstance(p.nbr, torch.Tensor) \
        else np.asarray(p.nbr)
    return np.asarray(nbr[:, :, 0] // p.n_p, np.int64)


def laplacian_filter(p, g, iters: int = 1):
    """High-pass ``g`` on the element adjacency graph ((E,) -> (E,)):
    ``iters`` applications of ``g - mean_f g[nbr_f]``.  Returns a tensor
    (numpy input: a CPU float64 tensor)."""
    g = g if isinstance(g, torch.Tensor) else torch.as_tensor(np.asarray(g))
    e2 = torch.as_tensor(element_neighbours(p), device=g.device)
    for _ in range(iters):
        g = g - g[e2].mean(dim=1)
    return g


def acquisition_mute(centroids, points, radius: float):
    """(E,) smooth mute factor: 0 at acquisition points -> 1 outside (a
    product of smoothstep ramps in distance)."""
    cent = np.asarray(centroids, np.float64)
    m = np.ones(len(cent))
    for q in np.atleast_2d(np.asarray(points, np.float64)):
        t = np.clip(np.linalg.norm(cent - q, axis=1) / radius, 0.0, 1.0)
        m *= t * t * (3.0 - 2.0 * t)
    return m


def normalize(g):
    """Unit max-abs scaling (returns g unchanged if identically zero)."""
    g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) \
        else np.asarray(g)
    m = np.abs(g).max()
    return g / m if m > 0 else g


@torch.no_grad()
def source_illumination(p, state0, dt, n_steps, shots, damp=None):
    """(E,) float64 source-side illumination: the sum over shots, steps,
    nodes and components of u^2 in the einsum LF4 loop (one forward per
    shot in the background model).  The RTM deconvolution weight: in 3D
    the forward-field energy decays like r^-2, so a raw image is
    shallow-weighted without ``image / (I + eps I_max)``.  The lane twin is
    ``LaneDiffFwi.illumination``."""
    from .shots import shot_at
    from .timestep import make_step, numpy_dtype

    if shots.elems.ndim == 1:
        shot_list = [shots]
    else:
        shot_list = [shot_at(shots, k) for k in range(shots.elems.shape[0])]
    npdt = numpy_dtype(p.dtype)
    dt_ = npdt(dt)
    tot = np.zeros(state0.u.shape[0], np.float64)
    for src_k in shot_list:
        step = make_step(p, dt, order=4, src=src_k, damp=damp)
        st = state0
        acc = torch.zeros(state0.u.shape[0], dtype=state0.u.dtype,
                          device=state0.u.device)
        for k in range(n_steps):
            st = step(st, npdt(k) * dt_)
            acc = acc + torch.sum(st.u * st.u, dim=(1, 2))
        tot += acc.cpu().numpy().astype(np.float64)
    return tot


def rtm_image(vg, theta_bg: dict, field: str = "vp"):
    """Evaluate an FWI value-and-gradient engine as a migration.

    ``vg``: any gradient callable (``LaneDiffFwi.vg_factory``'s, or
    ``solver.adjoint.make_fwi_gradient``'s) with observed data recorded in
    the TRUE model; ``theta_bg``: the smooth background.  Returns
    ``(misfit, raw_image numpy)``, the image the gradient with respect to
    ``field``."""
    v, g = vg(theta_bg)
    if field not in g:
        raise KeyError(f"gradient has no field {field!r}; has {list(g)}")
    gf = g[field]
    return float(v), (gf.detach().cpu().numpy()
                      if isinstance(gf, torch.Tensor) else np.asarray(gf))
