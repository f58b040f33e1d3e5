"""Differentiable lane-major path: FWI gradients through the CUDA kernels.

Port of ``seigen_tpu/solver/lane_diff.py``.  No kernel is added: two
structural facts of the discretization make every kernel's transpose one
launch of the OTHER kernel.

1. **Material is exactly multiplicative** (ops/elastic.py): the velocity
   operator factors as V = (1/rho) * A and the stress operator as
   S = C_V(lam, mu) * B', where A and B' are MATERIAL-FREE linear maps —
   the runners' operators instantiated at inv_rho = 1 and at lam = 0,
   mu = 1/2 (the Hooke law is then the identity on tensor strain, so B'
   emits the Voigt strain of u).  The material application is a few tensor
   row operations on the lane-major state, and autograd through THOSE
   gives the exact material gradient.

2. **Discrete integration by parts** makes A and B' skew-adjoint under the
   per-element mass weights: with W_u = detJ (M x I) on u rows and
   W_s = detJ (M x K^-1) on sigma rows (M the reference mass matrix, K the
   Voigt shear doubling diag(1,..,1,1/2,..)), W_u A = -B'^T W_s holds
   exactly, boundary rows included.  Hence

       A^T  = -detJ (M x K^-1)  B'  detJ^-1 (M^-1 x I)
       B'^T = -detJ (M x I)     A   detJ^-1 (M^-1 x K)

   ``make_conjugated_ops`` wraps each engine's A and B' in a
   ``torch.autograd.Function`` whose backward is exactly this: the adjoint
   sweep launches the same kernels as the forward sweep.

Engines (``LaneDiffFwi(engine=)``): ``"lane"`` (LaneMajorRunner: K4 SIG /
K5 TR), ``"merged"`` (MergedLaneRunner: K1 / K2, with ``packed`` the P1
two-elements-per-lane K1pk / K2pk, per-ROW Jacobians and material) and
``"lane_u"`` (UnstructuredLaneRunner: K4 TRAC SEL / K5 SEL).  On CUDA
tensors the operators launch the kernels (float32); on CPU tensors they run
their plain versions.

The step is composed by solver.timestep.compose_lf_step; the source
injection and the sponge are out-of-place tensor operations, so autograd
differentiates the whole loop — sources, receivers, filtering, misfit —
with each operator transpose riding the kernels.  Tensors that do not
require grad stay out of the graph: inverting vp alone saves only the
strain-trace rows that lam multiplies (npp, L) per stress application.
``segment`` (torch.utils.checkpoint chunks) bounds the stored steps.
``vg_factory_sharded`` lays the shots over the ranks of a process group
(shot data parallelism); parallel/dd_diff_base.py decomposes the domain of
each shot instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.elastic import ElasticParams
from ..ops.structured_exchange import StructuredExchange
from .adjoint import lame_rows, theta_of_params, value_and_grad
from .receivers import ReceiverData
from .source import SourceData, ricker
from .timestep import compose_lf_step, scan_steps

__all__ = ["LaneDiffFwi", "lame_rows", "make_conjugated_ops",
           "theta_of_params"]


def _material_free(p: ElasticParams) -> ElasticParams:
    """Params with inv_rho = 1 (velocity operator -> A) and lam = 0,
    mu = 1/2 (stress operator -> the tensor-strain map B')."""
    return dataclasses.replace(
        p, inv_rho=torch.ones_like(p.inv_rho), lam=torch.zeros_like(p.lam),
        mu=torch.full_like(p.mu, 0.5))


def _mass_weights(dm, runner, lanes, L, pars=None):
    """Per-element mass-conjugation weights in lane layout.

    Mn / Mninv embed the reference mass matrix into the padded npp rows
    (identity on pad rows, which stay zero); ``detj`` is the element
    Jacobian of each lane (``lanes``: the lane of each class-major element)
    and 1 on lanes no element owns, so the inverse weight stays finite
    there.  Packed runners (n_par = 2, two elements per lane on disjoint
    parity row sections): Mn is block-diagonal per parity and detj a
    per-ROW (npp, L) array, since the paired elements have different
    Jacobians; ``pars`` gives each element's parity."""
    d = runner.d
    npp, n_p = d.npp, d.n_p
    n_par = getattr(runner, "n_par", 1)
    hp = npp // n_par
    M = np.asarray(dm.re.M, np.float64)
    Mn = np.eye(npp)
    vals = np.asarray(dm.detJ, np.float64)[runner._old_of_new]
    lanes = np.asarray(lanes)
    if n_par == 1:
        Mn[:n_p, :n_p] = M
        detj = np.ones((1, L))
        detj[0, lanes] = vals
    else:
        pars = np.asarray(pars)
        detj = np.ones((npp, L))
        for par in range(n_par):
            Mn[par * hp : par * hp + n_p, par * hp : par * hp + n_p] = M
            kk = pars == par
            detj[par * hp : (par + 1) * hp, lanes[kk]] = vals[kk][None]

    def dev(a):
        return torch.as_tensor(a, device=runner.device).to(runner.dtype)

    return {"Mn": dev(Mn), "Mninv": dev(np.linalg.inv(Mn)),
            "detj": dev(detj), "idetj": dev(1.0 / detj)}


def _voigt_kinv(dim, dtype, device):
    """diag(K^-1): Voigt shear doubling (engineering <- tensor strain)."""
    k = [1.0] * dim + [2.0] * (3 * (dim - 1) - dim)
    return torch.tensor(k, dtype=dtype, device=device)


def _wmul(x, Mm, dj, kd, C, npp):
    """dj (Mm x diag(kd)) applied to a (C*npp, L) lane field; ``dj`` is
    (1, L) per lane or (npp, L) per row (packed layouts)."""
    y = torch.matmul(Mm, x.reshape(C, npp, x.shape[-1]))
    if kd is not None:
        y = y * kd[:, None, None]
    return (y * dj).reshape(C * npp, -1)


class ConjugatedOps:
    """The material-free operators A (sigma rows -> u rows) and B' (u rows
    -> tensor-strain rows) of one engine, differentiable by energy
    conjugation: ``A(x)`` / ``B(x)`` are ``torch.autograd.Function``s whose
    backward is one application of the other operator between mass
    weights ``w`` (see the module docstring)."""

    def __init__(self, a_prim, b_prim, w, dim, n_sig, npp):
        self.a_prim, self.b_prim, self.w = a_prim, b_prim, w
        self.dim, self.n_sig, self.npp = dim, n_sig, npp
        self.kinv = _voigt_kinv(dim, w["Mn"].dtype, w["Mn"].device)
        self.kdiag = 1.0 / self.kinv

    def a_transpose(self, ubar):
        w = self.w
        y = self.b_prim(_wmul(ubar.contiguous(), w["Mninv"], w["idetj"],
                              None, self.dim, self.npp))
        return -_wmul(y, w["Mn"], w["detj"], self.kinv, self.n_sig,
                      self.npp)

    def b_transpose(self, ebar):
        w = self.w
        y = self.a_prim(_wmul(ebar.contiguous(), w["Mninv"], w["idetj"],
                              self.kdiag, self.n_sig, self.npp))
        return -_wmul(y, w["Mn"], w["detj"], None, self.dim, self.npp)

    def A(self, x):
        return _OpA.apply(x, self)

    def B(self, x):
        return _OpB.apply(x, self)


class _OpA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ops):
        ctx.ops = ops
        return ops.a_prim(x.contiguous())

    @staticmethod
    def backward(ctx, ubar):
        return ctx.ops.a_transpose(ubar), None


class _OpB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ops):
        ctx.ops = ops
        return ops.b_prim(x.contiguous())

    @staticmethod
    def backward(ctx, ebar):
        return ctx.ops.b_transpose(ebar), None


def make_conjugated_ops(runner, w) -> ConjugatedOps:
    """THE energy-conjugation factory over a material-free runner: its
    velocity and stress operators as A and B'.  LaneMajorRunner and
    UnstructuredLaneRunner give theirs directly (``_vel``/``_stress``, the
    exchange included: K4 SIG / K5 TR, or K4 TRAC SEL / K5 SEL); the
    MergedLaneRunner's read their input's own-face traces, seeded per
    application (K1 the traction traces, K2 the velocity traces)."""
    d = runner.d
    if hasattr(runner, "plan"):
        r = runner

        def a_prim(sig):
            return r._vel_op(r.plan, d, sig, r.traction_traces(sig),
                             r.mask)[0]

        def b_prim(u):
            tr = torch.matmul(r._rmat, u.reshape(d.dim, d.npp, -1))
            return r._stress_op(r.plan, d, u,
                                r._on_trace_lanes(r._place_traces(tr)),
                                r.mask)[0]
    else:
        a_prim, b_prim = runner._vel, runner._stress
    return ConjugatedOps(a_prim, b_prim, w, d.dim, d.n_sig, d.npp)


class LaneDiffFwi:
    """FWI value-and-gradient engine on the differentiable lane path.

    Built once per inversion from the true-geometry params ``p0`` (their
    material is the default of fields theta does not carry; the operators
    run material-free), the discrete mesh (mass weights), a detected
    StructuredExchange (``ex``; ignored by ``engine="lane_u"``), and the
    acquisition: stacked shots (solver.shots.stack_shots, or one shot),
    receivers and observed seismograms (S, n_steps, R, dim) (numpy or
    tensor; None until assigned, e.g. from ``synth``).

    ``impl``: "kernel" (CUDA kernels, CUDA tensors only), "reference"
    (their plain versions) or None (follow p0's device).  ``aniso="vti"``
    (3D): theta may carry Thomsen epsilon/delta/gamma per element and the
    stress material becomes the per-element Voigt contraction.

    ``vg_factory(taps)`` plugs into solver.fwi.invert: the shots run one
    after the other and their gradients are summed.
    """

    def __init__(
        self,
        p0: ElasticParams,
        dm,
        ex: StructuredExchange | None,
        dt: float,
        n_steps: int,
        shots: SourceData,
        receivers: ReceiverData,
        observed,
        *,
        order: int = 4,
        damp=None,
        segment: int | None = None,
        impl: str | None = None,
        aniso: str | None = None,
        theta_defaults: dict | None = None,
        engine: str = "lane",
        packed: bool | str = False,
    ):
        if engine not in ("lane", "merged", "lane_u"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "merged" and order != 4:
            raise ValueError("engine='merged' is LF4-only")
        if receivers is None:
            raise ValueError("LaneDiffFwi needs receivers (the misfit is "
                             "a seismogram misfit)")
        if aniso not in (None, "vti"):
            raise ValueError(f"unknown aniso mode {aniso!r}")
        if aniso == "vti" and p0.dim != 3:
            raise ValueError("aniso='vti' is 3D")
        if packed and engine != "merged":
            raise ValueError("packed=... is engine='merged' only")
        self.engine, self.aniso = engine, aniso
        self.device, self.dtype = p0.device, p0.dtype
        self._theta0 = {k: v.detach() for k, v in theta_of_params(p0).items()}
        if aniso:
            z = torch.zeros_like(p0.lam)
            self._theta0.update(epsilon=z, delta=z, gamma=z)
        for k, v in (theta_defaults or {}).items():
            self._theta0[k] = self._tensor(v)

        if packed and aniso:
            raise ValueError("the packed layout is isotropic only")
        self._E_mesh = p0.Ginv.shape[0]
        self.runner = r = self._make_runner(
            engine, _material_free(p0), dm, ex, dt, order=order, damp=damp,
            receivers=receivers, impl=impl, packed=packed)
        # the runner's elements (all of them, or a shard's)
        self.E = len(r._old_of_new)
        if engine == "merged":
            self._L = r.mask.shape[1]
            e_new = np.arange(self.E)
            lanes = r._slane(e_new)
            self._npar = r.n_par
            pars = r._epar(e_new)
            self.w = _mass_weights(dm, r, lanes, self._L, pars)
            dmp = r.d.damp
            self._damp = (None if dmp is None else
                          (dmp.repeat(r.d.dim, 1), dmp.repeat(r.d.n_sig, 1)))
        else:
            self._L = r.E
            lanes = np.arange(self.E)
            self._npar = 1
            pars = np.zeros(self.E, np.int64)
            self.w = _mass_weights(dm, r, lanes, self._L)
            self._damp = (None if r.damp_u is None
                          else (r.damp_u, r.damp_s))
        self.ops = make_conjugated_ops(r, self.w)
        d = r.d
        self._hp = d.npp // self._npar
        self.dt = r.dt
        self.order = order
        self.n_steps = n_steps
        self.segment = segment
        self.observed = observed
        self._perm = torch.as_tensor(r._old_of_new, device=self.device)
        self._lanes_np = np.asarray(lanes)
        self._pars_np = np.asarray(pars)
        # material placement: element k (class-major) of parity par goes to
        # rows par*hp .. (par+1)*hp of its lane (one row unpacked)
        rows = 1 if self._npar == 1 else d.npp
        self._mshape = (rows, self._L)
        if self._npar == 1:
            flat, src = self._lanes_np, np.arange(self.E)
        else:
            j = np.arange(self._hp)
            flat = ((self._pars_np[:, None] * self._hp + j[None]) * self._L
                    + self._lanes_np[:, None]).reshape(-1)
            src = np.repeat(np.arange(self.E), self._hp)
        self._mflat = torch.as_tensor(flat, device=self.device)
        self._msrc = torch.as_tensor(src, device=self.device)
        self._lanes = torch.as_tensor(self._lanes_np, device=self.device)

        # per-shot lane-major source data (host-side, once)
        elems = shots.elems.cpu().numpy()
        fields = {f.name: getattr(shots, f.name)
                  for f in dataclasses.fields(SourceData)}
        if elems.ndim == 1:  # one shot -> add the shot axis
            fields = {k: v[None] for k, v in fields.items()}
            elems = elems[None]
        self.n_shots, K = elems.shape
        e_new = r._new_of_old[elems]  # (S, K) class-major index
        # a shard's runner holds some of the elements: the others' entries
        # inject nothing (zero vectors at lane 0)
        own = e_new >= 0
        e_new = np.where(own, e_new, 0)
        src_lanes = self._lanes_np[e_new]
        base = self._pars_np[e_new] * self._hp  # (S, K) parity row offset
        s_i = np.arange(self.n_shots)[:, None]
        k_i = np.arange(K)[None, :]

        def lane_vecs(v, C):
            v = v.detach().cpu().numpy().astype(np.float64)  # (S, K, n_p, C)
            v = v * own[:, :, None, None]
            out = np.zeros((self.n_shots, C * d.npp, K))
            for c in range(C):
                for jj in range(d.n_p):
                    out[s_i, c * d.npp + base + jj, k_i] = v[:, :, jj, c]
            return out

        self.src = {
            "elems": torch.as_tensor(src_lanes, device=self.device),
            "vu": self._tensor(lane_vecs(fields["vec_u"], d.dim)),
            "vs": self._tensor(lane_vecs(fields["vec_s"], d.n_sig)),
            "f0": self._tensor(fields["f0"]),
            "t0": self._tensor(fields["t0"]),
            "amp": self._tensor(fields["amp"]),
        }

    @staticmethod
    def _make_runner(engine, pf, dm, ex, dt, order, damp, receivers, impl,
                     packed):
        """The engine's material-free runner on one device."""
        if engine == "merged":
            from .lane_merged import MergedLaneRunner

            return MergedLaneRunner(pf, ex, dt, damp=damp,
                                    receivers=receivers, impl=impl,
                                    packed=packed)
        if engine == "lane_u":
            # the conjugation identity is a property of the conforming
            # mesh's bilinear form, not of the structured exchange
            from .lane_unstructured import UnstructuredLaneRunner

            return UnstructuredLaneRunner(
                pf, dt, order=order, damp=damp, receivers=receivers,
                impl=impl, centroids=np.asarray(dm.coords.mean(axis=1)))
        from .lane_major import LaneMajorRunner

        return LaneMajorRunner(pf, ex, dt, order=order, damp=damp,
                               receivers=receivers, impl=impl)

    def _tensor(self, x) -> torch.Tensor:
        """x (numpy or tensor) on the engine's device and dtype."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x), device=self.device).to(
            self.dtype)

    def _shot(self, k: int) -> dict:
        return {kk: v[k] for kk, v in self.src.items()}

    def _obs(self, taps):
        """The observed data as a tensor, low-passed along time with
        ``taps`` as the synthetics are."""
        if self.observed is None:
            raise ValueError("observed data not set (pass at construction "
                             "or assign .observed, e.g. from synth())")
        obs = self._tensor(self.observed)
        if taps is not None:
            from .fwi import lowpass

            obs = lowpass(obs, taps, axis=1)
        return obs

    # --- material rows from theta ------------------------------------
    def _place(self, a, dead):
        """(E,) class-major element values -> lane rows (1, L), or per row
        (npp, L) packed; ``dead`` where no element is placed."""
        out = torch.full((self._mshape[0] * self._L,), dead,
                         dtype=self.dtype, device=self.device)
        return out.index_copy(0, self._mflat, a[self._msrc]).reshape(
            self._mshape)

    def _mrows(self, theta: dict):
        """theta (E,) fields in p0's element order -> lane material rows;
        fields absent from theta take p0's values (or theta_defaults)."""
        full = {**self._theta0, **theta}

        def take(k):
            return self._tensor(full[k])[self._perm]

        vp, vs, rho = take("vp"), take("vs"), take("rho")
        irho = 1.0 / rho
        if self.aniso == "vti":
            from ..ops.anisotropic import vti_stiffness_torch

            C = vti_stiffness_torch(vp, vs, rho, take("epsilon"),
                                    take("delta"), take("gamma"))
            n = C.shape[1]
            Cp = torch.zeros((n, n, self._L), dtype=self.dtype,
                             device=self.device)
            Cp = Cp.index_copy(2, self._lanes, C.permute(1, 2, 0))
            return {"C": Cp, "irho": self._place(irho, 1.0)}
        lam, mu, _ = lame_rows(vp, vs, rho)
        return {"lam": self._place(lam, 0.0), "mu": self._place(mu, 0.0),
                "irho": self._place(irho, 1.0)}

    # --- the differentiable step -------------------------------------
    def _make_step(self, mrows, src_k):
        d = self.runner.d
        n_sig, npp, dim = d.n_sig, d.npp, d.dim
        irho = mrows["irho"]
        A, B = self.ops.A, self.ops.B

        def vel(s_lm):
            y = A(s_lm)
            return (y.reshape(dim, npp, -1) * irho).reshape(y.shape)

        if "C" in mrows:  # per-element Voigt stiffness (aniso)
            C = mrows["C"]
            shear2 = _voigt_kinv(dim, self.dtype, self.device)

            def stress(u_lm):
                # B' emits TENSOR strain; C expects engineering shears
                eps = B(u_lm).reshape(n_sig, npp, -1)
                out = torch.einsum("pqe,qne->pne", C,
                                   eps * shear2[:, None, None])
                return out.reshape(n_sig * npp, -1)
        else:
            lam, mu = mrows["lam"], mrows["mu"]

            def stress(u_lm):
                eps = B(u_lm).reshape(n_sig, npp, -1)
                tr = torch.sum(eps[:dim], dim=0)
                out = 2.0 * mu * eps
                out = torch.cat([out[:dim] + lam * tr, out[dim:]])
                return out.reshape(n_sig * npp, -1)

        elems = src_k["elems"]

        def wavelet(t):
            return src_k["amp"] * ricker(t, src_k["f0"], src_k["t0"])

        def inject_u(du, t):
            return du.index_add(1, elems, src_k["vu"] * wavelet(t)[None])

        def inject_s(ds, t):
            return ds.index_add(1, elems, src_k["vs"] * wavelet(t)[None])

        damp = self._damp
        post = ((lambda u, s: (u, s)) if damp is None
                else (lambda u, s: (u * damp[0], s * damp[1])))
        lf = compose_lf_step(vel=vel, stress=stress, inject_u=inject_u,
                             inject_s=inject_s, post=post, dt=self.dt,
                             order=self.order)
        return lambda c, t: lf(c[0], c[1], t)

    def _zero_state(self):
        d = self.runner.d
        return (torch.zeros((d.dim * d.npp, self._L), dtype=self.dtype,
                            device=self.device),
                torch.zeros((d.n_sig * d.npp, self._L), dtype=self.dtype,
                            device=self.device))

    def _times(self):
        npdt = type(self.dt)
        return [npdt(k) * self.dt for k in range(self.n_steps)]

    def _seis_one(self, theta, src_k, segment=None):
        """Seismograms (n_steps, R, dim) of ONE shot from a zero initial
        state (differentiable)."""
        step = self._make_step(self._mrows(theta), src_k)
        r = self.runner
        _, seis = scan_steps(step, self._zero_state(), self._times(),
                             lambda c: r._sample(c[0]), segment)
        return seis

    def _loss_one(self, theta, src_k, obs, taps):
        """Misfit of ONE shot from a zero initial state (differentiable)."""
        seis = self._seis_one(theta, src_k, self.segment)
        if taps is not None:
            from .fwi import lowpass

            seis = lowpass(seis, taps, axis=0)
        res = seis - obs
        return 0.5 * torch.sum(res * res)

    def _theta(self, theta: dict | None) -> dict:
        return {k: self._tensor(v) for k, v in (theta or {}).items()}

    @torch.no_grad()
    def illumination(self, theta: dict | None = None):
        """Source-side illumination I_e = sum over shots, steps, nodes and
        components of u^2 (the diagonal pseudo-Hessian proxy), accumulated
        inside the forward lane loop in the model ``theta`` (default: p0's
        material).  Returns (E,) float64 in p0's element order; e.g.
        ``precond = 1/(I + 0.01*I.max())`` for solver.fwi.invert."""
        d = self.runner.d
        mrows = self._mrows(self._theta(theta))
        tot = torch.zeros(self._mshape, dtype=torch.float64,
                          device=self.device)
        for k in range(self.n_shots):
            step = self._make_step(mrows, self._shot(k))
            c = self._zero_state()
            acc = torch.zeros(self._mshape, dtype=self.dtype,
                              device=self.device)
            for t in self._times():
                c = step(c, t)
                u2 = (c[0] * c[0]).reshape(d.dim, d.npp, -1).sum(dim=0)
                # packed: per-ROW sums keep the paired elements apart
                acc = acc + (u2 if self._npar > 1 else u2.sum(dim=0,
                                                              keepdim=True))
            tot += acc.double()
        vals = tot.reshape(-1)[self._mflat].reshape(self.E, -1).sum(dim=1)
        out = torch.zeros(self._E_mesh, dtype=torch.float64,
                          device=self.device)
        out[self._perm] = vals
        return self._sum_ranks(out).cpu().numpy()

    def _sum_ranks(self, x):
        """A per-element array this engine filled at its own elements ->
        the whole mesh's (one device: as it is)."""
        return x

    @torch.no_grad()
    def synth(self, theta: dict):
        """Forward-model all shots at ``theta`` -> numpy (S, n_steps, R,
        dim) (fields absent from theta come from p0)."""
        th = self._theta(theta)
        return np.stack([self._seis_one(th, self._shot(k)).cpu().numpy()
                         for k in range(self.n_shots)])

    # --- public: vg plug for solver.fwi.invert ------------------------
    def _vg_shots(self, theta, shots, obs, taps):
        """(misfit, {field: grad}) summed over the shots ``shots``."""
        th = self._theta(theta)
        tot_v, tot_g = 0.0, None
        for k in shots:
            src_k = self._shot(k)
            v, g = value_and_grad(
                lambda t: self._loss_one(t, src_k, obs[k], taps), th)
            tot_v += v
            tot_g = g if tot_g is None else {
                kk: tot_g[kk] + g[kk] for kk in g}
        return tot_v, tot_g

    def vg_factory(self, taps):
        """taps (or None) -> vg(theta) = (misfit float, {field: grad}) over
        all shots, one shot after the other; ``observed`` is low-passed
        here to match the synthetic filtering."""
        obs = self._obs(taps)
        return lambda theta: self._vg_shots(theta, range(self.n_shots),
                                            obs, taps)

    def vg_factory_sharded(self, comm=None):
        """Shot data parallelism: ``taps -> vg(theta)`` as ``vg_factory``'s,
        with rank r of ``comm`` (default: the process group's) running its
        contiguous n_shots/P shots and the misfit and gradient summed over
        the ranks (JAX's psum over the "shot" axis).  Every rank builds the
        same engine and gets the same sums; n_shots must be a multiple of
        the rank count."""
        from ..parallel.comm import current

        comm = comm if comm is not None else current(self.device)
        P = comm.world
        if self.n_shots % P:
            raise ValueError(f"n_shots {self.n_shots} not divisible by "
                             f"{P} ranks")
        if self.observed is None:
            raise ValueError("observed data not set")
        per = self.n_shots // P
        mine = range(comm.rank * per, (comm.rank + 1) * per)

        def factory(taps):
            obs = self._obs(taps)

            def vg(theta):
                v, g = self._vg_shots(theta, mine, obs, taps)
                v = comm.all_reduce_sum(torch.tensor(
                    v, dtype=torch.float64, device=self.device))
                return float(v), {k: comm.all_reduce_sum(x)
                                  for k, x in g.items()}

            return vg

        return factory

    def source_vg_factory(self, taps=None, with_theta: bool = False):
        """Per-shot source-wavelet gradients (FWI source estimation) of the
        Ricker parameters {"amp", "f0", "t0"} (each (S, K)).  The wavelet
        enters each step through the injection, outside the conjugated
        operators, so autograd differentiates it exactly; each shot's
        gradient is its own (stacked, not summed).

        Returns ``vg(wav, theta) -> (misfit, gwav)`` or, with
        ``with_theta``, ``(misfit, gwav, gtheta)``, gtheta the shot-summed
        material gradient of the same backward sweeps."""
        obs = self._obs(taps)
        wav_keys = ("amp", "f0", "t0")

        def vg(wav, theta):
            th = self._theta(theta)
            tot_v, gt = 0.0, None
            gw = {kk: [] for kk in wav_keys}
            for k in range(self.n_shots):
                wk = {kk: self._tensor(wav[kk])[k].detach().clone()
                      .requires_grad_(True)
                      for kk in wav_keys}
                tk = {kk: v.detach().requires_grad_(with_theta)
                      for kk, v in th.items()}
                loss = self._loss_one(tk, {**self._shot(k), **wk}, obs[k],
                                      taps)
                inputs = [wk[kk] for kk in wav_keys]
                if with_theta:
                    inputs += [tk[kk] for kk in tk]
                grads = torch.autograd.grad(loss, inputs, allow_unused=True)
                for kk, g in zip(wav_keys, grads):
                    gw[kk].append(g.detach().cpu().numpy())
                if with_theta:
                    g_t = {kk: (torch.zeros_like(tk[kk]) if g is None else g)
                           for kk, g in zip(tk, grads[len(wav_keys):])}
                    gt = g_t if gt is None else {
                        kk: gt[kk] + g_t[kk] for kk in gt}
                tot_v += float(loss.detach())
            gws = {kk: np.stack(v) for kk, v in gw.items()}
            return (tot_v, gws, gt) if with_theta else (tot_v, gws)

        return vg

    def moment_vg_factory(self, taps=None):
        """Per-shot moment-tensor (CMT) gradients of the Voigt moment m
        (S, n_sig) of moment-type shots (PointSource(kind="moment")).
        Their stress pattern factors as spatial template (x) M: the
        template rows are extracted once on the host (from the largest-norm
        Voigt component, so the recovered m is relative to it; absolute
        scale rides amp) and the pattern is rebuilt differentiably inside
        the loss.  Returns ``vg(m, theta) -> (misfit, gm (S, n_sig))``;
        ``vg.m_init`` is the factorization of the constructed shots."""
        obs = self._obs(taps)
        d = self.runner.d
        n_sig, npp = d.n_sig, d.npp
        vs = self.src["vs"].detach().cpu().numpy().astype(np.float64)
        vs = vs.reshape(self.n_shots, n_sig, npp, -1)
        T, m0 = [], []
        for s in range(self.n_shots):
            norms = np.linalg.norm(vs[s].reshape(n_sig, -1), axis=1)
            c = int(np.argmax(norms))
            if norms[c] == 0:
                raise ValueError(f"shot {s} has no stress pattern — "
                                 "moment inversion needs moment shots")
            Ts = vs[s, c]
            ms = np.einsum("cpk,pk->c", vs[s], Ts) / np.sum(Ts * Ts)
            if np.linalg.norm(vs[s] - ms[:, None, None] * Ts[None]) > \
                    1e-6 * norms[c]:
                raise ValueError(
                    f"shot {s} stress pattern does not factor as "
                    "template (x) Voigt — built from mixed sources?")
            T.append(Ts)
            m0.append(ms)
        T = self._tensor(np.stack(T))  # (S, npp, K)

        def vg(m, theta):
            th = self._theta(theta)
            tot_v, gm = 0.0, []
            for k in range(self.n_shots):
                mk = self._tensor(m[k]).detach().clone().requires_grad_(True)
                src_k = dict(self._shot(k))
                src_k["vs"] = torch.einsum("pk,c->cpk", T[k], mk).reshape(
                    n_sig * npp, -1)
                loss = self._loss_one(th, src_k, obs[k], taps)
                (g,) = torch.autograd.grad(loss, [mk])
                tot_v += float(loss.detach())
                gm.append(g.detach().cpu().numpy())
            return tot_v, np.stack(gm)

        vg.m_init = np.stack(m0)
        return vg

    @torch.no_grad()
    def loss_shot(self, theta, k: int, taps=None) -> float:
        """Single-shot misfit (no grad) — the test/diagnostic surface."""
        return float(self._loss_one(self._theta(theta), self._shot(k),
                                    self._obs(taps)[k], taps))
