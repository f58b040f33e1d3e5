"""High-level simulation facade — the user's normal entry point.

Port of ``seigen_tpu/solver/simulation.py``: a frozen config plus a facade
object wiring mesh, material, sources, receivers, boundaries, damping and
the time loop together.  All state is explicit; nothing global.

    sim = ElasticSimulation(rect_mesh(32, 32), Material(1.0, 2.0, 1.0),
                            SimConfig(degree=2), sources=[...],
                            receiver_points=line((0.2, 0.9), (0.8, 0.9), 8))
    final_state, seismograms = sim.run(T)

The simulation lives on ``device`` (default the card; tests pass "cpu").
Operator backends (``SimConfig.impl``):

  auto      on a CUDA device the lane runners with their CUDA kernels
            ("lane" when the mesh is structured, else "lane_u"); on the CPU
            the einsum operators
  einsum    the plain batched operators of ops/elastic.py
  lane      solver/lane_major.py:LaneMajorRunner (structured meshes)
  lane_u    solver/lane_unstructured.py:UnstructuredLaneRunner

``scheme="upwind-rk4"`` (with optional Q) runs the einsum Godunov RK4 of
solver/rk4.py.  ``stiffness=`` (anisotropy) runs the einsum path with
ops/anisotropic.py:make_aniso_stress_op; the lane runners take a stiffness
directly (``LaneMajorRunner(stiffness=)``).  The element-major wrappers of
the JAX package (``xla_roll``, ``pallas``, ``pallas_roll``) are not ported;
checkpoint and VTK hooks neither.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh import MeshTopology, build_discrete
from ..ops import Material, apply_stress_op, apply_vel_op, build_params, \
    n_sig_for
from ..ops.fused_kernels import stiffness_array
from .damping import absorbing_bc_fn, sponge_mask
from .receivers import build_receivers, sample
from .source import PointSource, build_sources
from .timestep import State, cfl_dt, make_step, run, staggered_init

# JAX-package impls whose element-major operator wrappers have no port yet
UNPORTED_IMPLS = {
    "xla_roll": "structured_exchange.make_structured_ops (ROADMAP.md "
                "Queue 1 item 11)",
    "pallas": "pallas_kernels.make_pallas_ops (ROADMAP.md Queue 1 item 11)",
    "pallas_roll": "pallas_kernels.make_pallas_ops with the structured "
                   "exchange (ROADMAP.md Queue 1 item 11)",
}


@dataclass(frozen=True)
class SimConfig:
    """Frozen run configuration: one dataclass per run."""

    degree: int = 2
    order: int = 4  # LF2 | LF4
    cfl: float = 0.4
    dtype: str = "float32"
    impl: str = "auto"  # auto|einsum|lane|lane_u
    free_sides: tuple = ()  # ((axis, "lo"|"hi"), ...)
    absorbing_sides: tuple = ()  # rest default to free surface
    sponge_width: float = 0.0
    sponge_alpha: float = 2.0
    scheme: str = "lf"  # lf (central flux + leapfrog) | upwind-rk4
    # viscoelastic attenuation (upwind-rk4 scheme only); None = elastic
    q_kappa: float | None = None
    q_mu: float | None = None
    q_band: tuple | None = None  # (f_min, f_max); required with q_*


class ElasticSimulation:
    """Facade: build once, then step/run/sample."""

    def __init__(
        self,
        topology: MeshTopology,
        material: Material,
        config: SimConfig = SimConfig(),
        sources: list[PointSource] | None = None,
        receiver_points: np.ndarray | None = None,
        stiffness: np.ndarray | None = None,
        device: torch.device | str = "cuda",
    ):
        """``stiffness``: optional per-element Voigt stiffness
        (n_sig, n_sig) or (E, n_sig, n_sig) for anisotropic media
        (ops/anisotropic.py); forces the einsum operator path
        (central-flux LF schemes only)."""
        if topology.structure is None and not topology.periodic:
            from ..mesh.recover import recover_structure

            topology = recover_structure(topology)
        self.config = config
        self.topology = topology
        self.material = material
        self.device = torch.device(device)
        dtype = getattr(torch, config.dtype)
        dev = dict(dtype=dtype, device=self.device)

        bc_fn = None
        if config.absorbing_sides:
            bc_fn = absorbing_bc_fn(
                topology.extents, free_sides=list(config.free_sides)
            )
        self.dm = build_discrete(topology, config.degree, bc_fn=bc_fn)
        self.params = build_params(self.dm, material, **dev)
        self.sources = build_sources(self.dm, sources or [], mat=material,
                                     **dev)
        self.receivers = (
            build_receivers(self.dm, receiver_points, **dev)
            if receiver_points is not None
            else None
        )
        self.damp = None
        if config.sponge_width > 0 and config.absorbing_sides:
            self.damp = torch.as_tensor(
                sponge_mask(
                    self.dm,
                    list(config.absorbing_sides),
                    config.sponge_width,
                    config.sponge_alpha,
                ),
                device=self.device).to(dtype)
        self._stiffness = None
        vp_max = float(np.asarray(material.vp).max())
        if stiffness is not None:
            if config.scheme != "lf":
                raise ValueError("anisotropy supports scheme='lf' only")
            n_sig = n_sig_for(self.dm.dim)
            E = self.dm.num_elements
            self._stiffness = torch.as_tensor(
                stiffness_array(stiffness, E, n_sig).copy(),
                device=self.device).to(dtype)
            # CFL bound: phase speeds are bounded by sqrt(||C||_2/rho)
            # <= sqrt(||C||_F/rho); cheap per-element Frobenius bound (of
            # the stiffness as the run dtype holds it)
            Cf = self._stiffness.double().cpu().numpy()
            fro = np.sqrt((Cf * Cf).sum(axis=(1, 2))).max()
            rho_min = float(np.asarray(material.rho).min())
            vp_max = max(vp_max, float(np.sqrt(fro / rho_min)))
        self.dt = cfl_dt(
            float(self.dm.h.min()), vp_max, config.degree, config.cfl
        )
        self._dtype = dtype
        self._wdata = self._visco = None
        if config.scheme == "upwind-rk4":
            from ..ops.upwind import build_upwind_data

            self._wdata = build_upwind_data(self.dm, material, **dev)
            if config.q_kappa or config.q_mu:
                if not config.q_band:
                    raise ValueError("q_band=(f_min, f_max) is required "
                                     "with q_kappa/q_mu")
                from ..ops.viscoelastic import build_visco

                self._visco = build_visco(
                    self.params, config.q_kappa or np.inf,
                    config.q_mu or np.inf, *config.q_band)
        elif config.q_kappa or config.q_mu:
            raise ValueError("attenuation requires scheme='upwind-rk4'")
        elif config.scheme != "lf":
            raise ValueError(f"unknown scheme {config.scheme!r}")

        self._ex = None
        self._lane_runner = None
        self._vel_op, self._stress_op = self._select_ops(config.impl)

    def _select_ops(self, impl: str):
        """Pick the operator backend (see the module docstring); returns
        the (vel_op, stress_op) pair of ``step_fn`` — in the lane modes the
        einsum operators, which compute what the lane operators do."""
        from ..ops.structured_exchange import detect_structured

        if impl in UNPORTED_IMPLS:
            raise NotImplementedError(
                f"impl {impl!r} is not ported yet: " + UNPORTED_IMPLS[impl])
        if self._stiffness is not None:
            if impl not in ("auto", "einsum"):
                raise ValueError("anisotropic stiffness runs the einsum "
                                 f"path; impl {impl!r} unsupported")
            from ..ops.anisotropic import make_aniso_stress_op

            self._impl = "einsum"
            return apply_vel_op, make_aniso_stress_op(self._stiffness)
        ex = None
        if impl in ("auto", "lane"):
            ex = detect_structured(self.dm)
        if impl == "auto":
            impl = (
                ("lane" if ex is not None else "lane_u")
                if self.device.type == "cuda"
                else "einsum"
            )
        self._impl = impl
        if impl == "lane":
            if ex is None:
                raise ValueError("lane impl requires a structured mesh")
            self._ex = ex
        elif impl not in ("lane_u", "einsum"):
            raise ValueError(f"unknown impl {impl!r}")
        return apply_vel_op, apply_stress_op

    def zero_state(self) -> State:
        E, n_p = self.dm.num_elements, self.dm.re.n_p
        dim = self.dm.dim
        kw = dict(dtype=self._dtype, device=self.device)
        return State(
            u=torch.zeros((E, n_p, dim), **kw),
            s=torch.zeros((E, n_p, n_sig_for(dim)), **kw),
        )

    def state_from(self, u_fn, s_fn, t: float = 0.0) -> State:
        """Staggered-consistent state from co-located analytic/callable ICs."""
        from .errors import interpolate

        def dev(a):
            return torch.as_tensor(a, device=self.device).to(self._dtype)

        u0 = dev(interpolate(self.dm, u_fn, t))
        s0 = dev(interpolate(self.dm, s_fn, t))
        return staggered_init(
            self.params, u0, s0, self.dt, order=self.config.order,
            vel_op=self._vel_op, stress_op=self._stress_op
        )

    def _runner(self):
        """The lane runner of the "lane"/"lane_u" impls, built on first
        use."""
        if self._lane_runner is None:
            kw = dict(order=self.config.order, src=self.sources,
                      damp=self.damp, receivers=self.receivers)
            if self._impl == "lane":
                from .lane_major import LaneMajorRunner

                self._lane_runner = LaneMajorRunner(
                    self.params, self._ex, self.dt, **kw)
            else:
                from .lane_unstructured import UnstructuredLaneRunner

                self._lane_runner = UnstructuredLaneRunner(
                    self.params, self.dt,
                    centroids=np.asarray(self.dm.coords.mean(axis=1)), **kw)
        return self._lane_runner

    def run(self, T: float, state: State | None = None):
        """Run to time T; returns (final State, seismograms (n_steps, R,
        dim) numpy array or None)."""
        n_steps = max(int(np.ceil(T / self.dt)), 1)
        state = state if state is not None else self.zero_state()
        kw = dict(src=self.sources, damp=self.damp, receivers=self.receivers)
        if self._wdata is not None:
            from .rk4 import run_rk4, run_rk4_visco

            if self._visco is not None:
                fin, _, seis = run_rk4_visco(
                    self.params, self._wdata, self._visco, state, self.dt,
                    n_steps, **kw)
            else:
                fin, seis = run_rk4(self.params, self._wdata, state, self.dt,
                                    n_steps, **kw)
        elif self._impl in ("lane", "lane_u"):
            return self._runner().run(state, n_steps)
        else:
            fin, seis = run(self.params, state, self.dt, n_steps,
                            order=self.config.order, vel_op=self._vel_op,
                            stress_op=self._stress_op, **kw)
        return fin, (None if seis is None else seis.cpu().numpy())

    def step_fn(self):
        """The raw (State, t) -> State single-step function (LF scheme)."""
        return make_step(
            self.params,
            self.dt,
            order=self.config.order,
            src=self.sources,
            damp=self.damp,
            vel_op=self._vel_op,
            stress_op=self._stress_op,
        )

    def sample(self, state: State) -> np.ndarray | None:
        if self.receivers is None:
            return None
        return sample(self.receivers, state.u).cpu().numpy()
