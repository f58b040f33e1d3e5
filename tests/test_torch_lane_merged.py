"""The port's MergedLaneRunner (CPU, plain operator versions) end to end.

1. Against the JAX ``MergedLaneRunner(interpret=True, block=9)`` at f64 on
   ``box_mesh(3, 3, 3)`` P2 with a blob source (kernel-fused dense
   injection), a sponge and 3 receivers, for 3 steps from a numpy-seeded
   random state: states and seismograms agree at rtol 1e-10.
2. Against the port's own general-layout einsum ``timestep.run`` (the
   general-path oracle), also with the >2-wavelet-group scatter fallback.
3. ``impl="kernel"`` refuses CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seigen_tpu.mesh as jmesh
import seigen_tpu.ops as jops
import seigen_tpu.solver as jsol
import seigen_tpu_torch.mesh as tmesh
import seigen_tpu_torch.ops as tops
import seigen_tpu_torch.solver as tsol
from seigen_tpu.ops.structured_exchange import detect_structured as jdetect
from seigen_tpu.solver.lane_merged import MergedLaneRunner as JaxRunner
from seigen_tpu_torch.ops.structured_exchange import \
    detect_structured as tdetect
from seigen_tpu_torch.solver.lane_merged import MergedLaneRunner


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tiny CPU operators gain nothing from intra-op threads, and
    several pytest workers' thread pools fight over the cores (a 60-step
    einsum run: 0.15 s on one thread, 106 s with six processes on eight
    cores at the default)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EXT = ((0.0, 1.0),) * 3
SIDES = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
N_STEPS = 3


def _state(E, n_p, dim, n_sig):
    rng = np.random.default_rng(7)
    return (rng.standard_normal((E, n_p, dim)),
            rng.standard_normal((E, n_p, n_sig)))


@pytest.fixture(scope="module")
def torch_case():
    dm = tmesh.build_discrete(
        tmesh.box_mesh(3, 3, 3), 2,
        bc_fn=tsol.absorbing_bc_fn(EXT, free_sides=[(2, "hi")]))
    p = tops.build_params(dm, tops.Material(1.0, 2.0, 1.0),
                          dtype=torch.float64, device="cpu")
    damp = tsol.sponge_mask(dm, SIDES, width=0.3)
    rcv = tsol.build_receivers(
        dm, tsol.line((0.2, 0.5, 0.9), (0.8, 0.5, 0.9), 3),
        dtype=torch.float64, device="cpu")
    dt = tsol.cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    u0, s0 = _state(dm.num_elements, p.n_p, 3, 6)
    st = tsol.State(u=torch.as_tensor(u0), s=torch.as_tensor(s0))
    return dm, p, damp, rcv, dt, st


def test_runner_matches_jax_merged_runner(torch_case):
    dm_t, p_t, damp, rcv_t, dt, st_t = torch_case
    dm_j = jmesh.build_discrete(
        jmesh.box_mesh(3, 3, 3), 2,
        bc_fn=jsol.absorbing_bc_fn(EXT, free_sides=[(2, "hi")]))
    p_j = jops.build_params(dm_j, jops.Material(1.0, 2.0, 1.0),
                            dtype=jnp.float64)
    src_j = jsol.build_sources(
        dm_j, [jsol.PointSource(position=(0.5, 0.5, 0.7), f0=4.0,
                                radius=0.25)], dtype=jnp.float64)
    rcv_j = jsol.build_receivers(
        dm_j, jsol.line((0.2, 0.5, 0.9), (0.8, 0.5, 0.9), 3),
        dtype=jnp.float64)
    jr = JaxRunner(p_j, jdetect(dm_j), dt, src=src_j,
                   damp=jnp.asarray(damp), receivers=rcv_j, block=9,
                   interpret=True)
    src_t = tsol.build_sources(
        dm_t, [tsol.PointSource(position=(0.5, 0.5, 0.7), f0=4.0,
                                radius=0.25)], dtype=torch.float64,
        device="cpu")
    tr = MergedLaneRunner(p_t, tdetect(dm_t), dt, src=src_t, damp=damp,
                          receivers=rcv_t)
    assert tr.impl == "reference"
    assert tr.src_dense is not None and len(tr.src_dense) == 1
    assert (jr.plan.NCs, jr.plan.NCt, jr.plan.h0) == (27, 27, 0)

    st_j = jsol.State(u=jnp.asarray(st_t.u.numpy()),
                      s=jnp.asarray(st_t.s.numpy()))
    out_j, seis_j = jr.run(st_j, N_STEPS)
    out_t, seis_t = tr.run(st_t, N_STEPS)
    np.testing.assert_allclose(out_t.u.numpy(), np.asarray(out_j.u),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(out_t.s.numpy(), np.asarray(out_j.s),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(seis_t, np.asarray(seis_j), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("n_groups", [1, 3], ids=["dense", "scatter"])
def test_runner_matches_einsum_run(torch_case, n_groups):
    """Lane-major runner vs the general-layout einsum stepper (port-only).
    Three wavelet groups take the scatter (inject_columns) fallback."""
    dm, p, damp, rcv, dt, st = torch_case
    pos = [(0.5, 0.5, 0.7), (0.3, 0.6, 0.5), (0.6, 0.4, 0.3)]
    src = tsol.build_sources(
        dm, [tsol.PointSource(position=pos[g], f0=4.0 + g, radius=0.25)
             for g in range(n_groups)], dtype=torch.float64, device="cpu")
    tr = MergedLaneRunner(p, tdetect(dm), dt, src=src, damp=damp,
                          receivers=rcv)
    assert (tr.src_dense is None) == (n_groups > 2)
    out, seis = tr.run(st, N_STEPS)
    ref, seis_ref = tsol.run(p, st, dt, N_STEPS, src=src,
                             damp=torch.as_tensor(damp), receivers=rcv)
    # same physics, sums in another order
    np.testing.assert_allclose(out.u.numpy(), ref.u.numpy(), rtol=1e-10,
                               atol=1e-9)
    np.testing.assert_allclose(out.s.numpy(), ref.s.numpy(), rtol=1e-10,
                               atol=1e-9)
    np.testing.assert_allclose(seis, seis_ref.numpy(), rtol=1e-10,
                               atol=1e-11)


def test_kernel_impl_refuses_cpu(torch_case):
    dm, p, damp, _, dt, _ = torch_case
    with pytest.raises(ValueError, match="CUDA"):
        MergedLaneRunner(p, tdetect(dm), dt, damp=damp, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        MergedLaneRunner(p, tdetect(dm), dt, impl="auto")
