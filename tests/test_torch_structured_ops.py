"""The port's element-major operator wrappers on the CPU, f64.

1. ``gather_traces_structured`` (the roll exchange) against the general
   gather through ``p.nbr``, exactly, on the five meshes of
   tests/test_structured_exchange.py.
2. ``vel_op_pallas``/``stress_op_pallas`` (the plain versions of K4 SIG /
   K5 TR behind the layout moves) against the JAX package's interpret-mode
   Pallas wrappers, 2D and 3D P2, rtol 1e-10.
3. The operator data is contiguous, as the kernels take it.
4. ``make_pallas_ops`` (with and without the roll exchange) and
   ``make_structured_ops`` as ``timestep.run`` hooks against the einsum
   run, 5 LF4 steps with a source and a sponge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seigen_tpu.mesh as jmesh
import seigen_tpu.ops as jops
from seigen_tpu.ops.pallas_kernels import stress_op_pallas as j_stress
from seigen_tpu.ops.pallas_kernels import vel_op_pallas as j_vel
from seigen_tpu_torch.mesh import box_mesh, build_discrete, rect_mesh
from seigen_tpu_torch.ops import Material, build_params, n_sig_for
from seigen_tpu_torch.ops.lane_kernels import make_pallas_ops, \
    stress_op_pallas, vel_op_pallas
from seigen_tpu_torch.ops.structured_exchange import detect_structured, \
    gather_traces_structured, make_structured_ops
from seigen_tpu_torch.solver import PointSource, State, absorbing_bc_fn, \
    build_sources, run, sponge_mask


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several pytest workers' intra-op thread pools fight over the
    cores; these tiny operators gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAT = dict(rho=1.2, vp=2.0, vs=1.1)

CASES = {  # tests/test_structured_exchange.py
    "box peri": (lambda: box_mesh(4, 4, 4, periodic=(0, 1, 2)), 2),
    "box bounded": (lambda: box_mesh(3, 4, 5), 2),
    "box mixed": (lambda: box_mesh(4, 4, 2, periodic=(0,)), 1),
    "rect peri": (lambda: rect_mesh(6, 4, periodic=(0, 1)), 3),
    "rect bounded": (lambda: rect_mesh(4, 6), 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_structured_gather_equals_general_gather(name):
    mk, degree = CASES[name]
    dm = build_discrete(mk(), degree)
    ex = detect_structured(dm)
    assert ex is not None, f"{name}: structure not detected"
    p = build_params(dm, Material(**MAT), dtype=torch.float64, device="cpu")
    field = torch.as_tensor(np.random.default_rng(0).normal(
        size=(dm.num_elements, dm.re.n_p, 3)))
    ref = field.reshape(-1, 3)[p.nbr].reshape(dm.num_elements, -1, 3)
    assert torch.equal(gather_traces_structured(ex, field), ref), name


def _pair(dim, degree):
    """(JAX params, port params, port mesh) of the same mesh in f64."""
    if dim == 2:
        jt, tt = jmesh.rect_mesh(5, 4), rect_mesh(5, 4)
    else:
        jt, tt = (jmesh.box_mesh(2, 2, 2, periodic=(0, 1)),
                  box_mesh(2, 2, 2, periodic=(0, 1)))
    jp = jops.build_params(jmesh.build_discrete(jt, degree),
                           jops.Material(**MAT), dtype=jnp.float64)
    dm = build_discrete(tt, degree)
    return jp, build_params(dm, Material(**MAT), dtype=torch.float64,
                            device="cpu"), dm


@pytest.mark.parametrize("op", ["vel", "stress"])
@pytest.mark.parametrize("dim", [2, 3])
def test_pallas_wrappers_match_jax(dim, op):
    jp, tp, dm = _pair(dim, 2)
    C = n_sig_for(dim) if op == "vel" else dim
    x = np.random.default_rng(dim).normal(size=(dm.num_elements, dm.re.n_p,
                                                C))
    jfn, tfn = (j_vel, vel_op_pallas) if op == "vel" else (j_stress,
                                                           stress_op_pallas)
    ref = np.asarray(jfn(jp, jnp.asarray(x), block=8, interpret=True))
    out = tfn(tp, torch.as_tensor(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


def test_lane_data_is_contiguous():
    """make_pallas_ops hands build_lane_data's rows to K4/K5 as they are
    (no lane permutation copies them), and the kernels take no strides."""
    from seigen_tpu_torch.ops.lane_kernels import LANE_FIELDS, \
        build_lane_data

    _, p, _ = _pair(3, 2)
    d = build_lane_data(p)
    assert all(getattr(d, f).is_contiguous() for f in LANE_FIELDS)


@pytest.fixture(scope="module")
def lf4_case():
    """A bounded 3D P2 case with a free top, a sponge, a source and a
    random state; the einsum run of 5 LF4 steps is the reference."""
    dm = build_discrete(box_mesh(2, 2, 2), 2, bc_fn=absorbing_bc_fn(
        ((0.0, 1.0),) * 3, [(2, "hi")]))
    kw = dict(dtype=torch.float64, device="cpu")
    p = build_params(dm, Material(**MAT), **kw)
    src = build_sources(dm, [PointSource(position=(0.5, 0.5, 0.6), f0=4.0,
                                         radius=0.3)], **kw)
    damp = torch.as_tensor(sponge_mask(dm, [(0, "lo"), (1, "hi")], 0.3))
    rng = np.random.default_rng(5)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=torch.as_tensor(rng.normal(size=(E, n_p, 3))),
               s=torch.as_tensor(rng.normal(size=(E, n_p, 6))))
    kw = dict(src=src, damp=damp)
    ref, _ = run(p, st, 0.01, 5, **kw)
    return dm, p, st, kw, ref


@pytest.mark.parametrize("ops", ["pallas", "pallas_roll", "xla_roll"])
def test_wrappers_as_run_hooks(lf4_case, ops):
    dm, p, st, kw, ref = lf4_case
    ex = detect_structured(dm)
    vel, stress = {"pallas": lambda: make_pallas_ops(p),
                   "pallas_roll": lambda: make_pallas_ops(p, exchange=ex),
                   "xla_roll": lambda: make_structured_ops(ex)}[ops]()
    out, _ = run(p, st, 0.01, 5, vel_op=vel, stress_op=stress, **kw)
    for got, want in ((out.u, ref.u), (out.s, ref.s)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10 * want.abs().max().item())
