"""Plain versions of the merged operators vs the JAX merged Pallas kernels.

``vel_merged_ref``/``stress_merged_ref`` (the CPU path of the port's K1/K2)
against ``seigen_tpu`` ``vel_merged``/``stress_merged`` in interpret mode, on
``box_mesh(3, 3, 3)`` P2 at f64 with the same numpy-seeded inputs.  The JAX
runner's lane block (27) divides NC = 27, so both packages use the same
lane layout and the fields AND the face-major trace arrays compare row for
row (rtol 1e-10, atol 1e-12: f64 roundoff of differently ordered sums).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seigen_tpu.mesh as jmesh
import seigen_tpu.ops as jops
import seigen_tpu_torch.mesh as tmesh
import seigen_tpu_torch.ops as tops
from seigen_tpu.ops.merged_kernels import stress_merged, vel_merged
from seigen_tpu.ops.structured_exchange import detect_structured as jdetect
from seigen_tpu.solver.damping import absorbing_bc_fn, sponge_mask
from seigen_tpu.solver.lane_merged import MergedLaneRunner as JaxRunner
from seigen_tpu_torch.ops.merged_kernels import (
    stress_merged_ref,
    vel_merged_ref,
)
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


RTOL, ATOL = 1e-10, 1e-12
DT, C3 = 0.013, 0.013**3 / 24.0


@pytest.fixture(scope="module")
def case():
    ext = ((0.0, 1.0),) * 3
    bc = absorbing_bc_fn(ext, free_sides=[(2, "hi")])
    dm_j = jmesh.build_discrete(jmesh.box_mesh(3, 3, 3), 2, bc_fn=bc)
    dm_t = tmesh.build_discrete(tmesh.box_mesh(3, 3, 3), 2, bc_fn=bc)
    damp = sponge_mask(dm_j, [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"),
                              (2, "lo")], width=0.3)
    p_j = jops.build_params(dm_j, jops.Material(1.0, 2.0, 1.0),
                            dtype=jnp.float64)
    p_t = tops.build_params(dm_t, tops.Material(1.0, 2.0, 1.0),
                            dtype=torch.float64, device="cpu")
    jr = JaxRunner(p_j, jdetect(dm_j), DT, block=27, interpret=True,
                   damp=jnp.asarray(damp))
    tr = MergedLaneRunner(p_t, tdetect(dm_t), DT, damp=damp)
    assert (jr.plan.NCs, jr.plan.NCt, jr.plan.h0) == (27, 27, 0)
    assert tr.plan.Ls == jr.plan.Ls and tr.plan.rtf == jr.plan.rtf

    d, plan = tr.d, tr.plan
    rng = np.random.default_rng(11)

    def field(C, used, rows, n=1):
        a = rng.standard_normal((n, C, rows, plan.Ls))
        a[:, :, used:] = 0.0  # dead node / pad trace rows are zero
        return a.reshape(n, C * rows, plan.Ls)

    data = {
        "sig": field(d.n_sig, d.n_p, d.npp, 3),
        "u": field(d.dim, d.n_p, d.npp, 3),
        "trs": field(d.nf, d.dim * d.n_fp, plan.rtf)[0],
        "Su": field(d.dim, d.n_p, d.npp, 2),
        "Ss": field(d.n_sig, d.n_p, d.npp, 2),
    }
    return jr, tr, data


def _variants():
    out = []
    for op in ("vel", "stress"):
        out += [(op, "plain"), (op, "axpy"), (op, "inject1"),
                (op, "inject2")]
    out.append(("stress", "axpy_damp"))
    return out


@pytest.mark.parametrize("op,variant", _variants())
def test_merged_op_matches_jax(case, op, variant):
    jr, tr, data = case
    x = data["sig" if op == "vel" else "u"]
    y = data["u" if op == "vel" else "sig"]  # output-shaped (axpy pair)
    S = data["Su" if op == "vel" else "Ss"]
    jd, td = jr.d, tr.d
    if op == "stress" and variant == "axpy":  # the undamped stress update
        jd, td = (dataclasses.replace(jd, damp=None),
                  dataclasses.replace(td, damp=None))
    rs = (0.7, -1.3)
    jkw, tkw = {}, {}
    if variant.startswith("axpy"):
        jkw = dict(axpy=(jnp.asarray(y[1]), jnp.asarray(y[2])), dt=DT, c3=C3)
        tkw = dict(axpy=(torch.as_tensor(y[1]), torch.as_tensor(y[2])),
                   dt=DT, c3=C3)
    elif variant.startswith("inject"):
        g = int(variant[-1])
        jkw = dict(inject=[(jnp.asarray(S[i]),
                            jnp.full((8, tr.plan.Ls), rs[i], jnp.float64))
                           for i in range(g)])
        tkw = dict(inject=[(torch.as_tensor(S[i]), rs[i]) for i in range(g)])
    jf, tf = ((vel_merged, vel_merged_ref) if op == "vel"
              else (stress_merged, stress_merged_ref))
    j_out, j_tr = jf(jr.plan, jd, jnp.asarray(x[0]),
                     jnp.asarray(data["trs"]), jr.mask, interpret=True,
                     **jkw)
    t_out, t_tr = tf(tr.plan, td, torch.as_tensor(x[0]),
                     torch.as_tensor(data["trs"]), tr.mask, **tkw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t_tr.numpy(), np.asarray(j_tr), rtol=RTOL,
                               atol=ATOL)


def test_runner_layout_matches_jax(case):
    """Placed geo/damp/mask and the seeded traction traces, row for row."""
    jr, tr, data = case
    np.testing.assert_allclose(tr.d.geo.numpy(), np.asarray(jr.d.geo),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_array_equal(tr.d.damp.numpy(), np.asarray(jr.d.damp))
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    s = data["sig"][0]
    np.testing.assert_allclose(
        tr.traction_traces(torch.as_tensor(s)).numpy(),
        np.asarray(jr.traction_traces(jnp.asarray(s))), rtol=RTOL, atol=ATOL)


def test_kernel_wrappers_refuse_cpu_tensors(case):
    """The CUDA wrappers take CUDA tensors only; on the CPU the dispatch
    goes to the plain version and never reaches the kernel."""
    from seigen_tpu_torch.ops.merged_kernels import VEL_KERNEL, vel_merged

    _, tr, data = case
    s, trs = torch.as_tensor(data["sig"][0]), torch.as_tensor(data["trs"])
    n0 = VEL_KERNEL.launches
    out, _ = vel_merged(tr.plan, tr.d, s, trs, tr.mask)
    ref, _ = vel_merged_ref(tr.plan, tr.d, s, trs, tr.mask)
    assert torch.equal(out, ref) and VEL_KERNEL.launches == n0
    for x in (s, s.float()):
        with pytest.raises(ValueError, match="CUDA tensors"):
            VEL_KERNEL(tr.plan, tr.d, x, trs, tr.mask)
    assert VEL_KERNEL.launches == n0


@pytest.mark.parametrize("dim,degree", [(3, 3), (3, 2), (2, 1)])
def test_tile_table_holds_dr_and_lift(dim, degree):
    """KernelTables.tile, the K1/K2 tile kernels' product table: row
    j*dim + r holds Dr_r[:, j], row dim*n_p + q holds LIFT[:, q], the node
    index padded to a multiple of 4 with zeros."""
    from seigen_tpu_torch.ops.fused_kernels import tile_table
    from seigen_tpu_torch.refelem import ref_elem

    re = ref_elem(dim, degree)
    Dr, LIFT = np.asarray(re.Dr), np.asarray(re.LIFT)
    n_p = Dr.shape[1]
    tab = tile_table(Dr, LIFT)
    assert tab.shape == (dim * n_p + LIFT.shape[1], -(-n_p // 4) * 4)
    for r in range(dim):
        for j in range(n_p):
            np.testing.assert_array_equal(tab[j * dim + r, :n_p], Dr[r, :, j])
    np.testing.assert_array_equal(tab[dim * n_p :, :n_p], LIFT.T)
    assert not tab[:, n_p:].any()
