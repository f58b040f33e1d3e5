"""The port's utils/ on the CPU against the JAX package's.

1. Checkpoints interchange: a checkpoint written by JAX's
   ``save_checkpoint`` loads in the port's ``load_checkpoint`` and one
   written by the port loads in JAX's — u, s, step, meta and the ``xi``
   extra equal.
2. ``write_vtu``/``PVDWriter`` write the same text as JAX's for the same
   mesh and fields (rect_mesh(3, 3) P2, box_mesh(2, 2, 2) P1).
3. ``RegionTimer`` counts and sums (tests/test_utils.py); ``device_trace``
   writes a Chrome trace; ``write_run_report`` writes its JSON.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seigen_tpu.mesh as jmesh
import seigen_tpu.solver as jsol
import seigen_tpu.utils as jutils
import seigen_tpu_torch.mesh as tmesh
import seigen_tpu_torch.utils as tutils
from seigen_tpu_torch.solver import State


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several pytest workers' intra-op thread pools fight over the
    cores; these tiny tensors gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(10, 6, 2)), rng.normal(size=(10, 6, 3)),
            rng.normal(size=(10, 6, 3, 3)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_interchange(tmp_path, writer):
    u, s, xi = _arrays(0 if writer == "jax" else 1)
    path = str(tmp_path / "ck")  # no extension: both normalise to .npz
    meta = {"dt": 0.1, "T": 1.0}
    if writer == "jax":
        jutils.save_checkpoint(path, jsol.State(u=jnp.asarray(u),
                                                s=jnp.asarray(s)), 42, meta,
                               extras={"xi": jnp.asarray(xi)})
        st, step, got = tutils.load_checkpoint(path, device="cpu")
        xi2 = got.pop("_extras")["xi"].numpy()
        u2, s2 = st.u.numpy(), st.s.numpy()
    else:
        tutils.save_checkpoint(path, State(u=torch.as_tensor(u),
                                           s=torch.as_tensor(s)), 42, meta,
                               extras={"xi": torch.as_tensor(xi)})
        st, step, got = jutils.load_checkpoint(path)
        xi2 = np.asarray(got.pop("_extras")["xi"])
        u2, s2 = np.asarray(st.u), np.asarray(st.s)
    assert step == 42 and got == meta
    for a, b in ((u, u2), (s, s2), (xi, xi2)):
        assert np.array_equal(a, b)
    # the port casts on load when asked, and puts the state on the device
    st32, _, meta32 = tutils.load_checkpoint(path + ".npz",
                                             dtype=torch.float32,
                                             device="cpu")
    assert st32.u.dtype == torch.float32
    assert meta32["_extras"]["xi"].dtype == torch.float32


@pytest.mark.parametrize("dim", [2, 3])
def test_vtu_and_pvd_text_equal_jax(tmp_path, dim):
    if dim == 2:
        topo_j, topo_t, degree = jmesh.rect_mesh(3, 3), tmesh.rect_mesh(3, 3), 2
    else:
        topo_j, topo_t, degree = (jmesh.box_mesh(2, 2, 2),
                                  tmesh.box_mesh(2, 2, 2), 1)
    dm_j = jmesh.build_discrete(topo_j, degree)
    dm_t = tmesh.build_discrete(topo_t, degree)
    rng = np.random.default_rng(dim)
    fields = {"u": rng.normal(size=(dm_t.num_elements, dm_t.re.n_p, dim)),
              "p": rng.normal(size=(dm_t.num_elements, dm_t.re.n_p))}
    texts = {}
    for name, utils, dm in (("jax", jutils, dm_j), ("port", tutils, dm_t)):
        d = tmp_path / name
        d.mkdir()
        utils.write_vtu(str(d / "snap.vtu"), dm, fields)
        pvd = utils.PVDWriter(str(d / "series.pvd"), dm)
        pvd.write(0.0, fields)
        pvd.write(0.5, {k: 2 * v for k, v in fields.items()})
        texts[name] = [open(d / f).read() for f in (
            "snap.vtu", "series.pvd", "series_00000.vtu",
            "series_00001.vtu")]
    assert texts["port"] == texts["jax"]
    assert 'Name="u" NumberOfComponents="3"' in texts["port"][0]
    assert 'timestep="0.5"' in texts["port"][1]


def test_region_timer_trace_and_report(tmp_path):
    t = tutils.RegionTimer()
    for _ in range(2):
        with t.region("a", sync=torch.zeros(1)):
            pass
    with t.region("b"):
        pass
    rep = t.report()
    assert rep["a"]["calls"] == 2 and rep["b"]["calls"] == 1
    assert rep["a"]["seconds"] == t.totals["a"] >= 0.0

    logdir = tmp_path / "trace"
    with tutils.device_trace(str(logdir)):
        torch.ones(8).sum()
    (trace,) = os.listdir(logdir)
    assert json.load(open(logdir / trace))["traceEvents"]

    path = tmp_path / "r" / "report.json"
    tutils.write_run_report(str(path), {"n": 4}, rep, {"E": 64})
    assert json.load(open(path)) == {"config": {"n": 4}, "timings": rep,
                                     "E": 64}
