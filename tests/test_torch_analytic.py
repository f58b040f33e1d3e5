"""The port's Green's functions (solver/analytic.py), kinematic_rupture
(solver/source.py) and receivers.grid vs the JAX package.

1. ExplosionGreens3D (point and mollified), ForceGreens3D and
   MomentGreens3D: velocity (and the explosion's pressure) equal JAX's at
   the receivers of tests/test_greens.py over a time window (rtol 1e-12).
2. A receiver on the source point raises, as in tests/test_greens.py.
3. kinematic_rupture and grid equal JAX's outputs exactly.
"""

import dataclasses

import numpy as np
import pytest

import seigen_tpu.ops as jops
import seigen_tpu.solver as jsol
import seigen_tpu_torch.ops as tops
import seigen_tpu_torch.solver as tsol
import torch


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


SRC = (0.515, 0.505, 0.525)  # tests/test_greens.py
REC = np.array([
    [0.745, 0.615, 0.575],
    [0.305, 0.365, 0.665],
    [0.635, 0.655, 0.285],
])
T = np.linspace(0.0, 1.2, 97)
MOMENT = np.array([[1.0, 0.3, -0.2], [0.3, -0.5, 0.4], [-0.2, 0.4, 0.7]])
GREENS = {  # class name -> keyword arguments besides mat, position
    "ExplosionGreens3D": dict(f0=2.0, t0=0.6, amplitude=3.0),
    "ExplosionGreens3D-mollified": dict(f0=2.0, t0=0.6, amplitude=3.0,
                                        radius=1.0 / 12, quad_n=7),
    "ForceGreens3D": dict(direction=np.array([0.3, -0.4, 0.8]), f0=2.0,
                          t0=0.6, amplitude=2.0, radius=0.05, quad_n=5),
    "MomentGreens3D": dict(moment=MOMENT, f0=2.0, t0=0.6, amplitude=1.5,
                           radius=0.05, quad_n=5),
}


def _pair(label, position=SRC):
    """(port, JAX) instances of one Green's function."""
    name = label.split("-")[0]
    kw = GREENS[label]
    return tuple(getattr(sol, name)(mat=ops.Material(1.5, 2.0, 1.0),
                                    position=np.array(position), **kw)
                 for sol, ops in ((tsol, tops), (jsol, jops)))


@pytest.mark.parametrize("label", list(GREENS))
def test_greens_match_jax(label):
    g_t, g_j = _pair(label)
    v = g_t.velocity(REC, T)
    assert v.shape == (len(T), len(REC), 3) and np.abs(v).max() > 0
    np.testing.assert_allclose(v, g_j.velocity(REC, T), rtol=1e-12,
                               atol=1e-14 * np.abs(v).max())
    if label.startswith("ExplosionGreens3D"):
        pr = g_t.pressure(REC, T)
        assert pr.shape == (len(T), len(REC), 1)
        np.testing.assert_allclose(pr, g_j.pressure(REC, T), rtol=1e-12,
                                   atol=1e-14 * np.abs(pr).max())


@pytest.mark.parametrize("label", list(GREENS))
def test_greens_reject_receiver_on_source(label):
    g_t, _ = _pair(label, position=np.zeros(3))
    g_t = dataclasses.replace(g_t, radius=None)
    with pytest.raises(ValueError):
        g_t.velocity(np.zeros((1, 3)), np.array([0.0]))


@pytest.mark.parametrize("hypocenter", [None, (0.5, 0.5, 0.6)])
def test_kinematic_rupture_matches_jax(hypocenter):
    kw = dict(a=(0.3, 0.5, 0.6), b=(0.7, 0.5, 0.6), n_sub=5,
              moment=(0.0, 0.0, 0.0, 0.0, 1.0, 0.0), f0=3.0,
              rupture_velocity=0.8, hypocenter=hypocenter, radius=0.05,
              amplitude=2.0)
    got = tsol.kinematic_rupture(**kw)
    ref = jsol.kinematic_rupture(**kw)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in ref]
    assert all(isinstance(s, tsol.PointSource) for s in got)
    with pytest.raises(ValueError):
        tsol.kinematic_rupture(**{**kw, "rupture_velocity": 0.0})


def test_grid_matches_jax():
    args = ((0.1, 0.9), (0.2, 0.8), 4, 3, 0.95)
    got = tsol.grid(*args)
    assert got.shape == (12, 3)
    np.testing.assert_array_equal(got, jsol.grid(*args))
