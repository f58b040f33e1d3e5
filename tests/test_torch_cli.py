"""The port's command-line programs on the CPU, called in-process through
``main(argv)``.

1. Parity: ``cli.explosive_source`` (``--impl einsum --f64 --cpu``, LF4 and
   ``--scheme upwind-rk4``) writes the seismograms of the JAX package's
   ``scripts/explosive_source.py`` run in-process with the same flags
   (rtol 1e-9).
2. Resume: a run of 2N steps equals N steps, a checkpoint and a resumed
   run, exactly — LF4 einsum and upwind RK4 with Q 30/20 (the ``xi``
   extra rides the checkpoint).
3. The runner impls on the CPU (``pallas``, ``lane``, ``merged``: their
   plain versions) against ``einsum``.
4. Refusals: ``--shards`` exits non-zero, and without ``--cpu`` every
   program exits non-zero when there is no CUDA device.
5. ``--mesh`` (Gmsh groups for the BCs), ``--layered`` and ``--vtk``
   against JAX's script.
6. ``cli.eigenmode2d`` passes its order bar, ``cli.eigenmode3d`` writes its
   sweep, ``cli.precision_study`` gates (it fails at a tiny size, where
   the discretisation error is above 1e-4); ``cli.topography`` writes its
   VTK series and seismograms.
"""

import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seigen_tpu_torch.cli import eigenmode2d, eigenmode3d, \
    explosive_source, precision_study, topography

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several pytest workers' intra-op thread pools fight over the
    cores; these tiny runs gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = ["--dim", "2", "--n", "4", "--degree", "2", "--f64",
        "--receivers", "4"]


def _port(tmp_path, name, args):
    out = str(tmp_path / f"{name}.npz")
    assert explosive_source.main(BASE + ["--cpu", "--out", out] + args) == 0
    return np.load(out)["seismograms"]


def _jax_script(tmp_path, name, args, monkeypatch):
    """scripts/explosive_source.py in this process (conftest pins JAX to
    the CPU)."""
    out = str(tmp_path / f"{name}.npz")
    monkeypatch.setattr(sys, "argv", ["explosive_source.py"] + BASE
                        + ["--out", out] + args)
    with pytest.raises(SystemExit) as e:
        runpy.run_path(str(REPO / "scripts" / "explosive_source.py"),
                       run_name="__main__")
    assert e.value.code == 0
    return np.load(out)["seismograms"]


def _close(got, ref, rel=1e-9):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("scheme", ["lf", "upwind-rk4"])
def test_explosive_source_matches_jax_script(tmp_path, monkeypatch, scheme):
    args = ["--T", "0.1", "--impl", "einsum", "--scheme", scheme]
    got = _port(tmp_path, "port", args)
    ref = _jax_script(tmp_path, "jax", args, monkeypatch)
    assert np.abs(ref).max() > 0
    _close(got, ref)


@pytest.mark.parametrize("extra", [[], ["--scheme", "upwind-rk4", "--qp",
                                        "30", "--qs", "20"]],
                         ids=["lf4", "upwind-visco"])
def test_resume_is_exact(tmp_path, extra):
    ck = str(tmp_path / "ck")
    common = ["--impl", "einsum"] + extra
    full = _port(tmp_path, "full", common + ["--T", "0.1"])
    assert explosive_source.main(
        BASE + ["--cpu", "--T", "0.05", "--checkpoint", ck,
                "--checkpoint-every", "3"] + common) == 0
    data = np.load(ck + ".npz")
    assert ("extra_xi" in data.files) == bool(extra)
    resumed = _port(tmp_path, "resumed",
                    common + ["--T", "0.1", "--resume", ck + ".npz"])
    assert 0 < len(resumed) < len(full)
    np.testing.assert_array_equal(resumed, full[-len(resumed):])


@pytest.mark.parametrize("impl", ["pallas", "lane", "merged"])
def test_runner_impls_match_einsum(tmp_path, impl):
    args = ["--T", "0.08"]
    _close(_port(tmp_path, impl, args + ["--impl", impl]),
           _port(tmp_path, "einsum", args + ["--impl", "einsum"]))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_gmsh_layered_vtk_matches_jax_script(tmp_path, monkeypatch, path):
    """--mesh with named Gmsh groups for the BCs, --layered, --vtk: the
    seismograms of JAX's script with the same flags, and one snapshot per
    --vtk-every steps.  The end receivers lie on element edges, where the
    element is picked by the roundoff of Ginv, so both packages take the
    same geometry: both their native C++ factors (the same source and
    flags: bitwise equal) or both their NumPy ones."""
    import seigen_tpu.mesh.native as jnative
    import seigen_tpu_torch.mesh.native as tnative
    from seigen_tpu.mesh import rect_mesh
    from test_gmsh import _boundary_edges, _write_msh_v2

    topo = rect_mesh(10, 5, lx=2.0, ly=1.0)
    edges = _boundary_edges(topo)
    on_top = np.all(np.abs(topo.vertices[edges][:, :, 1] - 1.0) < 1e-12,
                    axis=1)
    msh = str(tmp_path / "m.msh")
    _write_msh_v2(msh, topo, groups=[("surface", 1, edges[on_top]),
                                     ("sides", 2, edges[~on_top])])
    args = ["--mesh", msh, "--bc-free", "surface", "--bc-absorb", "sides",
            "--layered", "--degree", "1", "--T", "0.1", "--impl", "einsum"]
    vtk = tmp_path / "vtk" / "run.pvd"
    if path == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    got = _port(tmp_path, "port", args + ["--vtk", str(vtk),
                                          "--vtk-every", "5"])
    _close(got, _jax_script(tmp_path, "jax", args, monkeypatch))
    n_vtu = len(list(vtk.parent.glob("run_*.vtu")))
    assert n_vtu == -(-len(got) // 5)
    assert 'timestep="' in vtk.read_text()


def test_refusals(tmp_path, monkeypatch):
    # --shards with --scheme upwind-rk4: the JAX script runs leapfrog
    with pytest.raises(SystemExit) as e:
        explosive_source.main(BASE + ["--cpu", "--shards", "2",
                                      "--scheme", "upwind-rk4"])
    assert "leapfrog" in str(e.value.code)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (explosive_source, eigenmode2d, eigenmode3d, topography,
                precision_study):
        with pytest.raises(SystemExit) as e:
            mod.main([])
        assert e.value.code not in (0, None), mod.__name__
        assert "CUDA" in str(e.value.code)


def test_eigenmode_precision_and_topography(tmp_path):
    assert eigenmode2d.main(["--sizes", "4,8", "--degree", "1", "--f64",
                             "--cpu", "--min-order", "1.4"]) == 0
    js = tmp_path / "eig3d.json"
    assert eigenmode3d.main(["--degrees", "1", "--sizes", "2,3", "--f64",
                             "--cpu", "--json", str(js)]) == 0
    assert json.loads(js.read_text())["sweep"]["P1"]["observed_order"] > 1.0
    # the precision study on the CPU runs the plain runner in f32 and f64:
    # equal errors, but far above the gate's 1e-4 at this size
    pj = tmp_path / "prec.json"
    assert precision_study.main(["--N", "4", "--degree", "1", "--periods",
                                 "0.2", "--cpu", "--out", str(pj)]) == 1
    res = json.loads(pj.read_text())
    assert res["ratio"] == pytest.approx(1.0, abs=1e-4)
    assert not res["pass"] and res["runs"]["f32"]["err"] > res["max_err"]
    out, vtk = tmp_path / "topo.npz", tmp_path / "topo.pvd"
    assert topography.main(["--nx", "10", "--nz", "6", "--degree", "1",
                            "--T", "0.15", "--cpu", "--amp", "0.08",
                            "--out", str(out), "--vtk", str(vtk),
                            "--vtk-every", "1000"]) == 0
    d = np.load(out)
    assert np.isfinite(d["seis"]).all() and d["seis"].shape[-1] == 3
    # the receivers ride the curved surface: the central hill lifts them
    assert d["receivers_phys"][:, 1].max() > 1.01
    assert "UnstructuredGrid" in open(tmp_path / "topo_00000.vtu").read()
