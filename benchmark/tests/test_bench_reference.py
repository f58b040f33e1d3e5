"""The benchmark's reference against the port's runners on the CPU (their
plain versions, float64), and the imports of the harness and the
reference."""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.check import Reference, compare
from benchmark.harness import forbidden_modules
from benchmark.inputs import box_topology, make_inputs
from benchmark.program import Program

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "benchmark/configs/"
                  "explosive3d-layered-n40-p3.json").read_text())


def _inputs(scramble, seed=987654321987):
    cfg = json.loads(json.dumps(CFG))
    cfg["mesh"]["n"], cfg["degree"] = [3, 3, 3], 2
    cfg["mesh"]["scramble"] = scramble
    return make_inputs(cfg, seed)


CASES = {  # name: (runner, scheme, scrambled)
    "merged-lf4": ("merged", "lf4", False),
    "lane_u-lf4": ("lane_u", "lf4", True),
    "upwind-rk4": ("upwind", "rk4", False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_follows_the_port(case):
    runner, scheme, scrambled = CASES[case]
    inp = _inputs(scrambled)
    prog = Program(inp, {"runner": runner}, "cpu", {},
                   dtype=torch.float64)
    ref = Reference(inp, scheme, torch.device("cpu"), dtype=torch.float64)
    st1, seis1 = prog.run(prog.state0, 8, 0)
    st2, seis2 = prog.run(st1, 8, 8)
    for label, st_in, st_out, seis, step0 in (
            ("start", prog.state0, st1, seis1, 0),
            ("last", st1, st2, seis2, 8)):
        got = compare(ref, label, st_in, st_out, seis, 8, step0)
        assert max(got.values()) < 1e-10, got
    assert float(st2.u.abs().max()) > 0


def test_reference_follows_the_unstructured_upwind_runner():
    """RK4 on an unstructured mesh: the port's UnstructuredUpwindRunner."""
    from seigen_tpu_torch.mesh import MeshTopology, build_discrete
    from seigen_tpu_torch.ops import Material, build_params, \
        build_upwind_data
    from seigen_tpu_torch.solver import PointSource, State, \
        absorbing_bc_fn, build_receivers, build_sources, sponge_mask
    from seigen_tpu_torch.solver.lane_upwind_u import \
        UnstructuredUpwindRunner

    inp = _inputs(True)
    kw = dict(dtype=torch.float64, device="cpu")
    dm = build_discrete(MeshTopology(inp.vertices, inp.cells, inp.extents),
                        inp.degree, bc_fn=absorbing_bc_fn(
                            inp.extents, list(inp.free_sides)))
    mat = Material(inp.rho, inp.vp, inp.vs)
    p = build_params(dm, mat, **kw)
    r = UnstructuredUpwindRunner(
        p, build_upwind_data(dm, mat, **kw), inp.dt,
        src=build_sources(dm, [PointSource(inp.source, inp.f0,
                                           radius=inp.radius)], **kw),
        damp=torch.as_tensor(sponge_mask(dm, list(inp.absorb_sides),
                                         inp.sponge_width)),
        receivers=build_receivers(dm, inp.receivers, **kw),
        centroids=dm.coords.mean(axis=1))
    E, n_p = inp.E, dm.re.n_p
    st0 = State(u=torch.zeros((E, n_p, 3), **kw),
                s=torch.zeros((E, n_p, 6), **kw))
    st1, seis = r.run(st0, 8)
    ref = Reference(inp, "rk4", torch.device("cpu"), dtype=torch.float64)
    got = compare(ref, "start", st0, st1, seis, 8, 0)
    assert max(got.values()) < 1e-10, got


def test_box_topology_is_the_ports_box_mesh():
    from seigen_tpu_torch.mesh import box_mesh

    v, c = box_topology((3, 4, 2), ((0.0, 1.0),) * 3)
    topo = box_mesh(3, 4, 2)
    np.testing.assert_array_equal(v, topo.vertices)
    np.testing.assert_array_equal(c, topo.cells)


def test_inputs_follow_the_seed():
    a, b, c = _inputs(False, 5), _inputs(False, 5), _inputs(False, 2**33)
    assert a.source == b.source and np.array_equal(a.vp, b.vp)
    assert not np.array_equal(a.vp, c.vp)
    # every seed costs the same: the step and the source's place are fixed
    assert (a.dt, a.f0, a.source) == (c.dt, c.f0, c.source)
    assert (np.abs(a.vp / c.vp - 1) < 0.11).all()


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    mods = dict(sys.modules)
    mods.pop("jax", None)
    mods.pop("seigen_tpu", None)
    mods["seigen_tpu_torch_like"] = types.ModuleType("x")
    monkeypatch.setattr(sys, "modules", mods)
    assert forbidden_modules() == []
    mods["seigen_tpu.solver"] = types.ModuleType("seigen_tpu.solver")
    assert forbidden_modules() == ["seigen_tpu"]
    mods["jax"] = types.ModuleType("jax")
    assert forbidden_modules() == ["jax", "seigen_tpu"]


def _imports(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json; print(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_imports_no_jax_and_not_the_jax_package():
    tops = _imports("import benchmark.run, benchmark.harness, "
                    "benchmark.program, benchmark.control, "
                    "benchmark.tests.faults")
    assert "seigen_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "seigen_tpu"}


def test_reference_imports_nothing_of_the_port():
    tops = _imports("import benchmark.reference.physics, "
                    "benchmark.reference.mesh, benchmark.check, "
                    "benchmark.counts, benchmark.inputs")
    assert not tops & {"jax", "jaxlib", "flax", "seigen_tpu",
                       "seigen_tpu_torch"}
