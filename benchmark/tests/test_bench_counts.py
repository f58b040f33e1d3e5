"""The counts, pinned: DOF, least FLOPs a step, and the kernel byte rows
against the port's own compulsory-row counts."""

import ast
import inspect
from pathlib import Path

import pytest

from benchmark import counts


def test_dof_at_n40_p3():
    assert counts.dof(6 * 40 ** 3, 20, 3) == 69_120_000


def test_least_flops_a_step_at_p3():
    # n_p = 20, nf n_fp = 40
    assert counts.op_flops(3, 20, 4, 10, 3) == 12_000
    assert counts.op_flops(3, 20, 4, 10, 6) == 16_800
    assert counts.step_flops("lf4", 3, 20, 4, 10) == 86_400
    assert counts.step_flops("rk4", 3, 20, 4, 10) == 115_200


def test_counts_read_no_runner():
    """Every count is a function of plain sizes: no attribute of any
    object is read in counts.py but of its own module-level names."""
    tree = ast.parse(Path(inspect.getfile(counts)).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert isinstance(node.value, ast.Name) and \
                node.value.id not in ("runner", "d", "plan", "p"), \
                ast.dump(node)
    for fn in (counts.dof, counts.op_flops, counts.step_flops,
               counts.merged_rows, counts.lane_sel_rows,
               counts.kernel_bound_ms):
        for name in inspect.signature(fn).parameters:
            assert name not in ("runner", "d", "plan", "p")


def _case(scramble, degree):
    from benchmark.tests.test_bench_reference import CFG
    from benchmark.inputs import make_inputs
    import json

    cfg = json.loads(json.dumps(CFG))
    cfg["mesh"]["n"], cfg["degree"] = [4, 4, 4], degree
    cfg["mesh"]["scramble"] = scramble
    return make_inputs(cfg, 3)


@pytest.mark.parametrize("degree", [2, 3])
def test_merged_rows_are_the_ports(degree):
    from seigen_tpu_torch.bench.roofline import bound_rows
    from benchmark.program import Program

    inp = _case(False, degree)
    for kind, kname, fam in (("merged", "merged_vel", "vel"),
                             ("merged", "merged_stress", "stress"),
                             ("upwind", "upwind_rhs", "upwind")):
        r = Program(inp, {"runner": kind}, "cpu", {}).runner
        d = r.d
        for variant in ("plain", "axpy", "axpy_damp", "inject1"):
            assert counts.merged_rows(d.dim, d.n_p, d.nf, d.n_fp, fam,
                                      variant) == \
                bound_rows(d, r.plan, kname, variant=variant)


@pytest.mark.parametrize("degree", [2, 3])
def test_lane_sel_rows_are_the_ports(degree):
    from seigen_tpu_torch.bench import roofline
    from benchmark.program import Program

    inp = _case(True, degree)
    r = Program(inp, {"runner": "lane_u"}, "cpu", {}).runner
    d = r.d
    for mode, kname in (("SEL vel", "vel"), ("SEL stress", "stress")):
        rows = counts.lane_sel_rows(d.dim, d.n_p, d.nf, d.n_fp, kname)
        ms = 1e3 * 4.0 * rows * d.E / counts.HBM_BYTES_PER_S
        assert roofline.lane_bound(d, mode)[0] == pytest.approx(ms)


def test_kernel_bounds_at_the_cells_size():
    """At E = 384 000 P3 the launches are bound by bytes, and the step's
    FLOPs over the FP32 peak take 0.50 ms (LF4)."""
    E = 6 * 40 ** 3
    for fam in counts.STEPS:
        for k, v in counts.STEPS[fam]:
            rows = (counts.lane_sel_rows(3, 20, 4, 10, k)
                    if fam == "lane_sel"
                    else counts.merged_rows(3, 20, 4, 10, k, v))
            assert counts.launch_bound_ms(fam, 3, 20, 4, 10, E, k, v) == \
                pytest.approx(1e3 * 4.0 * rows * E / counts.HBM_BYTES_PER_S)
    t = 1e3 * counts.step_flops("lf4", 3, 20, 4, 10) * E \
        / counts.FP32_FLOPS_PER_S
    assert t == pytest.approx(0.4952, rel=1e-3)


