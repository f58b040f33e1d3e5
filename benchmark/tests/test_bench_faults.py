"""The harness sees ``correct`` come out false when the timed path is
broken underneath it, and true when it is not (CPU, tiny cells, the
port's plain versions; no look for a chip)."""

import pytest

from benchmark.harness import run
from benchmark.layout import Layout
from benchmark.tests import faults

ONE_CHIP = ("layered-n40-p3.merged-lf4",
            "layered-n40-p3-unstructured.lane_u-lf4",
            "layered-n40-p3.upwind-rk4")


def _run(bench, cell, make_program=None, trace=False):
    kw = {} if make_program is None else {"make_program": make_program}
    return run(cell, 2 ** 31 + 12345, 0.2, trace, Layout(bench), "cpu",
               **kw)


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_sound_run_is_correct(tiny_bench, cell):
    res = _run(tiny_bench, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"dof_updates_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_fault_is_caught(tiny_bench, cell, fault):
    res = _run(tiny_bench, cell, getattr(faults, fault))
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def test_traced_run_reports_per_layer(tiny_bench):
    """A traced run reports the cell's per-layer metrics it finds something
    for (on the CPU: the set-up spans and the host's enqueue), the
    breakdown, busy and window seconds, and the same checks."""
    res = _run(tiny_bench, ONE_CHIP[0], trace=True)
    assert res["correct"]
    assert {"mesh_setup_s", "runner_init_s",
            "host_enqueue_ms_per_step"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in res["device"] and res["device"]["window_s"] > 0
