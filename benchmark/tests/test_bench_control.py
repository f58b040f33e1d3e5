"""The control of ``correct`` fails the cells' limits: the reference in
TF32, in the program's place, at a tiny size on the CPU (its products'
operands rounded to TF32 as the card's tensor cores round them)."""

import pytest

from benchmark.control import control
from benchmark.layout import Layout
from benchmark.tests.test_bench_faults import ONE_CHIP


@pytest.mark.parametrize("seed", [101, 202, 2 ** 31 + 303])
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_control_fails_the_limits(tiny_bench, cell, seed):
    res = control(cell, seed, 0.2, Layout(tiny_bench), "cpu")
    assert not res["passes"], res["checks"]
