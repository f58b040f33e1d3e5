"""K3 upwind_rhs (ops/upwind_kernels.py, csrc/upwind_tile.cuh): its least
time a step over its profiled time a step."""

from benchmark.metrics._roofline import share


def read(ctx):
    return share(ctx, "upwind", ("upwind_rhs",))
