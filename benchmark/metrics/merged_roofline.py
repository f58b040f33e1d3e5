"""K1 merged_vel + K2 merged_stress (ops/merged_kernels.py,
csrc/merged_tile.cuh): their least time a step over their profiled time a
step."""

from benchmark.metrics._roofline import share


def read(ctx):
    return share(ctx, "merged", ("merged_vel", "merged_stress"))
