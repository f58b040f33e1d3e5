"""K4 TRAC SEL + K5 SEL (ops/lane_kernels.py, csrc/lane_kernels.cu):
their least time a step over their profiled time a step."""

from benchmark.metrics._roofline import share


def read(ctx):
    return share(ctx, "lane_sel", ("lane_vel", "lane_stress"))
