"""Shared by the ``*_roofline`` readers: a kernel family's least time a
step (benchmark/counts.py) over its profiled time a step."""

from benchmark import counts


def share(ctx, family, groups):
    if not ctx.on_card or ctx.family != family:
        return None
    ms = sum(ctx.group_ms.get(g, 0.0) for g in groups)
    if ms <= 0.0:
        return None
    sh = ctx.shape
    return 100.0 * counts.kernel_bound_ms(
        family, sh["dim"], sh["n_p"], sh["nf"], sh["n_fp"], sh["E"]) / ms
