"""The whole step's share of the card's FP32 peak: the least FLOPs of a
step (benchmark/counts.py) over the measured time a step takes, after the
traced chunks of the window."""

from benchmark import counts


def read(ctx):
    if not ctx.on_card or not ctx.ms_per_step:
        return None
    sh = ctx.shape
    flops = counts.step_flops(ctx.scheme, sh["dim"], sh["n_p"], sh["nf"],
                              sh["n_fp"]) * sh["E"]
    return 100.0 * flops / (ctx.ms_per_step * 1e-3
                            * counts.FP32_FLOPS_PER_S)
