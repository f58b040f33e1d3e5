"""Share of the traced chunks in which no operation ran on the card."""


def read(ctx):
    if not ctx.on_card or not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
