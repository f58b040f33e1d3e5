"""Milliseconds a step of PyTorch's elementwise kernels: the glue of the
lane and RK4 runners (stage arithmetic, sponge, traction rows)."""


def read(ctx):
    if not ctx.on_card or ctx.family not in ("lane_sel", "upwind"):
        return None
    return ctx.group_ms.get("pytorch elementwise")
