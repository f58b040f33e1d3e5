"""Milliseconds a step of PyTorch's gather/index kernels: the lane
runners' trace exchange (ops/unstructured_exchange.py)."""


def read(ctx):
    if not ctx.on_card or ctx.family != "lane_sel":
        return None
    return ctx.group_ms.get("pytorch gather/index")
