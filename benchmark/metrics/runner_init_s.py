"""Seconds of the runner's constructor: structure detection, the lane
plan, device arrays, the kernel libraries' load (span "runner")."""


def read(ctx):
    return ctx.spans.get("runner")
