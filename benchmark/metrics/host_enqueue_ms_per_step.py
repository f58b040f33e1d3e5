"""Host milliseconds a step of a short lane-major run takes to enqueue,
before its synchronise: how close the host comes to pacing the card."""


def read(ctx):
    return ctx.enqueue_ms
