"""Seconds of the port's case set-up: build_discrete (geometry, face
pairing), build_params, the source, receivers and sponge (the benchmark's
span "mesh")."""


def read(ctx):
    return ctx.spans.get("mesh")
