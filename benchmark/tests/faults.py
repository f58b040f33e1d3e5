"""Programs broken underneath the harness, for the fault tests: each
builds the port's program and spoils what its chunk returns."""

import torch

from benchmark.harness import _program


class _Broken:
    def __init__(self, prog, spoil):
        self.prog, self.spoil = prog, spoil
        self.state0 = prog.state0

    def run(self, state, k, step0):
        out, seis = self.prog.run(state, k, step0)
        return self.spoil(state, out), seis

    def enqueue_probe(self, state, steps, step0):
        return self.prog.enqueue_probe(state, steps, step0)


def _state(like, u, s):
    return type(like)(u=u, s=s)


def unchanged(inp, traffic, device, spans):
    """A chunk that hands back its input state."""
    return _Broken(_program(inp, traffic, device, spans),
                   lambda st_in, out: st_in)


def half_batch(inp, traffic, device, spans):
    """A chunk that leaves the second half of the elements as they were."""
    def spoil(st_in, out):
        h = out.u.shape[0] // 2
        return _state(out, torch.cat([out.u[:h], st_in.u[h:]]),
                      torch.cat([out.s[:h], st_in.s[h:]]))

    return _Broken(_program(inp, traffic, device, spans), spoil)


def altered(inp, traffic, device, spans):
    """A chunk whose answer is altered where it is produced: one element's
    velocity moved by the field's largest value."""
    def spoil(st_in, out):
        u = out.u.clone()
        u[u.shape[0] // 3] += u.abs().max()
        return _state(out, u, out.s)

    return _Broken(_program(inp, traffic, device, spans), spoil)

