"""Milliseconds a round that the card idled while the host was in the
flow: the idle gaps of the traced chunk that opened while the innermost
open program span was a ``flow.*`` span (a flow pass, a net or a spline),
over the chunk's ``a1.round`` spans."""

from benchmark import program_spans


def _in_flow(spans, t):
    return (spans.name_at(t) or "").startswith("flow.")


def read(ctx):
    idle = program_spans.idle_per_unit(ctx, "a1.round", _in_flow)
    return None if idle is None else idle / 1e3
