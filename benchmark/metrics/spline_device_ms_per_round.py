"""Device milliseconds of the splines a round (``ops/splines``): the
device operations launched inside the program's ``flow.spline`` spans,
over the traced chunk's ``a1.round`` spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.device_ms_per_round(ctx, "flow.spline")
