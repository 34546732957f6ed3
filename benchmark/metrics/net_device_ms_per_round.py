"""Device milliseconds of the couplings' conditioner nets a round
(``flows/nets``: the residual net or the transformer): the device
operations launched inside the program's ``flow.net`` spans, over the
traced chunk's ``a1.round`` spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.device_ms_per_round(ctx, "flow.net")
