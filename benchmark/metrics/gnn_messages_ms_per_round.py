"""Device milliseconds of the torus EGNN's message passing a round
(``flows/nets.py::TorusEGNN``: the relative coordinates through the last
layer's update): the device operations launched inside the program's
``flow.gnn.messages`` spans, over the traced chunk's ``a1.round``
spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.device_ms_per_round(ctx, "flow.gnn.messages")
