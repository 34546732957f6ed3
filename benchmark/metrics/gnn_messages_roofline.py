"""The torus EGNN's message passing's share of its roofline: the least
time of its work a round (the larger of its least products at 67 TFLOP/s
and its least bytes at 3.35 TB/s, ``gnn_counts.py``: every layer of
every coupling of the round's two flow passes over every chain) over the
device time of the program's ``flow.gnn.messages`` spans a round, in
percent.  None unless the program counted every message of the traced
chunk's passes (``flows/nets.py::GNN_MESSAGES``), so that a path that
skips messages gives no number."""

from benchmark import counts, gnn_counts, program_spans

PASSES = 2      # a round's proposal and its current point's log q


def read(ctx):
    f, s = ctx.config["flow"], ctx.config["system"]
    n, c = s["num_particles"], ctx.traffic["chains"]
    dim = 2 * n
    rounds = ctx.traced["units"]
    if ctx.traced.get("gnn_messages") != \
            PASSES * gnn_counts.messages(f, dim, c) * rounds:
        return None
    ms = program_spans.device_ms_per_round(ctx, "flow.gnn.messages")
    if ms is None:
        return None
    nodes, h = dim - dim // 2, f["hidden_units"]
    layers = PASSES * f["K"] * f["n_blocks"] * c
    bound = counts.bound_s(layers * gnn_counts.layer_flops(nodes, h),
                           layers * gnn_counts.layer_bytes(nodes, h))
    return 100.0 * bound / (ms / 1e3)
