"""The whole round's share of the card's float32 peak with the torus EGNN
conditioner: ``round_mfu``'s sum with the flow's two passes counted by
their least products (``gnn_counts.py``), with the move kernel's
operations and the pair-energy kernel's lower count, over the seconds a
round takes in the untraced part of the traced run, in percent of 67
TFLOP/s."""

from benchmark import counts, gnn_counts


def read(ctx):
    s = ctx.config["system"]
    n, c = s["num_particles"], ctx.traffic["chains"]
    wells = len(s["V0_list"])
    flops = (2 * gnn_counts.flow_pass_flops(ctx.config["flow"], 2 * n, c)
             + counts.k1_ops(c, n, wells, ctx.config["schedule"]["big_move_interval"])
             + counts.k2_ops(c, n, wells))
    return 100.0 * flops / ctx.window["unit_s"] / counts.PEAK_FP32_FLOPS
