"""The whole production block's share of the card's float32 peak: the
move kernel's operations for every chain's moves of a block and the
pair-energy kernel's lower count for its resync, over the seconds a block
takes in the untraced part of the traced run, in percent of 67 TFLOP/s."""

from benchmark import counts


def read(ctx):
    s = ctx.config["system"]
    n, c, wells = s["num_particles"], ctx.traffic["chains"], len(s["V0_list"])
    flops = (counts.k1_ops(c, n, wells, ctx.traffic["moves_per_sample"])
             + counts.k2_ops(c, n, wells))
    return 100.0 * flops / ctx.window["unit_s"] / counts.PEAK_FP32_FLOPS
