"""The move kernel's (K1, ``csrc/metropolis_moves.cu``) share of its
roofline: the least time its operations and bytes need at the card's
published peaks, over the mean duration of its profiler records, in
percent."""

from benchmark import counts


def read(ctx):
    records = ctx.trace.kernels("metropolis_moves")
    if not records:
        return None
    s = ctx.config["system"]
    n, c, wells = s["num_particles"], ctx.traffic["chains"], len(s["V0_list"])
    bound = counts.bound_s(counts.k1_ops(c, n, wells, ctx.traffic["moves_per_sample"]),
                           counts.k1_bytes(c, n))
    mean_s = sum(end - start for start, end, *_ in records) / len(records) / 1e6
    return 100.0 * bound / mean_s
