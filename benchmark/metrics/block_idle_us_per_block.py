"""Microseconds a production block that the card idled while the host was
in the block (``mcmc/metropolis.run_production_with``: the moves' launch,
the resync, ``sample_observables``): the idle gaps of the traced chunk
that opened inside the program's ``mcmc.block`` spans, over the chunk's
blocks."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_per_unit(
        ctx, "mcmc.block", lambda spans, t: spans.inside(t, "mcmc.block"))
