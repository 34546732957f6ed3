"""Device milliseconds of the flow a round (``flows/`` and
``ops/splines``): the device operations launched inside the benchmark's
spans around ``sample_and_log_prob`` and ``log_prob``, over the traced
chunk's rounds."""

FLOW_SPANS = ("bench.flow.sample_and_log_prob", "bench.flow.log_prob")


def read(ctx):
    ops = ctx.trace.launched_in(FLOW_SPANS)
    if not ops:
        return None
    return sum(end - start for start, end, *_ in ops) / 1e3 / ctx.traced["units"]
