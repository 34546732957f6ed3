"""Device kernels a big-move round issues: the profiler's kernel records
over the traced chunk, over its rounds (the host loops of
``experiments/algorithm1.run_testing`` and ``mcmc/hybrid``)."""


def read(ctx):
    kernels = ctx.trace.kernels()
    return len(kernels) / ctx.traced["units"] if kernels else None
