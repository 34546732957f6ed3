"""The card's idle share over the traced chunk of big-move rounds: one
less the union of its device operations' intervals over the window, in
percent."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
