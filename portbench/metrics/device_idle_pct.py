"""Device: the share of the traced slice's wall time in which no kernel,
copy or set ran on the card (the union of the profiler's device events)."""


def read(ctx):
    if not ctx.trace or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
