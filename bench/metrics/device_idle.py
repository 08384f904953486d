"""device_idle: the share of the traced jobs' wall time in which no kernel,
copy or fill ran on the card, in percent (from the profiler's trace)."""


def read(ctx):
    window = sum(t.window[1] - t.window[0] for t in ctx.traces)
    if not ctx.traces or window <= 0:
        return None
    return 100.0 * (1.0 - sum(t.busy_s for t in ctx.traces) / window)
