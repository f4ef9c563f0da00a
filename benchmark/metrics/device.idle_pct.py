"""device.idle_pct: the share of the traced window in which no operation
ran on the device: 1 - (the union of the device's intervals) / (the
window).  An upper bound: the profiler slows the host."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.window_s > 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
