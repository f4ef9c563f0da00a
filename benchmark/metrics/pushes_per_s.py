"""pushes_per_s: every helix push of the window's runs
(RunResult.n_pushes, the summed per-lane step counts) over the window's
seconds, on the host's clock."""


def read(ctx):
    return sum(r.pushes for r in ctx.runs) / ctx.window_s
