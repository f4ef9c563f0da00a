"""run_s: the window's seconds over the whole model runs completed in it
(the run in flight at the window's end completes and counts), on the
host's clock: the time to one complete run."""


def read(ctx):
    return ctx.window_s / len(ctx.runs)
