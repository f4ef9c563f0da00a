"""driver.idle_s: seconds a run in which the device was idle while the
driver ran its host phases: under the port's span ``mcs.run`` and not
under ``mcs.transport`` (setup, reductions, smoothing, io), on the
trace's clock (harness/spans.py); the traced window's total over its
runs.  None where the program opens no spans."""

from harness import spans


def read(ctx):
    if ctx.trace is None or not spans.has_spans(ctx.trace):
        return None
    return spans.idle_s(ctx.trace, "mcs.run",
                        minus="mcs.transport") / len(ctx.runs)
