"""reductions.wait_s: seconds a run the driver's main thread waited for
the worker thread's host reductions of the iteration's species (the
port's span ``mcs.reductions.wait``: the part of the worker's time left
on the critical path), on the trace's clock (harness/spans.py); the
traced window's total over its runs.  None where the program opens no
spans."""

from harness import spans


def read(ctx):
    if ctx.trace is None or not spans.has_spans(ctx.trace):
        return None
    return spans.seconds(spans.under(ctx.trace, "mcs.reductions.wait")
                         ) / len(ctx.runs)
