"""ladder.idle_s: seconds a run in which the device was idle under the
port's span ``mcs.transport`` (every species' population build, pcut
ladder and tally reads: the host's enqueue, its sync reads, the split),
on the trace's clock (harness/spans.py); the traced window's total over
its runs.  None where the program opens no spans."""

from harness import spans


def read(ctx):
    if ctx.trace is None or not spans.has_spans(ctx.trace):
        return None
    return spans.idle_s(ctx.trace, "mcs.transport") / len(ctx.runs)
