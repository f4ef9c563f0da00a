"""finish.device_s: device seconds a run of the operations launched
under the port's span ``mcs.finish`` (ops/finish.py finish_particles
and the exits' count after every drain, their accumulating index_put_
among them), each operation joined to its launching call by the
profiler's correlation id (harness/spans.py ``launched_s``); the traced
window's total over its runs.  None where the program opens no spans,
or where the trace carries no correlation ids."""

from harness import spans


def read(ctx):
    if ctx.trace is None or not spans.has_spans(ctx.trace):
        return None
    s = spans.launched_s(ctx.trace, "mcs.finish")
    return None if s is None else s / len(ctx.runs)
