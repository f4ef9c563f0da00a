"""finish.device_s: device seconds a run of the operations launched
under the port's span ``mcs.finish`` (ops/finish.py finish_particles
and the exits' count after every drain, their accumulating index_put_
among them), each operation paired with its launching call in order
(harness/spans.py); the traced window's total over its runs.  None
where the program opens no spans, or where the launches cannot be
paired."""

from harness import spans


def read(ctx):
    if ctx.trace is None or not spans.has_spans(ctx.trace):
        return None
    s = spans.launched_s(ctx.trace, "mcs.finish")
    return None if s is None else s / len(ctx.runs)
