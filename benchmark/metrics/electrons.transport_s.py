"""electrons.transport_s: seconds a run spends transporting its
electron species (engine/run.py run_ion: the population build, the pcut
ladder and the tally reads), the port's span
``mcs.transport.electrons`` inside ``mcs.transport``, on the trace's
clock (harness/spans.py); the traced window's total over its runs.
None where the program opens no such span."""

from harness import spans

NAME = "mcs.transport.electrons"


def read(ctx):
    if ctx.trace is None or not any(h[0] == NAME for h in ctx.trace.host):
        return None
    return spans.seconds(spans.under(ctx.trace, NAME)) / len(ctx.runs)
