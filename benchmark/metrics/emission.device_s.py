"""emission.device_s: device seconds a run of the operations launched
under the port's span ``mcs.emission`` (the driver's emission phase:
synchrotron, IC and pi0 spectra of every zone, the Doppler shift, the
shell sums and their copies), each operation joined to its launching
call by the profiler's correlation id (harness/spans.py
``launched_s``); the traced window's total over its runs.  None where
the program opens no spans or no emission span, or where the trace
carries no correlation ids."""

from harness import spans

NAME = "mcs.emission"


def read(ctx):
    if ctx.trace is None or not spans.has_spans(ctx.trace) or not any(
            h[0] == NAME for h in ctx.trace.host):
        return None
    s = spans.launched_s(ctx.trace, NAME)
    return None if s is None else s / len(ctx.runs)
