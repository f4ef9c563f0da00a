"""driver.host_s: seconds a run spends in the driver's phases other than
transport (setup, reductions, smoothing, emission, checkpoint, io:
engine/driver.py's PhaseTimers, RunResult.timers), the mean over the
traced window's runs."""


def read(ctx):
    return sum(sum(v for k, v in r.timers.items() if k != "transport")
               for r in ctx.runs) / len(ctx.runs)
