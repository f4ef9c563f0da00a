"""emission.host_s: seconds a run spends in the driver's emission phase
(models/emission/driver.py photon_calcs, every iteration's:
RunResult.timers["emission"]), the mean over the traced window's runs.
None where no run has the phase."""


def read(ctx):
    got = [r.timers["emission"] for r in ctx.runs if "emission" in r.timers]
    return sum(got) / len(ctx.runs) if got else None
