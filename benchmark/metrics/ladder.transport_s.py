"""ladder.transport_s: seconds a run spends in the transport phase (every
species' pcut ladder, engine/run.py run_ion on ops/mega.py
drive_ladder_async: RunResult.timers["transport"]), the mean over the
traced window's runs."""


def read(ctx):
    return sum(r.timers.get("transport", 0.0)
               for r in ctx.runs) / len(ctx.runs)
