"""The port's spans against the device trace (harness/trace.py ``Trace``).

The port opens ``mcs.*`` ranges on its main thread while a profiler runs
(montecarloscattering_jl_tpu_torch/utils/tracing.py): ``mcs.run`` around
each model run, a span a driver phase (``mcs.transport``, ...), one a
pcut segment's enqueue, ``mcs.finish`` around the exit bookkeeping, and
``mcs.reductions.wait`` where the main thread waits for the reductions'
worker.  The profiler writes them as host operators, so they are among
``Trace.host``'s (name, start, end), on the clock of the device's
kernels and copies; the worker thread, which the profiler does not
record, has none.  From them:

* ``under(trace, name)``: the union of a span's intervals, inside the
  window;
* ``idle_s(trace, name, minus)``: the device's idle time (the window
  outside the union of device intervals) under `name` and not under
  `minus`;
* ``launched_s(trace, name)``: the device time of the operations whose
  launching call ran inside `name`.  ``Trace`` keeps no correlation ids,
  so launches and operations are paired in order, as the port's one
  stream runs them: the k-th operation the device started in the window
  is the k-th kernel launch, copy or set the host called there.  Where
  the two counts differ (a CUDA graph's launch, say, runs several
  operations) the pairing is unknown and the reading is None.

A trace of a program without spans has none to read: ``has_spans`` is
false there and the metrics' readers return None.
"""

from __future__ import annotations

import bisect

from .trace import clip, gaps, union

PREFIX = "mcs."
RUN = PREFIX + "run"
# the CUDA runtime and driver calls that put one operation on a stream
# (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, cudaMemsetAsync)
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def has_spans(trace) -> bool:
    return any(h[0] == RUN for h in trace.host)


def under(trace, name: str) -> list:
    """The merged (start, end) intervals of the span `name`, clipped to
    the window."""
    lo, hi = trace.window
    return union(clip([(s, e) for n, s, e in trace.host if n == name],
                      lo, hi))


def intersect(a, b) -> list:
    """The overlap of two sorted lists of merged intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """The parts of the sorted merged intervals `a` outside those of
    `b`."""
    out = []
    for s, e in a:
        out.extend(gaps(clip(b, s, e), s, e))
    return out


def seconds(intervals) -> float:
    return sum(e - s for s, e in intervals)


def idle_s(trace, name: str, minus: str | None = None) -> float:
    """Seconds the device was idle under the span `name` and, where
    `minus` is given, not under the span `minus`."""
    lo, hi = trace.window
    where = under(trace, name)
    if minus is not None:
        where = subtract(where, under(trace, minus))
    return seconds(intersect(gaps(trace.busy(), lo, hi), where))


def launches(trace) -> list | None:
    """The start of the launching call of each device operation that
    starts in the window, in the operations' order; None where the
    counts differ."""
    lo, hi = trace.window
    calls = sorted(s for n, s, _ in trace.host
                   if lo <= s < hi and n.startswith(LAUNCH_CALLS))
    ops = [d for d in trace.device if lo <= d[1] < hi]
    if len(calls) != len(ops):
        return None
    return calls


def launched_s(trace, name: str) -> float | None:
    """Device seconds (the union, inside the window) of the operations
    whose launching call ran under the span `name`; None where the
    launches cannot be paired with the operations."""
    calls = launches(trace)
    if calls is None:
        return None
    spans = under(trace, name)
    starts = [s for s, _ in spans]

    def inside(t) -> bool:
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= spans[k][1]

    lo, hi = trace.window
    ops = sorted((s, e) for _, s, e in trace.device if lo <= s < hi)
    return seconds(union(clip([op for op, t in zip(ops, calls)
                               if inside(t)], lo, hi)))
