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
  launching call ran inside `name`: the call with the operation's
  correlation id (``Trace.device_ids``, ``Trace.calls``), on the span's
  own thread and inside one of its intervals.  The join holds on any
  number of streams and threads, for a CUDA graph's launch (its
  operations carry the launch's id) and where the window holds launches
  and operations in unequal numbers.  An operation whose call the trace
  lacks counts under no span; a trace without correlation ids reads
  None.

A trace of a program without spans has none to read: ``has_spans`` is
false there and the metrics' readers return None.
"""

from __future__ import annotations

import bisect

from .trace import clip, gaps, union

PREFIX = "mcs."
RUN = PREFIX + "run"


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


def launched_s(trace, name: str) -> float | None:
    """Device seconds (the union, inside the window) of the operations
    whose launching call ran under the span `name` on that span's
    thread, the two joined by the profiler's correlation id; None where
    the operations or the calls carry no id."""
    if not trace.calls or all(c is None for c in trace.device_ids):
        return None
    lo, hi = trace.window
    by_thread = {}
    for (n, s, e), tid in zip(trace.host, trace.host_threads):
        if n == name:
            by_thread.setdefault(tid, []).append((s, e))
    spans = {tid: union(clip(iv, lo, hi)) for tid, iv in by_thread.items()}
    starts = {tid: [s for s, _ in iv] for tid, iv in spans.items()}

    def inside(call) -> bool:
        tid, t = call
        if tid not in spans:
            return False
        k = bisect.bisect_right(starts[tid], t) - 1
        return k >= 0 and t <= spans[tid][k][1]

    ops = [(s, e) for (_, s, e), c in zip(trace.device, trace.device_ids)
           if lo <= s < hi and c in trace.calls and inside(trace.calls[c])]
    return seconds(union(clip(ops, lo, hi)))
