"""Reduction of a torch.profiler trace of the timed window.

The profiler's Chrome trace is read into plain tuples (``collect``,
``from_events``), so that the arithmetic below runs on the CPU in tests:

* device busy time is the *union* of the device's intervals (kernels,
  copies, sets) inside the window: kernels that overlap, as the
  reductions' worker thread's against the next species' transport, count
  once;
* the idle gaps are the window's time outside that union, each named by
  the host operator the profiler shows across most of it (until the port
  opens ranges of its own, the nearest torch operator or CUDA runtime
  call);
* each device operation keeps the profiler's correlation id
  (``args.correlation``), and each CUDA runtime or driver call that
  carries one keeps it with its thread and start: the id joins an
  operation to the call that launched it, copied or set it, on any
  stream and from any thread (harness/spans.py ``launched_s``);
* host waits are the calls that block the host on the device:
  ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``, and device-to-host copies into pageable
  memory (each waits for its stream); a copy into pinned memory is
  queued and waits for nothing.  scripts/profile_run.py of the port
  counts every device-to-host copy.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "benchmark.window"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
TOP = 10
NAME_CHARS = 120


def union(intervals) -> list:
    """Merged (start, end) intervals of `intervals`, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(merged, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] outside the sorted, merged
    intervals `merged`."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def name_gap(gap, host) -> str:
    """The host event (name, start, end) of `host` (sorted by start) that
    overlaps `gap` the most; of events that overlap it alike, the
    shortest (the innermost)."""
    a, b = gap
    starts = [h[1] for h in host]
    best, key = "no host operator", (0.0, 0.0)
    for name, s, e in host[:bisect.bisect_left(starts, b)]:
        ov = min(e, b) - max(s, a)
        if ov > 0 and (ov, s - e) > key:
            best, key = name, (ov, s - e)
    return best


@dataclass
class Trace:
    """A traced window: device intervals (name, start, end) and top-level
    host events (name, start, end), in seconds on one clock, the window's
    bounds, and the host waits counted.  ``device_ids`` holds the
    correlation id of each ``device`` entry (None where the trace gives
    none), ``host_threads`` the thread of each ``host`` entry, and
    ``calls`` {correlation id: (thread, start)} of the CUDA runtime and
    driver calls that carry an id."""

    window: tuple
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    host_waits: int = 0
    device_ids: list = field(default_factory=list)
    host_threads: list = field(default_factory=list)
    calls: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> list:
        lo, hi = self.window
        return union(clip([(s, e) for _, s, e in self.device], lo, hi))

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of `names`."""
        lo, hi = self.window
        mine = [(s, e) for n, s, e in self.device
                if any(k in n for k in names)]
        return sum(e - s for s, e in clip(mine, lo, hi))

    def device_ops(self, top: int = TOP) -> list:
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n[:NAME_CHARS]] += e - s
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = TOP) -> list:
        lo, hi = self.window
        longest = sorted(gaps(self.busy(), lo, hi),
                         key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        return [[name_gap(g, host)[:NAME_CHARS], g[1] - g[0]]
                for g in longest]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def from_events(events) -> Trace:
    """A Trace of a Chrome-format trace's events (torch.profiler's
    ``export_chrome_trace``), over its ``benchmark.window`` range: device
    intervals are kernels, copies and sets (not the device-side copies of
    host ranges), host events are operators and CUDA runtime and driver
    calls; correlation ids and threads are kept beside them."""
    window, device, host, waits = None, [], [], 0
    device_ids, host_threads, calls = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"]) * 1e-6
        t = s + float(e.get("dur", 0.0)) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((name, s, t))
            device_ids.append(corr)
            if cat == "gpu_memcpy" and "DtoH" in name and \
                    "Pinned" not in name:
                waits += 1
        elif cat in HOST_CATS:
            host.append((name, s, t))
            host_threads.append(e.get("tid"))
            if corr is not None and cat != "cpu_op":
                calls[corr] = (e.get("tid"), s)
            if name in SYNC_CALLS:
                waits += 1
        elif cat == "user_annotation" and name == WINDOW:
            window = (s, t)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    return Trace(window=window, device=device, host=host, host_waits=waits,
                 device_ids=device_ids, host_threads=host_threads,
                 calls=calls)


def collect(prof, path: str) -> Trace:
    """A Trace of the profiler `prof`, through its Chrome trace written
    to `path` (deleted after it is read)."""
    import json
    import os

    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return from_events(events)
