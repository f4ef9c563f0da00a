"""Tracing / profiling subsystem.

The reference has none (SURVEY.md section 5.1: wall-clock via Dates.now
only); this provides per-phase timers so pushes/sec is a first-class
metric of every run, and the port's spans: named ranges ("mcs." + a
name) that a torch profiler records on its own clock, beside the
device's kernels and copies, so that a trace can put each stretch of
device time, or of device idle, down to what the program was doing.
A span is recorded as a host operator (the profiler's ``cpu_op``
events, torch's own ``aten::`` operators and the CUDA calls they make
among them), not as a user annotation: a reader of the trace's host
operators sees the spans without reading anything more.

The spans nest on the main thread, and the nesting is the parent link:

* ``mcs.run``: one ``engine.driver.run``;
* ``mcs.setup``, ``mcs.transport``, ``mcs.reductions``,
  ``mcs.smoothing``, ``mcs.emission``, ``mcs.checkpoint``, ``mcs.io``:
  the driver's phases (``PhaseTimers.phase``);
* ``mcs.reductions.wait``: the main thread blocked on the worker
  thread's host reductions;
* ``mcs.transport.electrons``: an electron species' whole transport
  (engine/run.py ``run_ion``), inside ``mcs.transport``;
* ``mcs.transport.pop_setup``, ``mcs.transport.ladder``,
  ``mcs.transport.tally_fetch``: a species' population build, pcut
  ladder and tally reads (engine/run.py ``run_ion``);
* ``mcs.emission.synch``, ``mcs.emission.ic``, ``mcs.emission.pion``:
  inside ``mcs.emission``, each process's spectra of every zone on the
  device (models/emission/driver.py ``_grids_batched``);
  ``mcs.emission.sum``: the Doppler shift to the ISM frame, the shell
  sums and the merge (``photon_calcs``);
* ``mcs.ladder.segment``: one pcut segment's host enqueue (drain,
  finish, split), with ``mcs.finish`` (the exit bookkeeping) inside it;
* ``mcs.ladder.sync``: the ladder's blocking reads (ops/mega.py
  ``drive_ladder_async``).

A profiler records ranges only on the thread that is profiled, so the
worker thread's reductions carry no span: the main thread's wait for
them does.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the range ``"mcs." + name`` while
    a torch profiler is active on the calling thread; otherwise a shared
    no-op (one check, nothing made)."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast("mcs." + name)
    return _OFF


@dataclass
class PhaseTimers:
    """Accumulating wall-clock timers keyed by phase name; each phase is
    also the span of its name."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def report(self) -> dict:
        return {k: {"seconds": round(v, 4), "calls": self.counts[k]}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1])}

    def dump(self, path: str, extra: dict | None = None) -> None:
        out = {"phases": self.report()}
        if extra:
            out.update(extra)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
