"""Tracing / profiling subsystem.

The reference has none (SURVEY.md section 5.1: wall-clock via Dates.now
only); this provides per-phase timers so pushes/sec is a first-class
metric of every run.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class PhaseTimers:
    """Accumulating wall-clock timers keyed by phase name."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def phase(self, name: str):
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

