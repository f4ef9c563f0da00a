"""The port's spans (utils/tracing.py ``span``) on the CPU.

``engine.driver.run`` on examples/03 shrunk as in tests/test_torch_overlap.py
(two species with energy transfer, so that the ions' reductions overlap
the electrons' transport; 40 particles a pcut, the first 4 pcuts, the
helix cap 32), under torch.profiler, with an output directory and an
iteration checkpoint: K1's twin on the fused ladder (photons on), K1's
twin on the host-split ladder, and the XLA engine on the fused ladder.

* Every span of the table in utils/tracing.py is in the Chrome trace,
  on the main thread, nested under the span it belongs to (an electron
  species' population, ladder and tally reads under
  ``mcs.transport.electrons``, the emission's processes and sum under
  ``mcs.emission``); one ``mcs.ladder.segment`` and one ``mcs.finish``
  a segment drained.
* The species' pushes (each iteration's ``ion_finals[i].n_pushes``)
  sum to ``RunResult.n_pushes``.
* The driver's phases and the spans under ``mcs.run`` have one set of
  names, and ``RunResult.timers.totals`` keeps its keys.
* With no profiler, no range is made (the profiler's range types
  patched to raise), and the run gives the profiled run's bits.
"""

import dataclasses
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from montecarloscattering_jl_tpu_torch.engine.driver import run
from montecarloscattering_jl_tpu_torch.ops import mega
from montecarloscattering_jl_tpu_torch.ops import step as tstep
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl
from montecarloscattering_jl_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 32
N = 40
SHRINK = (("N_PTS_INJ = 50", f"N_PTS_INJ = {N}"),
          ("N_PTS_PCUT = 100", f"N_PTS_PCUT = {N}"),
          ("N_PTS_PCUT_HI = 100", f"N_PTS_PCUT_HI = {N}"),
          ("num-psd-bins-per-decade = [10, 5]",
           "num-psd-bins-per-decade = [5, 5]"),
          ("psd-linear-cosine-bins = 30", "psd-linear-cosine-bins = 10"),
          ("psd-log-theta-decs = 2", "psd-log-theta-decs = 1"),
          ("energy-transfer-frac = 0.0", "energy-transfer-frac = 0.1"))
NO_PHOTONS = (("calculate-photon-production = true",
               "calculate-photon-production = false"),)
# case: (momentum dtype, fused, photons)
CASES = {"k1-fused": (torch.float32, True, True),
         "k1-host": (torch.float32, False, False),
         "xla-fused": (torch.float64, True, False)}
# each span's parent
PARENT = {"mcs.run": None,
          **{"mcs." + p: "mcs.run" for p in (
              "setup", "transport", "reductions", "smoothing", "emission",
              "checkpoint", "io")},
          "mcs.reductions.wait": "mcs.reductions",
          "mcs.transport.electrons": "mcs.transport",
          "mcs.transport.pop_setup": "mcs.transport",
          "mcs.transport.ladder": "mcs.transport",
          "mcs.transport.tally_fetch": "mcs.transport",
          "mcs.ladder.segment": "mcs.transport.ladder",
          "mcs.ladder.sync": "mcs.transport.ladder",
          "mcs.finish": "mcs.ladder.segment",
          **{"mcs.emission." + p: "mcs.emission" for p in (
              "synch", "ic", "pion", "sum")}}
# an electron species' transport spans nest in mcs.transport.electrons
ELECTRONS = {"mcs.transport.pop_setup", "mcs.transport.ladder",
             "mcs.transport.tally_fetch"}
EMISSION = {s for s in PARENT if s.startswith("mcs.emission")}
PHASES = {"setup", "transport", "reductions", "smoothing", "io",
          "checkpoint"}


def _run(case, out_dir):
    p_dtype, fused, photons = CASES[case]
    cfg = wl.load_variant(
        os.path.join(ROOT, "examples", "03_electron_synch_ic.toml"),
        SHRINK + (() if photons else NO_PHOTONS))
    cfg.pcuts = cfg.pcuts[:4]
    return run(cfg, "cpu", p_dtype=p_dtype, out_dir=out_dir, fused=fused,
               checkpoint=os.path.join(out_dir, "ck.npz"))


def _spans(prof, path):
    """The trace's ``mcs.*`` ranges, host operators, as (name, start,
    end, tid)."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["tid"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "cpu_op"
            and e["name"].startswith("mcs.")]


def _refuse_ranges(mp):
    """Every way torch makes a profiler range raises."""
    def refuse(*a, **kw):
        raise AssertionError("a profiler range without a profiler")
    mp.setattr(torch.profiler, "record_function", refuse)
    mp.setattr(torch.autograd.profiler, "record_function", refuse)
    mp.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)


def _parent(sp, spans):
    """The innermost other span of `sp`'s thread around `sp`."""
    name, s, e, tid = sp
    around = [o for o in spans if o is not sp and o[3] == tid
              and o[1] <= s and e <= o[2]]
    if not around:
        return None
    # the innermost: the latest start, then the earliest end; of two
    # with one interval (a span and its only child at the clock's
    # resolution), the one the table makes the parent
    best = max(around, key=lambda o: (o[1], -o[2]))
    same = [o for o in around if (o[1], o[2]) == (best[1], best[2])]
    return (PARENT[name] if any(o[0] == PARENT[name] for o in same)
            else best[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (the profiled run's result, its spans, its drains, the
    unprofiled run's result)}."""
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            for mod in (tstep, mega):
                mp.setattr(mod, "MAX_HELIX_STEPS", CAP)
            drains = []
            for mod, name in ((mega, "drain"), (tstep, "run_segment")):
                fn = getattr(mod, name)

                def spy(*a, _fn=fn, **kw):
                    drains.append(1)
                    return _fn(*a, **kw)
                mp.setattr(mod, name, spy)
            for case in CASES:
                d = str(tmp_path_factory.mktemp(case))
                drains.clear()
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    res = _run(case, d)
                n_drains = len(drains)
                spans = _spans(prof, os.path.join(d, "t.json"))

                with pytest.MonkeyPatch.context() as off:
                    _refuse_ranges(off)
                    plain = _run(case, d)
                out[case] = (res, spans, n_drains, plain)
    finally:
        torch.set_num_threads(n_thr)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest(runs, case):
    _, spans, _, _ = runs[case]
    _, fused, photons = CASES[case]
    want = set(PARENT)
    if not fused:
        want.discard("mcs.ladder.sync")     # no drive_ladder_async
    if not photons:
        want -= EMISSION
    assert {s[0] for s in spans} == want
    # the main thread's alone: the reductions' worker records none
    assert len({s[3] for s in spans}) == 1
    electrons = [s for s in spans if s[0] == "mcs.transport.electrons"]
    for sp in spans:
        inside = any(e[1] <= sp[1] and sp[2] <= e[2] for e in electrons)
        want_parent = ("mcs.transport.electrons"
                       if sp[0] in ELECTRONS and inside else PARENT[sp[0]])
        assert _parent(sp, spans) == want_parent, sp
    n = Counter(s[0] for s in spans)
    assert n["mcs.run"] == 1
    assert n["mcs.transport"] == n["mcs.transport.ladder"] == 2
    # the second species, the electrons: their population, ladder and
    # tally reads inside the span
    assert n["mcs.transport.electrons"] == 1
    assert sum(1 for s in spans if s[0] in ELECTRONS and any(
        e[1] <= s[1] and s[2] <= e[2] for e in electrons)) == 3
    assert n["mcs.reductions.wait"] == 1
    if photons:
        # one species of each kind: each process once, one sum
        assert all(n[s] == 1 for s in EMISSION)


@pytest.mark.parametrize("case", list(CASES))
def test_a_segment_span_and_a_finish_span_per_drain(runs, case):
    _, spans, n_drains, _ = runs[case]
    n = Counter(s[0] for s in spans)
    assert n_drains >= 2
    assert n["mcs.ladder.segment"] == n["mcs.finish"] == n_drains
    for seg in (s for s in spans if s[0] == "mcs.ladder.segment"):
        inside = [f for f in spans if f[0] == "mcs.finish"
                  and seg[1] <= f[1] and f[2] <= seg[2]]
        assert len(inside) == 1


@pytest.mark.parametrize("case", list(CASES))
def test_phases_keep_their_keys(runs, case):
    res, spans, _, plain = runs[case]
    phases = PHASES | ({"emission"} if CASES[case][2] else set())
    assert set(res.timers.totals) == set(plain.timers.totals) == phases
    assert {s[0][4:] for s in spans if PARENT[s[0]] == "mcs.run"} == phases


@pytest.mark.parametrize("case", list(CASES))
def test_species_pushes_sum_to_the_pushes(runs, case):
    res, _, _, plain = runs[case]
    by_species = [sum(it.ion_finals[i].n_pushes for it in res.iterations)
                  for i in range(2)]
    assert all(p > 0 for p in by_species)
    assert sum(by_species) == res.n_pushes
    assert by_species == [
        sum(it.ion_finals[i].n_pushes for it in plain.iterations)
        for i in range(2)]


@pytest.mark.parametrize("case", list(CASES))
def test_same_bits_without_a_profiler(runs, case):
    res, _, _, plain = runs[case]
    assert res.n_pushes == plain.n_pushes > 0
    assert res.n_trajectories == plain.n_trajectories
    for it0, it1 in zip(res.iterations, plain.iterations):
        for f0, f1 in zip(it0.ion_finals, it1.ion_finals):
            for f in ("psd", "therm_psd", "dndp_cr", "dndp_therm",
                      "p_psd_par", "num_crossings"):
                assert np.array_equal(getattr(f0, f), getattr(f1, f)), f
            for g in dataclasses.fields(f0.esc):
                assert np.array_equal(getattr(f0.esc, g.name),
                                      getattr(f1.esc, g.name)), g.name
        assert it0.gamma_downstream == it1.gamma_downstream
        for f in dataclasses.fields(it0.diag):
            assert np.array_equal(getattr(it0.diag, f.name),
                                  getattr(it1.diag, f.name)), f.name


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    _refuse_ranges(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("run"), tracing.span("ladder.sync")
    assert a is b
    for name in ("transport.electrons", "emission.synch", "emission.ic",
                 "emission.pion", "emission.sum"):
        assert tracing.span(name) is a
    with a:
        pass
    timers = tracing.PhaseTimers()
    with timers.phase("io"):
        pass
    assert dict(timers.counts) == {"io": 1}


def test_span_opens_a_range_under_a_profiler(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ladder.segment"):
            torch.ones(3).sum()
    spans = _spans(prof, str(tmp_path / "t.json"))
    assert [s[0] for s in spans] == ["mcs.ladder.segment"]
