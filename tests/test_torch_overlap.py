"""The driver's overlapped per-species reductions and MCS_SUBTIMERS, on
the CPU.

* MCS_OVERLAP_REDUCE=1 (the default: species i's host reductions on a
  worker thread while species i+1 transports) against =0 (each species
  reduced before the next one starts), as the JAX package's
  tests/test_overlap_reduce.py holds its own: every IonFinal field, the
  smoothing's diagnostics and the downstream gamma, bit for bit.  On
  examples/03 with energy transfer (two species, so the ions' reduction
  overlaps the electrons' transport), shrunk as in
  tests/test_torch_checkpoint.py (40 particles a pcut, the first 4
  pcuts, the helix cap 128, a coarse PSD), on K1's twin at float32 and
  on the XLA engine at float64.  The host half must have run on the
  worker thread.
* MCS_SUBTIMERS=1 fills RunResult.subtimers with pop_setup, ladder and
  tally_fetch, which sum to no more than the transport phase; unset it
  is None.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from montecarloscattering_jl_tpu_torch.engine import driver as tdriver
from montecarloscattering_jl_tpu_torch.engine.driver import run
from montecarloscattering_jl_tpu_torch.ops import mega
from montecarloscattering_jl_tpu_torch.ops import step as tstep
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 128
N = 40
SHRINK = (("N_PTS_INJ = 50", f"N_PTS_INJ = {N}"),
          ("N_PTS_PCUT = 100", f"N_PTS_PCUT = {N}"),
          ("N_PTS_PCUT_HI = 100", f"N_PTS_PCUT_HI = {N}"),
          ("num-psd-bins-per-decade = [10, 5]",
           "num-psd-bins-per-decade = [5, 5]"),
          ("psd-linear-cosine-bins = 30", "psd-linear-cosine-bins = 10"),
          ("psd-log-theta-decs = 2", "psd-log-theta-decs = 1"),
          ("calculate-photon-production = true",
           "calculate-photon-production = false"),
          ("energy-transfer-frac = 0.0", "energy-transfer-frac = 0.1"))
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _run(p_dtype):
    cfg = wl.load_variant(
        os.path.join(ROOT, "examples", "03_electron_synch_ic.toml"), SHRINK)
    cfg.pcuts = cfg.pcuts[:4]
    return run(cfg, "cpu", p_dtype=p_dtype)


@pytest.fixture(scope="module")
def runs():
    """{(dtype, MCS_OVERLAP_REDUCE): (result, threads the host half ran
    on)}, and the subtimed run."""
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            for mod in (tstep, mega):
                mp.setattr(mod, "MAX_HELIX_STEPS", CAP)
            calls = []
            fn = tdriver.red.thermo_calcs

            def spy(*a, **kw):
                calls.append(threading.current_thread())
                return fn(*a, **kw)
            mp.setattr(tdriver.red, "thermo_calcs", spy)
            for name, pd in DTYPES.items():
                for flag in ("0", "1"):
                    mp.setenv("MCS_OVERLAP_REDUCE", flag)
                    calls.clear()
                    out[name, flag] = (_run(pd), list(calls))
            mp.setenv("MCS_SUBTIMERS", "1")
            out["subtimed"] = _run(torch.float32)
    finally:
        torch.set_num_threads(n_thr)
    return out


@pytest.mark.parametrize("name", list(DTYPES))
def test_overlap_bitwise(runs, name):
    (r0, _), (r1, _) = runs[name, "0"], runs[name, "1"]
    assert r0.n_pushes == r1.n_pushes > 0
    for it0, it1 in zip(r0.iterations, r1.iterations):
        assert len(it0.ion_finals) == len(it1.ion_finals) == 2
        for f0, f1 in zip(it0.ion_finals, it1.ion_finals):
            for f in dataclasses.fields(f0):
                a, b = getattr(f0, f.name), getattr(f1, f.name)
                if a is None:
                    assert b is None, f.name
                elif dataclasses.is_dataclass(a):
                    for g in dataclasses.fields(a):
                        assert np.array_equal(getattr(a, g.name),
                                              getattr(b, g.name)), g.name
                else:
                    assert np.array_equal(np.asarray(a), np.asarray(b),
                                          equal_nan=True), f.name
        assert it0.gamma_downstream == it1.gamma_downstream
        for f in dataclasses.fields(it0.diag):
            assert np.array_equal(getattr(it0.diag, f.name),
                                  getattr(it1.diag, f.name)), f.name


@pytest.mark.parametrize("name", list(DTYPES))
def test_overlap_runs_on_a_worker(runs, name):
    main = threading.main_thread()
    (_, serial), (_, overlapped) = runs[name, "0"], runs[name, "1"]
    assert len(serial) == len(overlapped) == 2
    assert all(t is main for t in serial)
    assert all(t is not main for t in overlapped)


def test_subtimers(runs):
    res = runs["subtimed"]
    sub = res.subtimers
    assert set(sub) == {"pop_setup", "ladder", "tally_fetch"}
    assert all(v > 0 for v in sub.values())
    assert sum(sub.values()) <= res.timers.totals["transport"]
    assert runs["f32", "1"][0].subtimers is None
