"""examples/04_hadronic_sed.toml, shrunk, from config to photon files
through both packages' drivers on the CPU at float64.

Cut to size with every shape of the config kept (gamma0 = 5, protons
and electrons, radiative losses, the 9 pcuts, photons on, 1 iteration):
48 particles injected and at every pcut, and the helix cap at 300 in
both XLA engines.

* The emission pass alone: the port's ``photon_calcs`` fed the JAX
  run's ``ion_finals`` (NumPy arrays) and the port's own setup gives the
  JAX run's ``EmissionResult`` field for field at rtol 1e-8 on every
  bin above 1e-90, so that transport statistics do not enter (the two
  differ by the rounding of hypot, exp, log and the matmuls' summation
  order); its per-zone NumPy body, the oracle, gives it at the JAX
  package's own bound between its two bodies, rtol 1e-5.  The same with
  ``calculate-ssc`` on.
* End to end: both runs draw the same float64 random streams, so push
  and trajectory counts agree exactly at this cap; the SEDs have the
  same nonzero bins and each process's shell total agrees within 1%
  (lanes of the two packages differ by ~1e-7 of |p| a step, ROADMAP.md
  section 3, which moves a crossing between neighbouring PSD bins).
* The photon files of both runs exist, with the same header and the
  same numbers of rows and columns.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.engine import driver as jdriver
from montecarloscattering_jl_tpu.models.emission import driver as jem
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu.utils import load_config as jload
from montecarloscattering_jl_tpu_torch.engine.driver import run
from montecarloscattering_jl_tpu_torch.models.emission import (
    EmissionResult, photon_calcs)
from montecarloscattering_jl_tpu_torch.ops import step as tstep
from montecarloscattering_jl_tpu_torch.utils import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 300
N = 48
SHRINK = (("N_PTS_INJ = 50", f"N_PTS_INJ = {N}"),
          ("N_PTS_PCUT = 100", f"N_PTS_PCUT = {N}"),
          ("N_PTS_PCUT_HI = 100", f"N_PTS_PCUT_HI = {N}"))
GRIDS = ("pion_grid", "synch_grid", "ic_grid", "pion_shell", "synch_shell",
         "ic_shell", "tot_shell", "tot")
AXES = ("e_pion", "e_synch", "e_ic", "e_tot")
SSC = ("ssc_grid", "ssc_shell", "ic_shell", "tot")
PHOTON_FILES = ("photon_pion_decay_grid.dat", "photon_synch_grid.dat",
                "photon_IC_grid.dat", "photon_pion_summed.dat",
                "photon_synch_summed.dat", "photon_IC_summed.dat",
                "photon_tot.dat", "photon_tot_summed.dat")


@pytest.fixture(scope="module")
def runs():
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    text = open(os.path.join(ROOT, "examples",
                             "04_hadronic_sed.toml")).read()
    for old, new in SHRINK:
        assert old in text, old
        text = text.replace(old, new)
    hook_calls = []
    with tempfile.TemporaryDirectory() as d, pytest.MonkeyPatch.context() \
            as mp:
        path = os.path.join(d, "sed_shrunk.toml")
        with open(path, "w") as f:
            f.write(text)
        for mod in (stp, tstep):
            mp.setattr(mod, "MAX_HELIX_STEPS", CAP)
        stp.run_segment_jit.clear_cache()
        stp.run_segment_hjit.clear_cache()
        jd, td = os.path.join(d, "jax"), os.path.join(d, "torch")
        ref = jdriver.run(jload(path), out_dir=jd, p_dtype=jnp.float64)
        stp.run_segment_jit.clear_cache()
        stp.run_segment_hjit.clear_cache()
        got = run(load_config(path), "cpu", out_dir=td,
                  p_dtype=torch.float64,
                  emission_hook=lambda *a: hook_calls.append(a))
        files = {name: [_table(os.path.join(dd, name)) for dd in (jd, td)]
                 for name in PHOTON_FILES
                 if os.path.exists(os.path.join(jd, name))}
        listing = sorted(os.listdir(jd)), sorted(os.listdir(td))
    finals = ref.iterations[-1].ion_finals
    prof = got.setup.profile        # 1 iteration: the pass reads the first
    out = dict(ref=ref, got=got, files=files, listing=listing,
               hook_calls=hook_calls,
               fed=photon_calcs(got.setup, prof, finals, device="cpu"),
               fed_oracle=photon_calcs(got.setup, prof, finals, device=None))
    # the same pass with synchrotron self-Compton on, in both packages
    ssc = lambda s: dataclasses.replace(
        s, cfg=dataclasses.replace(s.cfg, do_ssc=True))
    out["ssc_ref"] = jem.photon_calcs(ssc(ref.setup), ref.setup.profile,
                                      finals)
    out["ssc"] = photon_calcs(ssc(got.setup), prof, finals, device="cpu")
    out["ssc_oracle"] = photon_calcs(ssc(got.setup), prof, finals,
                                     device=None)
    torch.set_num_threads(n_thr)
    return out


def _table(path):
    """(header lines, rows of float columns) of an output file."""
    head, rows = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                head.append(line.strip())
            elif line.strip():
                rows.append([float(v) for v in line.split()])
    return head, rows


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.maximum(got, 1e-90),
                               np.maximum(ref, 1e-90), rtol=rtol, atol=0.0)


def test_emission_is_not_empty(runs):
    em = runs["ref"].iterations[-1].emission
    assert isinstance(runs["got"].iterations[-1].emission, EmissionResult)
    for name in ("pion_shell", "synch_shell", "ic_shell"):
        assert np.asarray(getattr(em, name)).sum() > 1e-90, name
    assert (np.asarray(em.tot) > 0).sum() > 50


@pytest.mark.parametrize("field", AXES)
def test_photon_axes_exact(runs, field):
    ref = runs["ref"].iterations[-1].emission
    for key in ("fed", "fed_oracle"):
        np.testing.assert_array_equal(getattr(runs[key], field),
                                      getattr(ref, field))


@pytest.mark.parametrize("field", GRIDS)
def test_fed_jax_finals_matches_jax_emission(runs, field):
    ref = runs["ref"].iterations[-1].emission
    _close(getattr(runs["fed"], field), getattr(ref, field), 1e-8)


@pytest.mark.parametrize("field", GRIDS)
def test_per_zone_oracle_matches_jax_emission(runs, field):
    ref = runs["ref"].iterations[-1].emission
    _close(getattr(runs["fed_oracle"], field), getattr(ref, field), 1e-5)


@pytest.mark.parametrize("field", SSC)
def test_ssc_pass(runs, field):
    ref = getattr(runs["ssc_ref"], field)
    _close(getattr(runs["ssc"], field), ref, 1e-8)
    _close(getattr(runs["ssc_oracle"], field), ref, 1e-5)
    if field.startswith("ssc"):
        assert np.asarray(ref).max() > 1e-90
    assert runs["fed"].ssc_grid is None and runs["fed"].ssc_shell is None


def test_run_counts_and_hook(runs):
    ref, got = runs["ref"], runs["got"]
    assert got.n_pushes == ref.n_pushes > 0
    assert got.n_trajectories == ref.n_trajectories
    assert "emission" in got.timers.totals
    assert got.timers.counts["emission"] == 1
    (setup, prof, finals, i_iter), = runs["hook_calls"]
    assert setup is got.setup and i_iter == 0
    assert finals is got.iterations[0].ion_finals


@pytest.mark.parametrize("process", ["pion", "synch", "ic"])
def test_end_to_end_sed(runs, process):
    ref = runs["ref"].iterations[-1].emission
    got = runs["got"].iterations[-1].emission
    a = np.asarray(getattr(ref, process + "_shell"), np.float64)
    b = np.asarray(getattr(got, process + "_shell"), np.float64)
    np.testing.assert_array_equal(b > 1e-90, a > 1e-90)
    assert b.sum() == pytest.approx(a.sum(), rel=1e-2)
    np.testing.assert_array_equal(np.asarray(got.tot) > 0,
                                  np.asarray(ref.tot) > 0)


def test_output_listing(runs):
    jax_files, torch_files = runs["listing"]
    assert set(PHOTON_FILES) <= set(jax_files)
    assert torch_files == jax_files


@pytest.mark.parametrize("name", PHOTON_FILES)
def test_photon_files(runs, name):
    (jh, jrows), (th, trows) = runs["files"][name]
    assert th == jh and jh
    assert len(trows) == len(jrows) > 0
    assert [len(r) for r in trows] == [len(r) for r in jrows]
    assert np.isfinite(np.asarray(trows)).all()
