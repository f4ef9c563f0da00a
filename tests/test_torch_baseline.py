"""configs/baseline.toml, shrunk, through both packages' drivers on the
CPU, on both of the port's engines.

The shipped baseline (no-scatter, no-DSA, injection one r_g0 upstream)
is inert at any helix cap a CPU test can afford: no lane reaches the
shock in 10,000 steps.  So the run takes the science variant's switches
and is cut to size, every shape of the config kept:
* scattering and DSA on, the geometric pcut ladder at 4 a decade
  (scripts/flagship_baseline.py --dsa --pcuts-per-decade 4), cut to its
  first 12 pcuts, and 1 iteration;
* the fast-push injection stops 1e-4 r_g0 upstream (1 r_g0 shipped), so
  that lanes meet the shock at once, and 64 particles per pcut;
* the tcuts scaled by 1e-5 (the last kept 10x above the age limit), so
  that the acceleration times of a 1,000-step cap cross some of them;
* the PSD at 5 bins a decade, 29 cosine bins and 2 log-theta decades
  (the full 55,040-cell table's reductions take ~40 s a species on one
  CPU thread);
* the helix cap 1,000 in every engine.

Float64 runs the XLA engine in both packages on the same random
streams: push and trajectory counts agree exactly, the coupled weights
and spectra, the ions' pool and the flux tallies to 1e-6 of their
largest entry.  Float32 runs K1's twin in the port and the XLA step at
float32 in the JAX package (the megakernel needs a TPU), on different
streams: trajectories and pushes within 10%, the coupled weight within
30% (a few tens of lanes cross a tcut), the flux totals within 30%.
The port's two engines agree on the exit-reason counts within Poisson
noise (6 sigma).  Both write the coupled CSVs, column for column alike.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.engine import driver as jdriver
from montecarloscattering_jl_tpu.ops import fused_ion as jfused
from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu.utils import load_config as jload
from montecarloscattering_jl_tpu.utils.config import (
    auto_pcut_ladder as jladder)
from montecarloscattering_jl_tpu_torch.engine.driver import run
from montecarloscattering_jl_tpu_torch.ops import mega
from montecarloscattering_jl_tpu_torch.ops import step as tstep
from montecarloscattering_jl_tpu_torch.utils import load_config
from montecarloscattering_jl_tpu_torch.utils.config import auto_pcut_ladder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 1000
N = 64
N_PCUTS = 12
SHRINK = (
    ("num-iterations = 20", "num-iterations = 1"),
    ("no-scatter = true", "no-scatter = false"),
    ("no-DSA = true", "no-DSA = false"),
    ("proton-fast-transport-stop = -1.0",
     "proton-fast-transport-stop = -1e-4"),
    ("N_PTS_INJ = 100", f"N_PTS_INJ = {N}"),
    ("N_PTS_PCUT = 400", f"N_PTS_PCUT = {N}"),
    ("N_PTS_PCUT_HI = 2000", f"N_PTS_PCUT_HI = {N}"),
    ("TCUTS = [ 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11, 3e13 ]",
     "TCUTS = [ 1e-2, 1e-1, 1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 3e13 ]"),
    ("num-psd-bins-per-decade = [10, 10]",
     "num-psd-bins-per-decade = [5, 5]"),
    ("psd-linear-cosine-bins = 119", "psd-linear-cosine-bins = 29"),
    ("psd-log-theta-decs = 4", "psd-log-theta-decs = 2"),
)
FLUXES = ("pxx_flux", "pxz_flux", "energy_flux")


def _toml(d):
    text = open(os.path.join(ROOT, "configs", "baseline.toml")).read()
    for old, new in SHRINK:
        assert old in text, old
        text = text.replace(old, new)
    path = os.path.join(d, "baseline_shrunk.toml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _cfg(load, ladder, path):
    cfg = load(path)
    cfg.pcuts = ladder(cfg.pcuts[0], 4, cfg.emax, cfg.emax_per_aa,
                       cfg.pmax)[:N_PCUTS]
    return cfg


def _clear_jax_caches():
    stp.run_segment_jit.clear_cache()
    stp.run_segment_hjit.clear_cache()
    jfused.run_ion_fused_jit.clear_cache()
    jfused._XLA_HYBRID_CACHE.clear()
    ps._HYBRID_CACHE.clear()


@pytest.fixture(scope="module")
def runs():
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    with tempfile.TemporaryDirectory() as d, pytest.MonkeyPatch.context() \
            as mp:
        path = _toml(d)
        for mod in (stp, tstep, mega):
            mp.setattr(mod, "MAX_HELIX_STEPS", CAP)
        for dt in ("float64", "float32"):
            _clear_jax_caches()
            jd = os.path.join(d, f"jax_{dt}")
            td = os.path.join(d, f"torch_{dt}")
            ref = jdriver.run(_cfg(jload, jladder, path), out_dir=jd,
                              p_dtype=getattr(jnp, dt))
            got = run(_cfg(load_config, auto_pcut_ladder, path), "cpu",
                      out_dir=td, p_dtype=getattr(torch, dt))
            csv = {k: [_rows(os.path.join(dd, f"mc_coupled_{n}.csv"))
                       for n in ("weights", "spectra")]
                   for k, dd in (("jax", jd), ("torch", td))}
            out[dt] = (ref, got, sorted(os.listdir(jd)),
                       sorted(os.listdir(td)), csv)
        _clear_jax_caches()
    torch.set_num_threads(n_thr)
    return out


def _rows(path):
    with open(path) as f:
        return [ln.split(",") for ln in f.read().splitlines()]


def _it(res):
    return res.iterations[0]


def test_coupled_csvs_match_jax_writer(runs):
    """mc_coupled_weights.csv and mc_coupled_spectra.csv, float64: the
    same header, rows and key columns as the JAX package's, the values
    (printed to 7 digits) to 1e-5."""
    csv = runs["float64"][4]
    for ref, got in zip(csv["jax"], csv["torch"]):
        assert got[0] == ref[0]
        assert len(got) == len(ref) > 1
        for r, g in zip(ref[1:], got[1:]):
            assert g[:-1] == r[:-1]
            assert float(g[-1]) == pytest.approx(float(r[-1]), rel=1e-5)


def test_float64_counts_exact(runs):
    ref, got, files_j, files_t, _ = runs["float64"]
    assert got.n_pushes == ref.n_pushes > 10 * N
    assert got.n_trajectories == ref.n_trajectories
    assert "mc_coupled_weights.csv" in files_t
    assert files_t == files_j


@pytest.mark.parametrize("field", ("weight_coupled", "spectra_coupled",
                                   "energy_pool") + FLUXES)
def test_float64_tallies(runs, field):
    ref, got, _, _, _ = runs["float64"]
    a = np.asarray(getattr(_it(ref).tallies, field), np.float64)
    b = np.asarray(getattr(_it(got).tallies, field), np.float64)
    assert a.shape == b.shape
    assert np.abs(a).max() > 0, field
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())


def test_float32_statistics(runs):
    ref, got, files_j, files_t, _ = runs["float32"]
    assert files_t == files_j
    assert got.n_trajectories == pytest.approx(ref.n_trajectories, rel=0.1)
    assert got.n_pushes == pytest.approx(ref.n_pushes, rel=0.1)
    a = float(np.sum(_it(ref).tallies.weight_coupled))
    b = float(np.sum(_it(got).tallies.weight_coupled))
    assert a > 0 and b == pytest.approx(a, rel=0.3)
    for f in FLUXES:
        a = float(np.sum(getattr(_it(ref).tallies, f)))
        b = float(np.sum(getattr(_it(got).tallies, f)))
        assert b == pytest.approx(a, rel=0.3), f


def test_reason_counts_across_engines(runs):
    """Exits by reason (downstream, pmax/FEB, age, radiated) of the
    port's f64 XLA engine and its f32 K1 path, per species."""
    for f64, f32 in zip(_it(runs["float64"][1]).ion_finals,
                        _it(runs["float32"][1]).ion_finals):
        a, b = f64.reason_counts[1:], f32.reason_counts[1:]
        assert np.all(np.abs(a - b) <= 6 * np.sqrt(np.maximum(a, 4))), (a, b)
    assert _it(runs["float64"][1]).ion_finals[0].reason_counts[1] > 0
