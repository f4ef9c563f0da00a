"""examples/01 and examples/02, shrunk, and a read-old-profile restart
through both packages' drivers on the CPU, at float64 (the XLA engine in
both, on the same random streams).

Cuts, by text substitution, every shape of the configs kept (shock,
flow, field, grid, pcut ladder, injection, smoothing switches): 40
particles per pcut (200 and 400 shipped), 2 iterations of examples/02
(10 shipped), the helix cap 128 in every engine, and the PSD at 5
momentum bins a decade, 10 linear cosine bins and 1 log-theta decade
([10, 5], 30 and 2 shipped).

* examples/01 (1 iteration): pushes and trajectories exactly, the flux
  tallies to 1e-6 of their largest entry (float64 sums; the two
  packages' float32 cos of the scattering phase differ by an ulp on a
  few percent of steps, ROADMAP.md section 3), the output file sets
  equal.
* examples/02, the one shipped config with old-profile-weight = 4.0 and
  increase-old-profile-weighting = true (models/smoothing.py:256-258):
  iteration 1 as examples/01; the profile its smoothing returns (ux_sk,
  btot) within 1e-8 relative on every zone, and the weight factors the
  two smoothings use, 4.0 and then 4.0 x 1.15, to 1e-12.  The smoothing
  is a smooth function of the flux tallies (here within ~1e-10 of each
  other) and of the pressures of the dN/dp reductions, which the JAX
  package takes in float32 and the port in float64 (measured: ux_sk
  within 1.8e-10); 1e-8 leaves two decades of room.  Iteration 2 starts
  from profiles that differ in those digits, and a lane that meets a
  profile value one ulp apart can take another branch, after which its
  stream of uniforms diverges: so iteration 2 is held statistically,
  pushes and trajectories within 10% and the flux totals within 30% (40
  particles a pcut: Poisson noise of ~15% on a total).  Measured here:
  no lane diverged, and the counts of iteration 2 are equal.
* read-old-profile = true: the JAX run of examples/02 wrote mc_grid.dat;
  both drivers restart from it as mc_grid_old.dat (n_old_skip 0,
  n_old_profs 1, n_old_per_prof the grid size, as
  tests/test_aux_subsystems.py does), 1 iteration: the profiles they
  read agree exactly, and so do their float64 counts.
* MCS_I_APPROX (0, 1, 3, 7, unset, 2): both drivers' ion_finalize on the
  port's examples/01 tallies write the same dN/dp to 1e-10 relative
  (the JAX reduction at float64, tests/torch_jax_f64.py), and the mode
  moves them alike: unset and 2 give the same dN/dp as today, 0, 1 and
  3 another.
"""

import inspect
import os
import shutil
import tempfile
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.engine import driver as jdriver
from montecarloscattering_jl_tpu.engine import io as jio
from montecarloscattering_jl_tpu.engine import old_profile as jold
from montecarloscattering_jl_tpu.ops import fused_ion as jfused
from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu.ops import reduce as jred
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu.utils import load_config as jload
from montecarloscattering_jl_tpu_torch.engine import driver as tdriver
from montecarloscattering_jl_tpu_torch.engine import io as tio
from montecarloscattering_jl_tpu_torch.engine import old_profile as told
from montecarloscattering_jl_tpu_torch.ops import step as tstep
from montecarloscattering_jl_tpu_torch.utils import load_config

from torch_jax_f64 import ion_reduce_f64

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 128
N = 40
SHRINK = (
    ("N_PTS_INJ = {n}", f"N_PTS_INJ = {N}"),
    ("N_PTS_PCUT = {n}", f"N_PTS_PCUT = {N}"),
    ("N_PTS_PCUT_HI = {n}", f"N_PTS_PCUT_HI = {N}"),
    ("num-psd-bins-per-decade = [10, 5]", "num-psd-bins-per-decade = [5, 5]"),
    ("psd-linear-cosine-bins = 30", "psd-linear-cosine-bins = 10"),
    ("psd-log-theta-decs = 2", "psd-log-theta-decs = 1"),
)
EXAMPLES = {
    "01": ("01_test_particle.toml", 200, ()),
    "02": ("02_nonlinear_smoothed.toml", 400,
           (("num-iterations = 10", "num-iterations = 2"),)),
}
FLUXES = ("pxx_flux", "pxz_flux", "energy_flux")
MODES = (None, "2", "0", "1", "3", "7")


def _toml(d, name):
    fname, n, extra = EXAMPLES[name]
    text = open(os.path.join(ROOT, "examples", fname)).read()
    for old, new in tuple((a.format(n=n), b) for a, b in SHRINK) + extra:
        assert old in text, old
        text = text.replace(old, new)
    path = os.path.join(d, f"ex{name}.toml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _clear_jax_caches():
    stp.run_segment_jit.clear_cache()
    stp.run_segment_hjit.clear_cache()
    jfused.run_ion_fused_jit.clear_cache()
    jfused._XLA_HYBRID_CACHE.clear()
    ps._HYBRID_CACHE.clear()


def _spy(mp, mod, name, calls):
    """Record every call of mod.name: ({parameter: argument}, result)."""
    fn = getattr(mod, name)
    sig = inspect.signature(fn)

    def spy(*args, **kw):
        out = fn(*args, **kw)
        calls.append((sig.bind(*args, **kw).arguments, out))
        return out

    mp.setattr(mod, name, spy)


def _both(path, out_j, out_t, mp):
    """One run of `path` through each driver; returns (jax result, port
    result, {package: smooth_grid calls})."""
    calls = {"jax": [], "torch": []}
    _spy(mp, jdriver, "smooth_grid", calls["jax"])
    _spy(mp, tdriver, "smooth_grid", calls["torch"])
    ref = jdriver.run(jload(path), out_dir=out_j, p_dtype=jnp.float64)
    got = tdriver.run(load_config(path), "cpu", out_dir=out_t)
    return ref, got, calls


@pytest.fixture(scope="module")
def runs():
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tempfile.mkdtemp(prefix="mcs_examples_")
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            for mod in (stp, tstep):
                mp.setattr(mod, "MAX_HELIX_STEPS", CAP)
            # the cap is a trace-time constant of the JAX segment: trace
            # anew once, then every run here shares the traces
            _clear_jax_caches()
            for name in EXAMPLES:
                dirs = [os.path.join(d, f"{p}_{name}") for p in ("jax",
                                                                  "torch")]
                with pytest.MonkeyPatch.context() as mp2:
                    ref, got, calls = _both(_toml(d, name), *dirs, mp2)
                out[name] = dict(ref=ref, got=got, calls=calls,
                                 files=[sorted(os.listdir(x))
                                        for x in dirs])
            # the restart from the JAX run's mc_grid.dat
            rd = os.path.join(d, "restart")
            os.makedirs(rd)
            shutil.copy(os.path.join(d, "jax_02", "mc_grid.dat"),
                        os.path.join(rd, "mc_grid_old.dat"))
            reads = {"jax": [], "torch": []}
            with pytest.MonkeyPatch.context() as mp2:
                mp2.chdir(rd)
                _spy(mp2, jold, "read_old_profile", reads["jax"])
                _spy(mp2, told, "read_old_profile", reads["torch"])
                path = _toml(d, "02")
                res = {}
                for key, load, drive in (
                        ("jax", jload,
                         lambda c: jdriver.run(c, p_dtype=jnp.float64)),
                        ("torch", load_config,
                         lambda c: tdriver.run(c, "cpu"))):
                    cfg = load(path)
                    cfg.n_itrs = 1
                    cfg.do_old_prof = True
                    cfg.n_old_skip = 0
                    cfg.n_old_profs = 1
                    cfg.n_old_per_prof = out["02"]["ref"].setup.n_grid
                    res[key] = drive(cfg)
            out["restart"] = dict(res, reads=reads)
        _clear_jax_caches()
    finally:
        torch.set_num_threads(n_thr)
        shutil.rmtree(d, ignore_errors=True)
    return out


def _it(res, i=0):
    return res.iterations[i]


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_iteration1_counts_exact(runs, name):
    ref, got = runs[name]["ref"], runs[name]["got"]
    for fr, fg in zip(_it(ref).ion_finals, _it(got).ion_finals):
        assert fg.n_pushes == fr.n_pushes > 10 * N
        assert fg.n_trajectories == fr.n_trajectories
    if name == "01":
        assert got.n_pushes == ref.n_pushes


@pytest.mark.parametrize("field", FLUXES)
@pytest.mark.parametrize("name", list(EXAMPLES))
def test_iteration1_fluxes(runs, name, field):
    ref, got = runs[name]["ref"], runs[name]["got"]
    a = np.asarray(getattr(_it(ref).tallies, field), np.float64)
    b = np.asarray(getattr(_it(got).tallies, field), np.float64)
    assert a.shape == b.shape and np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_output_file_sets(runs, name):
    files_j, files_t = runs[name]["files"]
    assert files_t == files_j
    assert "mc_grid.dat" in files_t and "mc_dNdp_grid_CR.dat" in files_t


@pytest.mark.parametrize("field", ["ux_sk", "btot"])
def test_smoothed_profile_after_iteration1(runs, field):
    r = runs["02"]
    calls_j, calls_t = r["calls"]["jax"], r["calls"]["torch"]
    assert len(calls_j) == len(calls_t) == 2
    a = np.asarray(getattr(calls_j[0][1][0], field), np.float64)
    b = np.asarray(getattr(calls_t[0][1][0], field), np.float64)
    before = np.asarray(getattr(calls_t[0][0]["prof"], field), np.float64)
    sl = slice(1, len(a) - 1)
    np.testing.assert_allclose(b[sl], a[sl], rtol=1e-8)
    if field == "ux_sk":            # it smoothed (the field is uniform)
        assert not np.allclose(b[sl], before[sl], rtol=1e-6)


def test_profile_weight_factor(runs):
    """The factor each smoothing uses and returns: 4.0 at the first, 4.0
    x 1.15 at the second (increase-old-profile-weighting)."""
    r = runs["02"]
    for calls in (r["calls"]["jax"], r["calls"]["torch"]):
        used = [c[0]["prof_weight_fac"] for c in calls]
        returned = [c[1][2] for c in calls]
        np.testing.assert_allclose(used, [4.0, 4.0], rtol=1e-12)
        np.testing.assert_allclose(returned, [4.0, 4.0 * 1.15], rtol=1e-12)


def test_iteration2_statistics(runs):
    ref, got = runs["02"]["ref"], runs["02"]["got"]
    fr, fg = _it(ref, 1).ion_finals[0], _it(got, 1).ion_finals[0]
    assert fg.n_pushes == pytest.approx(fr.n_pushes, rel=0.1)
    assert fg.n_trajectories == pytest.approx(fr.n_trajectories, rel=0.1)
    for f in FLUXES:
        a = float(np.sum(getattr(_it(ref, 1).tallies, f)))
        b = float(np.sum(getattr(_it(got, 1).tallies, f)))
        assert a != 0 and b == pytest.approx(a, rel=0.3), f


@pytest.mark.parametrize("field", ["ux_sk", "btot", "gamma_sf", "uz_sk"])
def test_read_old_profile_exact(runs, field):
    reads = runs["restart"]["reads"]
    assert len(reads["jax"]) == len(reads["torch"]) == 1
    a = np.asarray(getattr(reads["jax"][0][1], field))
    b = np.asarray(getattr(reads["torch"][0][1], field))
    np.testing.assert_array_equal(b, a)


def test_read_old_profile_counts_exact(runs):
    r = runs["restart"]
    ref, got = r["jax"], r["torch"]
    assert got.n_pushes == ref.n_pushes > 10 * N
    assert got.n_trajectories == ref.n_trajectories
    # the restart ran from the smoothed profile, not the fresh one
    fresh = _it(runs["02"]["got"]).ion_finals[0].n_pushes
    assert got.n_pushes != fresh


def _finalize_both(runs, mp, mode):
    """Both drivers' ion_finalize on the port's examples/01 tallies under
    MCS_I_APPROX = mode, the JAX reduction at float64."""
    if mode is None:
        mp.delenv("MCS_I_APPROX", raising=False)
    else:
        mp.setenv("MCS_I_APPROX", mode)
    mp.setattr(jred, "ion_reduce_device", ion_reduce_f64)
    ref, got = runs["01"]["ref"], runs["01"]["got"]
    fi = _it(got).ion_finals[0]
    res = types.SimpleNamespace(
        psd=fi.psd, therm_psd=fi.therm_psd, num_crossings=fi.num_crossings,
        esc=fi.esc, spectra_sf=fi.spectra_sf, spectra_pf=fi.spectra_pf,
        n_pushes=fi.n_pushes, n_trajectories=fi.n_trajectories,
        n_new=fi.n_new, splits=fi.splits, reason_counts=fi.reason_counts,
        retro_entries=fi.retro_entries,
        energy_received=fi.energy_received,
        energy_radiated=fi.energy_radiated)
    a = jdriver.ion_finalize(ref.setup, res, ref.setup.profile, 0, True)
    res.psd = torch.from_numpy(fi.psd)
    res.therm_psd = torch.from_numpy(fi.therm_psd)
    b = tdriver.ion_finalize(got.setup, res, got.setup.profile, 0, True)
    return a, b


def _written(io, setup, fin, d):
    """{file: its lines as token lists} of io.write_dndp on one ion."""
    io.write_dndp(types.SimpleNamespace(
        setup=setup, iterations=[types.SimpleNamespace(ion_finals=[fin])]),
        d)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = [ln.split() for ln in f.read().splitlines()]
    return out


def _same_tokens(got, want, rtol):
    """Token lists equal, numbers to rtol (the files print 6 digits)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for x, y in zip(g, w):
            try:
                assert float(x) == pytest.approx(float(y), rel=rtol), (g, w)
            except ValueError:
                assert x == y, (g, w)


@pytest.fixture(scope="module")
def finals(runs):
    """{mode: (JAX IonFinal, port IonFinal)} of _finalize_both."""
    out = {}
    for mode in MODES:
        with pytest.MonkeyPatch.context() as mp:
            out[mode] = _finalize_both(runs, mp, mode)
    return out


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m or "unset")
def test_driver_dndp_under_mcs_i_approx(runs, finals, mode):
    a, b = finals[mode]
    b2 = finals["2"][1]
    for field in ("dndp_cr", "dndp_therm"):
        x = np.asarray(getattr(a, field))
        y = np.asarray(getattr(b, field))
        assert np.abs(x).max() > 0
        np.testing.assert_allclose(y, x, rtol=1e-10,
                                   atol=1e-10 * np.abs(x).max(),
                                   err_msg=field)
        moved = not np.array_equal(y, np.asarray(getattr(b2, field)))
        assert moved == (mode not in (None, "2", "7")), field
    setup_j, setup_t = runs["01"]["ref"].setup, runs["01"]["got"].setup
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        fj = _written(jio, setup_j, a, dj)
        ft = _written(tio, setup_t, b, dt)
    assert sorted(fj) == sorted(ft) == ["mc_dNdp_grid_CR.dat",
                                        "mc_dNdp_grid_therm.dat"]
    for name in fj:
        _same_tokens(ft[name], fj[name], 1e-5)
