"""The XLA-engine slice end to end on the CPU, against the JAX package.

The flagship config (tests/data/dsa_nonrel.toml) with two x_spec
detectors at -/+0.5 r_g0, float64 momenta (both CLIs' default), 1
iteration, reduced to 150 particles per pcut and a 1,024-step helix cap
in both packages (the cap is patched in both engines' modules).  Both
packages draw the same random streams, so they agree far inside Monte
Carlo noise: push and trajectory counts exactly, the crossing counts
exactly, every float64 tally and the detector spectra to 1e-6 relative,
the float32 PSD to 1e-5 relative, the slope to 1e-4, and the slope
within 0.45 of -(3r/(r-1) - 2).  The output file set, mc_xspec.dat
included, and its columns match the JAX writer's.

Also here: the CLI's engine selection (float64 by default on the XLA
engine, K1 with --f32, x_spec configs on the XLA engine, a once-deferred
flag running on both against the JAX driver), and split_on_device at
float64.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarloscattering_jl_tpu.engine import driver as jdriver
from montecarloscattering_jl_tpu.engine import io as jio
from montecarloscattering_jl_tpu.engine.setup import build_setup
from montecarloscattering_jl_tpu.ops import fused_ion as jfused
from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu.utils import load_config as jload
from montecarloscattering_jl_tpu_torch.__main__ import main as cli_main
from montecarloscattering_jl_tpu_torch.engine.driver import run
from montecarloscattering_jl_tpu_torch.ops import hist, mega
from montecarloscattering_jl_tpu_torch.ops import split as tsplit
from montecarloscattering_jl_tpu_torch.ops import state as tst
from montecarloscattering_jl_tpu_torch.ops import step as tstep
from montecarloscattering_jl_tpu_torch.utils import constants as K
from montecarloscattering_jl_tpu_torch.utils import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "tests", "data", "dsa_nonrel.toml")
N = 150
CAP = 1024


def _cfg(load):
    cfg = load(CFG)
    cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = N
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
    out_j = tempfile.mkdtemp(prefix="mcs_xla_jax_")
    out_t = tempfile.mkdtemp(prefix="mcs_xla_torch_")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stp, "MAX_HELIX_STEPS", CAP)
        mp.setattr(tstep, "MAX_HELIX_STEPS", CAP)
        _clear_jax_caches()
        ref = jdriver.run(_cfg(jload), out_dir=out_j, p_dtype=jnp.float64)
        _clear_jax_caches()
        calls = (hist.PLAIN_CALLS, mega.TWIN_CALLS)
        got = run(_cfg(load_config), "cpu", out_dir=out_t)
        calls = (hist.PLAIN_CALLS - calls[0], mega.TWIN_CALLS - calls[1])
    torch.set_num_threads(n_thr)
    yield ref, got, out_j, out_t, calls
    for d in (out_j, out_t):
        for f in os.listdir(d):
            os.unlink(os.path.join(d, f))
        os.rmdir(d)


def test_engine_and_counts(runs):
    ref, got, _, _, (plain, twin) = runs
    assert plain > 0 and twin == 0      # every deposit took K2's path
    assert got.n_pushes == ref.n_pushes
    assert got.n_trajectories == ref.n_trajectories
    assert got.n_pushes > 1e5


def test_output_file_set(runs):
    ref, got, out_j, out_t, _ = runs
    want = sorted(os.listdir(out_j))
    assert "mc_xspec.dat" in want
    assert sorted(os.listdir(out_t)) == want
    with tempfile.TemporaryDirectory() as d:
        jio.write_outputs(got, d)            # the JAX writer, port result
        assert sorted(os.listdir(d)) == want
        for name in want:
            if name.endswith(".dat"):
                assert _table(os.path.join(out_t, name)) == _table(
                    os.path.join(d, name)), name


def _table(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return ([ln for ln in lines if ln.startswith("#")],
            sorted({len(ln.split()) for ln in lines
                    if ln and not ln.startswith("#")}))


@pytest.mark.parametrize("field", ["spectra_sf", "spectra_pf"])
def test_detector_spectra(runs, field):
    ref, got, _, _, _ = runs
    a = np.asarray(getattr(ref.iterations[0].ion_finals[0], field))
    b = np.asarray(getattr(got.iterations[0].ion_finals[0], field))
    assert a.shape == b.shape == (got.setup.bins.n_mom + 1, 2)
    for i in range(2):
        assert b[:, i].sum() > 0
        np.testing.assert_allclose(b[:, i].sum(), a[:, i].sum(), rtol=1e-6)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("field", ["pxx_flux", "pxz_flux", "energy_flux",
                                   "px_esc_upstream", "energy_esc_upstream",
                                   "sum_p_downstream", "sum_ke_downstream"])
def test_iteration_tallies(runs, field):
    ref, got, _, _, _ = runs
    a = np.asarray(getattr(ref.iterations[0].tallies, field), np.float64)
    b = np.asarray(getattr(got.iterations[0].tallies, field), np.float64)
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("field", ["psd", "therm_psd", "num_crossings"])
def test_psd(runs, field):
    ref, got, _, _, _ = runs
    a = np.asarray(getattr(ref.iterations[0].ion_finals[0], field),
                   np.float64)
    b = np.asarray(getattr(got.iterations[0].ion_finals[0], field),
                   np.float64)
    tol = 0.0 if field == "num_crossings" else 1e-5
    np.testing.assert_allclose(b, a, rtol=0, atol=tol * np.abs(a).max())


def _slope(res):
    setup = res.setup
    fi = res.iterations[0].ion_finals[0]
    p = setup.bins.mom_centers
    dndp = np.asarray(fi.psd)[:, :, 75].sum(axis=1) / np.diff(
        setup.bins.mom_edges)
    sel = (p > 0.018 * K.MP_C) & (p < 0.12 * K.MP_C) & (dndp > 0)
    assert sel.sum() >= 6
    return np.polyfit(np.log10(p[sel]), np.log10(dndp[sel]), 1)[0]


def test_slope_and_flux_normalisation(runs):
    ref, got, _, _, _ = runs
    setup = got.setup
    s_got, s_ref = _slope(got), _slope(ref)
    assert s_got == pytest.approx(s_ref, abs=1e-4)
    expect = -(3 * setup.r_comp / (setup.r_comp - 1) - 2)
    assert s_got == pytest.approx(expect, abs=0.45)
    pxx_norm = got.iterations[0].tallies.pxx_flux / setup.f_px_upstream
    up = slice(setup.i_shock - 4, setup.i_shock)
    assert np.all(pxx_norm[up] > 0.9) and np.all(pxx_norm[up] < 30.0)


# ---------------------------------------------------------------------------
# the CLI: float64 by default on the XLA engine, K1 with --f32
# ---------------------------------------------------------------------------

def _tiny_toml(tmp_path, extra=""):
    text = open(CFG).read()
    for key, val in (("N_PTS_INJ", 64), ("N_PTS_PCUT", 64),
                     ("N_PTS_PCUT_HI", 64)):
        text = text.replace(f"{key} = 200", f"{key} = {val}")
    text = text.replace("momentum-cutoffs = [0.02, 0.04, 0.08, 0.15, 0.3, "
                        "0.6]", "momentum-cutoffs = [0.02, 0.04]")
    path = tmp_path / "tiny.toml"
    path.write_text(text + extra)
    return str(path)


@pytest.fixture()
def low_caps(monkeypatch):
    monkeypatch.setattr(tstep, "MAX_HELIX_STEPS", 128)
    monkeypatch.setattr(mega, "MAX_HELIX_STEPS", 128)


@pytest.fixture()
def one_thread():
    # the CLI runs the plain step, ~300 small ops a step, in this
    # process: one torch thread, as the module fixture runs it (many
    # threads a worker crowd the cores)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("args,engine,xspec", [
    ([], "xla", False), (["--f32"], "k1", False), (["--f32"], "xla", True),
    ([], "xla", True)])
def test_cli_engine_selection(tmp_path, capsys, low_caps, one_thread, args,
                              engine, xspec):
    rg0 = load_config(CFG).rg0
    extra = f"\nXSPEC = [{-0.5 * rg0!r}, {0.5 * rg0!r}]\n" if xspec else ""
    cfg_path = _tiny_toml(tmp_path, extra)
    out = tmp_path / "out"
    out.mkdir()
    before = (hist.PLAIN_CALLS, mega.TWIN_CALLS)
    assert cli_main([cfg_path, "-o", str(out), "--device", "cpu",
                     *args]) == 0
    plain, twin = (hist.PLAIN_CALLS - before[0], mega.TWIN_CALLS - before[1])
    if engine == "xla":
        assert plain > 0 and twin == 0
    else:
        assert twin > 0 and plain == 0
    assert (out / "mc_xspec.dat").exists() == xspec
    assert (out / "mc_out.dat").exists()
    assert "0 pushes" not in capsys.readouterr().out


@pytest.mark.parametrize("p_dtype", [torch.float64, torch.float32])
def test_deferred_flags_raise_on_both_engines(tmp_path, low_caps, p_dtype):
    """A flag both engines once refused (no-scatter) runs through the
    driver on each engine and matches the JAX driver on the same config
    (helix cap 128 in every engine).  Without scattering a lane's path
    is set by its injection, which both packages draw alike: at float64
    (the same XLA stream) push and trajectory counts agree exactly, at
    float32 (K1's twin against the JAX XLA step at float32) the
    trajectories exactly and the pushes to 1%.  The custom f(r_g) law
    (alpha = 1.5, r_ref = 2 r_g0), which both once refused, runs on each
    too: against the JAX driver, at float64 push and trajectory counts
    exactly at this cap, at float32 (K1's twin against the JAX XLA
    step, two RNG streams) both within 15%."""
    cfg_path = _tiny_toml(tmp_path)
    cfg = load_config(cfg_path)
    cfg.dont_scatter = True
    jcfg = jload(cfg_path)
    jcfg.dont_scatter = True
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stp, "MAX_HELIX_STEPS", 128)
        _clear_jax_caches()
        ref = jdriver.run(jcfg, p_dtype=getattr(jnp, str(p_dtype)[6:]))
        _clear_jax_caches()
    before = (hist.PLAIN_CALLS, mega.TWIN_CALLS)
    got = run(cfg, "cpu", p_dtype=p_dtype)
    plain, twin = (hist.PLAIN_CALLS - before[0], mega.TWIN_CALLS - before[1])
    assert (twin > 0) == (p_dtype == torch.float32)
    assert (plain > 0) == (p_dtype == torch.float64)
    assert got.n_trajectories == ref.n_trajectories
    if p_dtype == torch.float64:
        assert got.n_pushes == ref.n_pushes
    else:
        assert got.n_pushes == pytest.approx(ref.n_pushes, rel=1e-2)
    for c in (cfg, jcfg):
        c.dont_scatter, c.use_custom_frg = False, True
        c.frg_alpha, c.frg_rg0_rg = 1.5, 2.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stp, "MAX_HELIX_STEPS", 128)
        _clear_jax_caches()
        ref = jdriver.run(jcfg, p_dtype=getattr(jnp, str(p_dtype)[6:]))
        _clear_jax_caches()
    got = run(cfg, "cpu", p_dtype=p_dtype)
    rel = 0.15 if p_dtype == torch.float32 else 0.0
    assert got.n_pushes == pytest.approx(ref.n_pushes, rel=rel)
    assert got.n_trajectories == pytest.approx(ref.n_trajectories, rel=rel)


@pytest.mark.parametrize("p_dtype", [torch.float64, torch.float32])
def test_protons_without_radiation_key(tmp_path, low_caps, p_dtype):
    """A protons-only config that omits ``radiation-losses`` (which then
    defaults to on, utils/config.py) runs: the radiative-loss branch is
    reached only by electrons (ops/step.py:309 of the JAX package), so
    the flag gates nothing here.  Against the JAX driver on the same
    config (helix cap 128 in every engine): at float64 (the same XLA
    stream) push and trajectory counts exactly, the flux tallies to 1e-6
    and the PSD to 1e-5 of their largest entry, as in the slice above;
    at float32 (K1's twin against the JAX XLA step) pushes and
    trajectories within 15%."""
    text = open(_tiny_toml(tmp_path)).read()
    assert "radiation-losses = false\n" in text
    path = tmp_path / "no_rad_key.toml"
    path.write_text(text.replace("radiation-losses = false\n", ""))
    cfg, jcfg = load_config(str(path)), jload(str(path))
    assert cfg.do_rad_losses and jcfg.do_rad_losses and cfg.n_ions == 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stp, "MAX_HELIX_STEPS", 128)
        _clear_jax_caches()
        ref = jdriver.run(jcfg, p_dtype=getattr(jnp, str(p_dtype)[6:]))
        _clear_jax_caches()
    got = run(cfg, "cpu", p_dtype=p_dtype)
    if p_dtype == torch.float32:
        assert got.n_pushes == pytest.approx(ref.n_pushes, rel=0.15)
        assert got.n_trajectories == pytest.approx(ref.n_trajectories,
                                                   rel=0.15)
        return
    assert got.n_pushes == ref.n_pushes > 0
    assert got.n_trajectories == ref.n_trajectories
    for field in ("pxx_flux", "pxz_flux", "energy_flux"):
        a = np.asarray(getattr(ref.iterations[0].tallies, field))
        b = np.asarray(getattr(got.iterations[0].tallies, field))
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-6 * np.abs(a).max())
    a = np.asarray(ref.iterations[0].ion_finals[0].psd, np.float64)
    b = np.asarray(got.iterations[0].ion_finals[0].psd, np.float64)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())


def _np(nt):
    d = {k: np.asarray(v) for k, v in nt._asdict().items() if k != "key"}
    d["key"] = np.asarray(jax.random.key_data(nt.key))
    return d


@pytest.mark.parametrize("n_target", [200, 3])
def test_split_on_device_f64(n_target):
    """split_on_device at float64 momenta: exact (it follows the state's
    dtype)."""
    from montecarloscattering_jl_tpu.ops import state as jst
    setup = build_setup(jload(CFG))
    g = np.random.default_rng(21)
    b = 512
    ptot = 1e-16 * 10.0 ** g.uniform(0, 2, b)
    x = g.uniform(setup.x_grid_cm[2], setup.x_grid_cm[-3], b)
    ig = (np.searchsorted(setup.x_grid_cm, x, side="right") - 1).astype(
        np.int32)
    st = jst.init_state(g.uniform(0.1, 1.0, b), ptot,
                        ptot * g.uniform(-1, 1, b), x, ig,
                        setup.profile.ux_sk[ig], 50.0, setup.x_grid_stop,
                        jax.random.key(3), downstream=g.random(b) < 0.5,
                        p_dtype=jnp.float64)
    st = st._replace(status=jnp.asarray(
        g.choice([0, 1, 2], b, p=[0.1, 0.4, 0.5]).astype(np.int32)))
    key = jax.random.fold_in(jax.random.key(5), 2)
    ref, n_ref = jfused.split_on_device(st, jnp.int32(n_target), key)
    got, n_got = tsplit.split_on_device(
        tst.ParticleState.from_jax_numpy(_np(st)), n_target,
        tuple(int(v) for v in np.asarray(jax.random.key_data(key))))
    assert n_got == int(n_ref)
    assert got.pb.dtype == torch.float64
    ref_np, got_np = _np(ref), got.to_numpy()
    for name in ref_np:
        np.testing.assert_array_equal(got_np[name], ref_np[name],
                                      err_msg=name)
