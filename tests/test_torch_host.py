"""The port's host layer against the JAX package's: the copied NumPy
modules must give equal results (exact), and the torch PSD bin lookups
must give the same bins as the jnp ones."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.engine import setup as jsetup
from montecarloscattering_jl_tpu.models import psd_bins as jbins
from montecarloscattering_jl_tpu.models import smoothing as jsm
from montecarloscattering_jl_tpu.utils import load_config
from montecarloscattering_jl_tpu.utils.constants import MP_CGS
from montecarloscattering_jl_tpu_torch.engine import setup as tsetup
from montecarloscattering_jl_tpu_torch.models import psd_bins as tbins
from montecarloscattering_jl_tpu_torch.models import smoothing as tsm
from montecarloscattering_jl_tpu_torch.utils import load_config as t_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOMLS = sorted(
    glob.glob(os.path.join(ROOT, "configs", "*.toml"))
    + glob.glob(os.path.join(ROOT, "examples", "*.toml"))
    + glob.glob(os.path.join(ROOT, "tests", "data", "*.toml")))
SMOOTH = sorted(glob.glob(os.path.join(ROOT, "tests", "data",
                                       "smooth_gamma5", "*.npz")))


def _assert_same(a, b, path="setup"):
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if f.name == "cfg":
                continue
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=path)
    elif isinstance(a, float):
        assert (a == b) or (np.isnan(a) and np.isnan(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("path", TOMLS, ids=os.path.basename)
def test_load_config_equal(path):
    """The port's copy of utils/ parses every shipped TOML alike."""
    ref, got = load_config(path), t_load(path)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "species":
            assert [vars(s) for s in a] == [vars(s) for s in b], path
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("path", TOMLS, ids=os.path.basename)
def test_build_setup_equal(path):
    ref = jsetup.build_setup(load_config(path))
    got = tsetup.build_setup(t_load(path))
    _assert_same(ref, got)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_psd_bin_lookups_equal(dtype):
    b = jsetup.build_setup(load_config(os.path.join(
        ROOT, "tests", "data", "dsa_nonrel.toml"))).bins
    g = np.random.default_rng(3)
    n = 20_000
    # momenta spanning the grid (under- and overflow included), pitch
    # cosines over [-1, 1] with a cluster near the log-theta bins
    p = 10.0 ** g.uniform(np.log10(b.psd_mom_min) - 1,
                          b.mom_bounds_log[-1] + 1, n)
    mu = np.concatenate([g.uniform(-1, 1, n // 2),
                         -1.0 + 10.0 ** g.uniform(-7, 0, n - n // 2)])
    p = p.astype(dtype)
    px = (p * mu).astype(dtype)
    want_p = np.asarray(jbins.psd_bin_momentum(
        jnp.asarray(p), b.psd_mom_min, b.bins_per_dec_mom, b.n_mom))
    want_t = np.asarray(jbins.psd_bin_angle(
        jnp.asarray(px), jnp.asarray(p), b.cos_fine, b.dcos, b.theta_min,
        b.bins_per_dec_theta, b.n_theta))
    got_p = tbins.psd_bin_momentum(torch.from_numpy(p), b.psd_mom_min,
                                   b.bins_per_dec_mom, b.n_mom)
    got_t = tbins.psd_bin_angle(torch.from_numpy(px), torch.from_numpy(p),
                                b.cos_fine, b.dcos, b.theta_min,
                                b.bins_per_dec_theta, b.n_theta)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_t.numpy(), want_t)


@pytest.mark.parametrize("path", SMOOTH, ids=os.path.basename)
def test_velocity_profile_solve_equal(path):
    """The relativistic profile solver inside smooth_grid, on the
    recorded gamma0 = 5 inputs."""
    d = np.load(path)

    def solve(mod):
        n0 = float(d["rho0"]) / MP_CGS
        return mod.new_velocity_profile(
            True, n0, float(d["u0"]), float(d["beta0"]),
            float(d["gamma0"]), float(d["u2"]), d["pxx_flux"],
            d["energy_flux"], float(d["q_esc_px_avg"]),
            float(d["q_esc_en_avg"]), d["x_grid_rg"], d["ux_sk"],
            d["gamma_sf"], d["gamma_grid"], d["btot"], d["theta"],
            float(d["omega"]), d["p_psd_par"] + d["p_psd_perp"],
            float(d["f_px_up"]), float(d["f_en_up"]),
            float(d["smooth_mom_energy_fac"]))

    np.testing.assert_array_equal(solve(tsm), solve(jsm))


@pytest.mark.parametrize("i_iter", [0, 1])
def test_smooth_grid_equal(i_iter):
    """One whole smoothing pass on the test-particle setup with seeded
    tallies: profile, diagnostics and weight factor equal."""
    cfg = load_config(os.path.join(ROOT, "tests", "data",
                                   "dsa_nonrel.toml"))
    cfg.do_smoothing = True
    s = jsetup.build_setup(cfg)
    nb = s.nb
    g = np.random.default_rng(i_iter)
    pxx = s.f_px_upstream * (1.0 + 0.2 * g.random(nb))
    enf = s.f_energy_upstream * (1.0 + 0.2 * g.random(nb))
    p_par = 1e-10 * g.random(nb)
    p_perp = 2e-10 * g.random(nb)
    gamma_grid = np.full((nb, 2), 5.0 / 3.0)
    rho0 = sum(sp.number_density * sp.mass for sp in cfg.species)
    args = (i_iter, s.i_shock, s.profile, cfg, s.x_grid_rg, gamma_grid,
            p_par, p_perp, pxx, enf, 0.05, 0.1, s.f_px_upstream,
            s.f_energy_upstream, s.gamma2_rh, s.u2, s.beta2, s.gamma2,
            cfg.prof_weight_fac, cfg.species[0].number_density,
            cfg.species[0].temperature, rho0, cfg.use_custom_eps_b)
    ref = jsm.smooth_grid(*args)
    got = tsm.smooth_grid(*args)
    _assert_same(ref[0], got[0], "profile")
    _assert_same(ref[1], got[1], "diag")
    assert ref[2] == got[2]
