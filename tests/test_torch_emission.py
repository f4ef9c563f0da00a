"""The port's emission functions against the JAX package's, on the CPU.

Inputs are made with NumPy from a seed: electron and proton counts per
zone and momentum bin spanning 1e-99 ... 1e60 (with empty bins and an
empty zone), a field per zone (one below the 1e-20 G floor), a d2N cube
for the cone cut, and per-zone photon grids with bulk flows up to
gamma ~ 5 for the Doppler shift.

* Each batched device function of models/emission/device.py (torch,
  float64) against its JAX counterpart: rtol 1e-9 on every bin above
  1e-90 (the 1e-99 floors mark empty bins in both).  The two differ by
  the rounding of hypot, exp, log and the matmul's summation order.
* The copied NumPy oracles (synchrotron.py, inverse_compton.py, pion.py)
  and the host helpers of driver.py against the JAX package's, bit for
  bit: the same NumPy code on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.models.emission import device as jdev
from montecarloscattering_jl_tpu.models.emission import driver as jdrv
from montecarloscattering_jl_tpu.models.emission import (
    inverse_compton as jic, pion as jpi, synchrotron as jsy)
from montecarloscattering_jl_tpu_torch.models.emission import device as tdev
from montecarloscattering_jl_tpu_torch.models.emission import driver as tdrv
from montecarloscattering_jl_tpu_torch.models.emission import (
    inverse_compton as tic, pion as tpi, synchrotron as tsy)
from montecarloscattering_jl_tpu_torch.utils import constants as K

NZ, N_P, N_THETA = 12, 48, 9
RTOL, FLOOR = 1e-9, 1e-90


def _counts(g, shape):
    """Counts spanning 1e-99 ... 1e60, a tenth of them exactly 0."""
    c = 10.0 ** g.uniform(-99.0, 60.0, shape)
    return np.where(g.random(shape) < 0.1, 0.0, c)


@pytest.fixture(scope="module")
def inp():
    g = np.random.default_rng(7)
    me_c, mp_c = K.ME_CGS * K.C_CGS, K.MP_C
    d = dict(
        pe_edges=me_c * np.logspace(-2, 9, N_P + 1),
        pp_edges=mp_c * np.logspace(-2, 6, N_P + 1),
        counts=_counts(g, (NZ, N_P)),
        btot=10.0 ** g.uniform(-6, -2, NZ),
        d2n=_counts(g, (N_P, N_THETA, NZ)),
        cos_bounds=np.linspace(-1.0, 1.0, N_THETA + 1),
        target=10.0 ** g.uniform(-2, 1, NZ),
        e_synch=tsy.photon_energy_grid(1e-13, 180, 10),
        e_pion=10.0 ** (np.log10(K.MEV_ERG) + np.arange(120) / 10),
        alpha_ic=tic.ic_photon_energy_grid(1e-2, 140, 10),
        beta_ef=g.uniform(0.05, 0.98, NZ))
    d["counts"][3] = 0.0            # an empty zone
    d["btot"][5] = 1e-21            # a zone below the field floor
    d["gamma_ef"] = 1.0 / np.sqrt(1.0 - d["beta_ef"] ** 2)
    d["grid"] = 10.0 ** g.uniform(-60, -5, (180, NZ))
    d["grid"][:, 3] = 1e-120        # counts below 1e-90: nothing to shift
    d["ne"] = tdev.cone_cut_counts(d["d2n"], d["cos_bounds"], 0.3)
    return d


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert (ref > FLOOR).sum() > ref.size // 10     # not vacuous
    np.testing.assert_allclose(np.maximum(got, FLOOR),
                               np.maximum(ref, FLOOR), rtol=RTOL, atol=0.0)


def test_synch_grid_device(inp):
    ref = jdev.synch_grid_device(_j(inp["counts"]), _j(inp["btot"]),
                                 _j(inp["pe_edges"]), _j(inp["e_synch"]))
    got = tdev.synch_grid_device(_t(inp["counts"]), _t(inp["btot"]),
                                 _t(inp["pe_edges"]), _t(inp["e_synch"]))
    _close(got, ref)
    # the empty zone and the zone below the field floor hold the floor
    assert (got[:, 3] == 1e-99).all() and (got[:, 5] == 1e-99).all()


@pytest.mark.parametrize("jet_sph_frac", [0.3, 1.0])
def test_ic_grid_device(inp, jet_sph_frac):
    a1, n_ph = tic.cmb_photon_field(0.2)
    mc, dist = K.ME_CGS * K.C_CGS, 3.0e27
    ref = jdev.ic_grid_device(_j(inp["ne"]), _j(inp["pe_edges"]),
                              _j(inp["alpha_ic"]), (_j(a1), _j(n_ph)), mc,
                              jet_sph_frac, dist)
    got = tdev.ic_grid_device(_t(inp["ne"]), _t(inp["pe_edges"]),
                              _t(inp["alpha_ic"]), (_t(a1), _t(n_ph)), mc,
                              jet_sph_frac, dist)
    _close(got, ref)


def test_pion_grid_device(inp):
    args = (inp["pp_edges"], inp["e_pion"])
    ref = jdev.pion_grid_device(inp["counts"], *args, inp["target"], 1.0,
                                K.MP_C, 1.3)
    got = tdev.pion_grid_device(_t(inp["counts"]), *args,
                                _t(inp["target"]), 1.0, K.MP_C, 1.3)
    _close(got, ref)


def test_doppler_shift_device(inp):
    ref = jdev.doppler_shift_device(_j(inp["grid"]), _j(inp["e_synch"]),
                                    _j(inp["beta_ef"]), _j(inp["gamma_ef"]))
    got = tdev.doppler_shift_device(_t(inp["grid"]), _t(inp["e_synch"]),
                                    _t(inp["beta_ef"]), _t(inp["gamma_ef"]))
    _close(got, ref)
    assert (got[:, 3] == 0).all()
    # and against the per-zone NumPy loop, the JAX package's own bound
    host = tdrv.doppler_shift_to_ism(inp["grid"], inp["e_synch"],
                                     inp["beta_ef"], inp["gamma_ef"])
    np.testing.assert_allclose(np.maximum(got.numpy(), 1e-80),
                               np.maximum(host, 1e-80), rtol=1e-5)


@pytest.mark.parametrize("jet_sph_frac", [0.05, 0.3, 1.0])
def test_cone_cut_counts(inp, jet_sph_frac):
    ref = jdev.cone_cut_counts(inp["d2n"], inp["cos_bounds"], jet_sph_frac)
    got = tdev.cone_cut_counts(inp["d2n"], inp["cos_bounds"], jet_sph_frac)
    assert got.shape == (NZ, N_P)
    np.testing.assert_array_equal(got, ref)


def test_interp_is_jnp_interp():
    g = np.random.default_rng(3)
    xp = np.sort(g.uniform(-30, 4, 400))
    fp = g.normal(size=400)
    x = np.concatenate([g.uniform(-40, 10, 5000), xp[:50], [xp[0], xp[-1]]])
    ref = np.asarray(jnp.interp(_j(x), _j(xp), _j(fp)))
    got = tdev.interp(_t(x), _t(xp), _t(fp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)
    assert (got[x < xp[0]] == fp[0]).all() and (got[x > xp[-1]] == fp[-1]).all()


# ---- the copied NumPy oracles, bit for bit --------------------------------

def _oracle_cases(inp):
    mc_e = K.ME_CGS * K.C_CGS
    ic_args = (inp["d2n"][:, :, 1], inp["pe_edges"], inp["cos_bounds"],
               inp["alpha_ic"], 0.2, 0.3, 3.0e27, mc_e)
    seed = (inp["e_synch"] / K.ME_C2, 10.0 ** np.linspace(-30, 3, 180))
    shells = 10.0 ** np.random.default_rng(5).uniform(-95, -8, (3, 120, 4))
    return {
        "f_table": (lambda m: np.stack(m._f_table()), (jsy, tsy)),
        "synchrotron_f": (lambda m: m.synchrotron_f(
            np.logspace(-17, 2, 300)), (jsy, tsy)),
        "photon_energy_grid": (lambda m: m.photon_energy_grid(
            1e-13, 180, 10), (jsy, tsy)),
        "synch_emission": (lambda m: m.synch_emission(
            inp["counts"][1], inp["pe_edges"], inp["btot"][1],
            inp["e_synch"]), (jsy, tsy)),
        "cmb_photon_field": (lambda m: np.stack(m.cmb_photon_field(0.2)),
                             (jic, tic)),
        "ic_photon_energy_grid": (lambda m: m.ic_photon_energy_grid(
            1e-2, 140, 10), (jic, tic)),
        "ic_emission": (lambda m: m.ic_emission(*ic_args), (jic, tic)),
        "ic_emission_seed": (lambda m: m.ic_emission(*ic_args, seed=seed),
                             (jic, tic)),
        "sigma_pi": (lambda m: m.sigma_pi(np.logspace(-1, 6, 200)),
                     (jpi, tpi)),
        "heavy_nuclei_scaling": (lambda m: np.float64(
            m.heavy_nuclei_scaling(4.0, [1.0, 4.0], [1.0, 0.1])),
            (jpi, tpi)),
        "pion_emission": (lambda m: m.pion_emission(
            inp["counts"][2], inp["pp_edges"], inp["e_pion"], 0.7, 1.0,
            K.MP_C, [1.0], [1.0]), (jpi, tpi)),
        "doppler_shift_to_ism": (lambda m: m.doppler_shift_to_ism(
            inp["grid"], inp["e_synch"], inp["beta_ef"], inp["gamma_ef"]),
            (jdrv, tdrv)),
        "sum_shells": (lambda m: m.sum_shells(
            inp["grid"], np.array([1, 4, 9, 12])), (jdrv, tdrv)),
        "merge_total": (lambda m: np.concatenate(
            [a.ravel() for a in m.merge_total(*shells)]), (jdrv, tdrv)),
    }


@pytest.mark.parametrize("name", [
    "f_table", "synchrotron_f", "photon_energy_grid", "synch_emission",
    "cmb_photon_field", "ic_photon_energy_grid", "ic_emission",
    "ic_emission_seed", "sigma_pi", "heavy_nuclei_scaling",
    "pion_emission", "doppler_shift_to_ism", "sum_shells", "merge_total"])
def test_numpy_oracle_bit_for_bit(inp, name):
    fn, (ref_mod, port_mod) = _oracle_cases(inp)[name]
    assert ref_mod is not port_mod
    ref, got = fn(ref_mod), fn(port_mod)
    assert np.asarray(ref).size > 0
    np.testing.assert_array_equal(got, ref)


def test_synch_photon_rate_and_grid_constants():
    for name in ("EG_MIN_MEV", "EG_MAX_MEV", "BINS_PER_DEC_PHOTON",
                 "EG_PION_MIN_MEV", "EG_SYNCH_MIN_MEV", "EG_SYNCH_MAX_MEV",
                 "EG_IC_MIN_MEV", "N_COS_BINS"):
        assert getattr(tdrv, name) == getattr(jdrv, name), name
    e = tsy.photon_energy_grid(1e-13, 5, 10)
    grid = np.arange(10.0).reshape(5, 2) + 1.0
    kw = dict(e_pion=e, e_synch=e, e_ic=e, pion_grid=grid, synch_grid=grid,
              ic_grid=grid, pion_shell=grid, synch_shell=grid,
              ic_shell=grid, e_tot=e, tot_shell=grid, tot=grid.sum(1))
    np.testing.assert_array_equal(
        tdrv.EmissionResult(**kw).synch_photon_rate(),
        jdrv.EmissionResult(**kw).synch_photon_rate())
