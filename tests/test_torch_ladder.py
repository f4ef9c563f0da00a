"""The ladder's device steps against the JAX package, on the CPU:

* ``split_on_device``: exact (same lanes, weights and keys);
* ``finish_particles``: rtol 1e-12 at float64 momenta (the two packages
  differ only in the last bits of hypot, cos and log10);
* ``ion_reduce_device``: rtol 1e-4 of each output's largest entry on
  the same PSD.  The reference runs in float32 and the port in float64,
  so a cell corner or a boosted cell center within ~1e-7 of a bin edge
  can land in the neighbouring bin ("corner flips"): those bins are
  counted and may be at most 1% of the nonzero bins.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarloscattering_jl_tpu.engine.run import TransportEngine
from montecarloscattering_jl_tpu.engine.setup import build_setup
from montecarloscattering_jl_tpu.ops import finish as jfin
from montecarloscattering_jl_tpu.ops import fused_ion as jfused
from montecarloscattering_jl_tpu.ops import reduce as jred
from montecarloscattering_jl_tpu.ops import state as jst
from montecarloscattering_jl_tpu.utils import load_config
from montecarloscattering_jl_tpu_torch.ops import finish as tfin
from montecarloscattering_jl_tpu_torch.ops import reduce as tred
from montecarloscattering_jl_tpu_torch.ops import split as tsplit
from montecarloscattering_jl_tpu_torch.ops import state as tst

CFG = "tests/data/dsa_nonrel.toml"


def _np(nt):
    d = {k: np.asarray(v) for k, v in nt._asdict().items() if k != "key"}
    d["key"] = np.asarray(jax.random.key_data(nt.key))
    return d


def _random_state(seed, b, p_dtype, setup):
    """A post-drain population: random momenta, positions on the grid,
    and a mix of ACTIVE / SAVED / FINISHED lanes with exit reasons."""
    g = np.random.default_rng(seed)
    mc = 1.6726e-24 * 2.998e10
    ptot = mc * 10.0 ** g.uniform(-3, 0, b)
    pb = ptot * g.uniform(-1, 1, b)
    x = g.uniform(setup.x_grid_cm[2], setup.x_grid_cm[-3], b)
    ig = (np.searchsorted(setup.x_grid_cm, x, side="right") - 1).astype(
        np.int32)
    w = np.where(g.random(b) < 0.9, g.uniform(0.1, 1.0, b), 0.0)
    st = jst.init_state(w, ptot, pb, x, ig, setup.profile.ux_sk[ig],
                        50.0, setup.x_grid_stop,
                        jax.random.fold_in(jax.random.key(seed), 1),
                        downstream=g.random(b) < 0.5,
                        inj=g.random(b) < 0.3,
                        acctime=g.uniform(0, 1e3, b),
                        p_dtype=p_dtype)
    status = g.choice([0, 1, 2], b, p=[0.1, 0.3, 0.6]).astype(np.int32)
    reason = np.where(status == 2, g.integers(1, 5, b), 0).astype(np.int32)
    return st._replace(status=jnp.asarray(status),
                       reason=jnp.asarray(reason),
                       nsteps=jnp.asarray(g.integers(0, 10_000, b),
                                          jnp.int32),
                       just_returned=jnp.asarray(g.random(b) < 0.1),
                       t_step=jnp.asarray(g.uniform(0, 1, b), p_dtype))


@pytest.fixture(scope="module")
def setup_eng():
    setup = build_setup(load_config(CFG))
    return setup, TransportEngine(setup, p_dtype=jnp.float64)


@pytest.mark.parametrize("n_target,offset", [(200, 0), (1000, 0),
                                             (3, 0), (200, 512)])
def test_split_on_device_exact(setup_eng, n_target, offset):
    setup, _ = setup_eng
    st = _random_state(7, 600, jnp.float32, setup)
    key = jax.random.fold_in(jax.random.key(77), 3)
    ref, n_ref = jfused.split_on_device(st, jnp.int32(n_target), key,
                                        lane_offset=offset)
    got, n_got = tsplit.split_on_device(
        tst.ParticleState.from_jax_numpy(_np(st)), n_target,
        tuple(int(v) for v in np.asarray(jax.random.key_data(key))),
        lane_offset=offset)
    assert n_got == int(n_ref)
    ref_np, got_np = _np(ref), got.to_numpy()
    for name in ref_np:
        np.testing.assert_array_equal(got_np[name], ref_np[name],
                                      err_msg=name)


def test_split_on_device_nothing_saved(setup_eng):
    setup, _ = setup_eng
    st = _random_state(8, 256, jnp.float32, setup)
    st = st._replace(status=jnp.full(256, 2, jnp.int32))
    got, n = tsplit.split_on_device(
        tst.ParticleState.from_jax_numpy(_np(st)), 200, (1, 2))
    assert n == 0
    assert (got.status == 2).all() and (got.weight == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_finish_particles(setup_eng, seed):
    setup, eng = setup_eng
    st = _random_state(seed, 2000, jnp.float64, setup)
    grids = eng.segment_grids(setup.profile)
    sc = eng.segment_scalars(0, 2, setup.profile.bmag2)
    ss = eng.step_static(0)
    b = setup.bins
    ref = jfin.finish_particles(st, jfin.EscapeTallies.zeros(b.n_mom,
                                                             b.n_theta),
                                grids, sc, ss)
    acc = tfin.EscapeTallies.zeros(b.n_mom, b.n_theta, "cpu")
    tfin.finish_particles(
        tst.ParticleState.from_jax_numpy(_np(st)), acc,
        tst.SegmentGrids.from_jax_numpy(_np_grids(grids), "cpu",
                                        torch.float64),
        tst.SegmentScalars.from_jax_numpy(sc._asdict()),
        tst.StepStatic.from_jax(ss))
    for name, want in ref._asdict().items():
        want = np.asarray(want)
        got = getattr(acc, name).numpy()
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)


def _np_grids(grids):
    return {k: np.asarray(v) for k, v in grids._asdict().items()}


@pytest.fixture(scope="module")
def reductions(setup_eng):
    setup, _ = setup_eng
    b = setup.bins
    nb = setup.nb
    g = np.random.default_rng(5)
    shape = (b.n_mom + 1, b.n_theta + 1, nb)
    # a spectrum-like PSD: falling with momentum, sparse at high p
    p_fac = 10.0 ** (-0.3 * np.arange(b.n_mom + 1))[:, None, None]
    psd = (g.random(shape) * p_fac * (g.random(shape) < 0.7)).astype(
        np.float32)
    therm = (g.random(shape) * p_fac * (g.random(shape) < 0.3)).astype(
        np.float32)
    prof = setup.profile
    e0 = setup.cfg.species[0].rest_energy
    gamma0 = 1.3           # a moving upstream frame, so the ISM boost acts
    ref = jred.ion_reduce_device(psd, therm, b, e0, prof.gamma_sf,
                                 prof.ux_sk, gamma0, want_ef=True)
    got = tred.ion_reduce_device(torch.from_numpy(psd),
                                 torch.from_numpy(therm), b, e0,
                                 prof.gamma_sf, prof.ux_sk, gamma0,
                                 want_ef=True)
    return ref, got


@pytest.mark.parametrize("i,name", [(0, "dn_cr"), (1, "dn_th"),
                                    (2, "d2n_tot"), (3, "d2n_ef")])
def test_ion_reduce_device(reductions, i, name):
    ref, got = reductions
    want = np.asarray(ref[i], np.float64)
    have = got[i]
    assert have.shape == want.shape and have.dtype == np.float64
    scale = np.abs(want).max()
    assert scale > 0
    off = np.abs(have - want) > 1e-4 * scale
    nonzero = int((np.abs(want) > 0).sum())
    assert off.sum() <= 0.01 * nonzero, (
        f"{name}: {int(off.sum())} of {nonzero} bins off by more than "
        f"1e-4 of the largest")
    # a flip moves weight between neighbours: the totals still agree
    np.testing.assert_allclose(have.sum(), want.sum(), rtol=1e-4)


def test_finalize_tallies_matches(setup_eng):
    setup, _ = setup_eng
    b = setup.bins
    g = np.random.default_rng(9)
    tal = jst.make_tallies(setup.nb, b.n_mom, b.n_theta, 0, 0)
    tal = tal._replace(
        flux_diff=jnp.asarray(g.standard_normal(tal.flux_diff.shape)),
        psd_diff=jnp.asarray(g.standard_normal(tal.psd_diff.shape),
                             jnp.float32),
        px_esc_up=jnp.float64(1.5), sum_ke_dw=jnp.float64(-2.0))
    ref = jst.finalize_tallies(tal)
    got = tst.finalize_tallies(tst.Tallies.from_jax_numpy(
        {k: np.asarray(v) for k, v in tal._asdict().items()}))
    for name in ("pxx_flux", "pxz_flux", "energy_flux", "num_crossings",
                 "psd", "therm_psd", "px_esc_up", "en_esc_up", "sum_p_dw",
                 "sum_ke_dw"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-5, err_msg=name)
