"""The cell-weight spreading modes of the dN/dp rebinning (``i_approx``,
the JAX package's ops/reduce.py:80-189) against the JAX package, on the
CPU, at float64.

For i_approx = 0 (uniform), 1 (isosceles triangle), 2 (scalene
triangle, the default), 3 (exact bilinear overlap) and 7 (any other
value: the scalene triangle, as ``_rebin_matrix`` dispatches it):

* ``rebin_matrix`` against ``_rebin_matrix`` on the corner grids of
  boosts from 1 to 2 in gamma: 1e-12 of the largest fraction (the same
  float64 arithmetic, reordered);
* ``ion_reduce_device`` against the JAX package's fused reduction
  program ``_ion_reduce_prog`` at float64 (tests/torch_jax_f64.py: the
  JAX wrapper casts to float32, a TPU limit) on the same seeded PSDs:
  1e-12 of each output's largest entry.  Zones are few (8,
  boosts gamma 1 to 2, an ISM boost of 1.3) and the PSD is the
  examples/01 binning's, 54 x 41 cells.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.ops import reduce as jred
from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
from montecarloscattering_jl_tpu_torch.ops import reduce as tred
from montecarloscattering_jl_tpu_torch.utils import constants as K
from montecarloscattering_jl_tpu_torch.utils import load_config

from torch_jax_f64 import ion_reduce_f64

CFG = "examples/01_test_particle.toml"
MODES = (0, 1, 2, 3, 7)
NB = 8
GAMMA0 = 1.3
RTOL = 1e-12


@pytest.fixture(scope="module")
def bins():
    return build_setup(load_config(CFG)).bins


def _psds(b, seed=5):
    g = np.random.default_rng(seed)
    shape = (b.n_mom + 1, b.n_theta + 1, NB)
    # spectrum-like: falling with momentum, sparse
    p_fac = 10.0 ** (-0.3 * np.arange(b.n_mom + 1))[:, None, None]
    psd = g.random(shape) * p_fac * (g.random(shape) < 0.7)
    therm = g.random(shape) * p_fac * (g.random(shape) < 0.3)
    return psd, therm


def _boosts():
    gamma = np.linspace(1.0, 2.0, NB)
    return gamma, K.C_CGS * np.sqrt(1.0 - 1.0 / gamma ** 2)


@pytest.mark.parametrize("i_approx", MODES)
def test_rebin_matrix(bins, i_approx):
    e0 = K.MP_C * K.C_CGS
    edges = bins.mom_bounds_log
    for gamma in (1.0, 1.05, 2.0):
        clp = tred.corner_logp(gamma, e0, torch.from_numpy(bins.mom_edges),
                               torch.from_numpy(bins.cos_bounds()))
        want = np.asarray(jred._rebin_matrix(jnp.asarray(clp.numpy()),
                                             jnp.asarray(edges), i_approx))
        got = tred.rebin_matrix(clp, torch.from_numpy(edges),
                                i_approx).numpy()
        assert got.shape == want.shape and want.max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * np.abs(want).max())
        # every cell's weight is spread in full
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-9)


@pytest.mark.parametrize("i_approx", MODES)
def test_ion_reduce_device(bins, i_approx):
    psd, therm = _psds(bins)
    gamma, ux = _boosts()
    e0 = K.MP_C * K.C_CGS
    want = ion_reduce_f64(psd, therm, bins, e0, gamma, ux, GAMMA0, i_approx,
                          True)
    got = tred.ion_reduce_device(torch.from_numpy(psd),
                                 torch.from_numpy(therm), bins, e0, gamma,
                                 ux, GAMMA0, i_approx=i_approx, want_ef=True)
    for name, a, b in zip(("dn_cr", "dn_th", "d2n_tot", "d2n_ef"), want,
                          got):
        assert a.shape == b.shape, name
        scale = np.abs(a).max()
        assert scale > 0, name
        np.testing.assert_allclose(b, a, rtol=0, atol=RTOL * scale,
                                   err_msg=name)
    if i_approx != 2:
        # the mode reaches the rebinning: dN/dp moves, but for 7, which
        # spreads as 2 does
        base = tred.ion_reduce_device(torch.from_numpy(psd),
                                      torch.from_numpy(therm), bins, e0,
                                      gamma, ux, GAMMA0)
        same = np.array_equal(got[0], base[0])
        near = np.allclose(got[0], base[0], rtol=1e-6, atol=0)
        assert same if i_approx == 7 else not near
