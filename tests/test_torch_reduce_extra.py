"""The four library reductions of ops/reduce.py that no driver path
calls (the JAX package's reduce.py:203, 542, 569, 607) against the JAX
package's, on the CPU, at float64.

On the PSD binning of examples/01 (54 x 41 cells), 8 zones with boosts
gamma 1 to 2, an ISM boost of 1.3, seeded spectrum-like PSDs (as
tests/test_torch_iapprox.py builds them; the JAX functions are handed
float64 and compute in float64, so no cast is in the way):

* ``dndp_cr``, dN/dp in the shock, plasma and ISM frames, under
  i_approx 0, 1, 2 and 3: 1e-12 of its largest entry;
* ``pitch_histograms`` at 1 and 2 decades a group, ``normalized_total_ef``
  and ``dndp_2d_ef``: 1e-12 of the largest entry, zones with no
  crossings included (they take the far-upstream density).
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

CFG = "examples/01_test_particle.toml"
NB = 8
GAMMA0 = 1.3
RTOL = 1e-12
N0 = 2.5
M_ION = K.MP_CGS


@pytest.fixture(scope="module")
def bins():
    return build_setup(load_config(CFG)).bins


@pytest.fixture(scope="module")
def inputs(bins):
    g = np.random.default_rng(11)
    shape = (bins.n_mom + 1, bins.n_theta + 1, NB)
    p_fac = 10.0 ** (-0.3 * np.arange(bins.n_mom + 1))[:, None, None]
    psd = g.random(shape) * p_fac * (g.random(shape) < 0.7)
    therm = g.random(shape) * p_fac * (g.random(shape) < 0.3)
    zone_pop = 1e50 * g.random(NB)
    ncross = np.where(np.arange(NB) % 3 == 0, 0.0, g.random(NB))
    return dict(psd=psd, therm=therm, zone_pop=zone_pop, ncross=ncross,
                gamma=np.linspace(1.0, 2.0, NB))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("i_approx", [0, 1, 2, 3])
def test_dndp_cr(bins, inputs, i_approx):
    e0 = M_ION * K.C_CGS ** 2
    want = jred.dndp_cr(jnp.asarray(inputs["psd"]), bins, e0,
                        inputs["gamma"], GAMMA0, i_approx=i_approx)
    got = tred.dndp_cr(torch.from_numpy(inputs["psd"]), bins, e0,
                       inputs["gamma"], GAMMA0, i_approx=i_approx)
    assert got.dtype == torch.float64
    _close(got.numpy(), want)
    # the shock frame is the plain momentum histogram per dp
    dp = np.diff(bins.mom_edges)[:, None]
    _close(got.numpy()[..., 0], inputs["psd"].sum(axis=1) / dp)


@pytest.mark.parametrize("decades", [1, 2])
def test_pitch_histograms(bins, inputs, decades):
    cw, want = jred.pitch_histograms(inputs["psd"], bins, decades)
    cg, got = tred.pitch_histograms(inputs["psd"], bins, decades)
    np.testing.assert_array_equal(cg, cw)
    _close(got, want)
    sums = got.sum(axis=1)
    np.testing.assert_allclose(sums[sums > 0], 1.0, rtol=1e-12)


def test_normalized_total_ef(inputs):
    args = (inputs["psd"], inputs["therm"], inputs["zone_pop"],
            inputs["ncross"], N0)
    _close(tred.normalized_total_ef(*args), jred.normalized_total_ef(*args))


def test_dndp_2d_ef(bins, inputs):
    beta0 = np.sqrt(1.0 - 1.0 / GAMMA0 ** 2)
    args = (inputs["psd"], inputs["therm"], bins, M_ION, inputs["zone_pop"],
            inputs["ncross"], N0, beta0, GAMMA0)
    _close(tred.dndp_2d_ef(*args), jred.dndp_2d_ef(*args))
