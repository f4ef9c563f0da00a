"""The JAX package's fused reduction at float64, for the parity tests of
the port's reductions (test_torch_iapprox.py, test_torch_examples.py).

The JAX wrapper ``ops.reduce.ion_reduce_device`` casts its inputs to
float32 (float64 is emulated on a TPU).  ``ion_reduce_f64`` is the same
wrapper with those casts made float64: it hands the same fused program,
``_ion_reduce_prog``, float64 inputs, so a comparison with the port's
float64 reduction reads the spreading modes and not float32 rounding.
"""

import numpy as np

import jax
import jax.numpy as jnp

from montecarloscattering_jl_tpu.ops import reduce as jred
from montecarloscattering_jl_tpu_torch.utils import constants as K


def ion_reduce_f64(psd, therm_psd, b, e0, gamma_sf_grid, ux_sk_grid,
                   gamma0, i_approx=2, want_ef=False, fetch=True):
    """``jred.ion_reduce_device`` (reduce.py:311-352) at float64, with
    its signature."""
    f64 = jnp.float64
    out = jred._ion_reduce_prog(
        jnp.asarray(psd, f64), jnp.asarray(therm_psd, f64),
        jnp.asarray(gamma_sf_grid, f64),
        jnp.asarray(np.asarray(ux_sk_grid) / K.C_CGS, f64), e0, gamma0,
        jnp.asarray(b.mom_edges, f64), jnp.asarray(b.cos_bounds(), f64),
        jnp.asarray(b.mom_bounds_log, f64), jnp.asarray(b.mom_centers, f64),
        jnp.asarray(b.cos_centers(), f64), b.psd_mom_min,
        b.bins_per_dec_mom, b.bins_per_dec_theta, b.cos_fine, b.dcos,
        b.theta_min, b.n_mom, b.n_theta, i_approx, want_ef)
    if not fetch:
        return out
    return tuple(None if a is None else np.asarray(a)
                 for a in jax.device_get(out))
