"""Synchrotron emission from an electron distribution.

Re-derives photon_synch.jl + synch_emission.jl as one dense outer
product over (electron bin, photon bin).  The synchrotron kernel
F(x) = x * int_x^inf K_{5/3}(xi) d xi (Rybicki & Lightman Eq 6.31c),
provided by SynchrotronKernel.jl in the reference
(synch_emission.jl:151), is tabulated once on a log grid with SciPy's
modified Bessel function and interpolated in log space.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from ...utils.constants import (
    C_CGS,
    HBAR_CGS,
    ME_CGS,
    MEV_ERG,
    QE_CGS,
)

_X_MIN, _X_MAX = 1.0e-15, 30.0
_E_MIN_SYNCH = 3.0 * MEV_ERG     # electrons below 3 MeV don't radiate
#                                  (synch_emission.jl:132-133)


@lru_cache(maxsize=1)
def _f_table() -> tuple[np.ndarray, np.ndarray]:
    """log-log table of F(x) on [1e-15, 30]."""
    from scipy.special import kv

    xs = np.logspace(math.log10(_X_MIN), math.log10(_X_MAX), 400)
    fs = np.empty_like(xs)
    for i, x in enumerate(xs):
        # int_x^inf K_{5/3}: K ~ t^(-5/3) at small t, ~ e^-t at large t;
        # log-spaced trapezoid handles both regimes accurately
        t = np.geomspace(x, 120.0, 4000)
        fs[i] = x * np.trapezoid(kv(5.0 / 3.0, t), t)
    return np.log(xs), np.log(np.maximum(fs, 1e-300))


def synchrotron_f(x: np.ndarray) -> np.ndarray:
    """F(x), zero outside the tabulated window (matching the
    reference's skip conditions, synch_emission.jl:147-149)."""
    lx, lf = _f_table()
    x = np.asarray(x, float)
    out = np.exp(np.interp(np.log(np.maximum(x, _X_MIN)), lx, lf))
    return np.where((x >= _X_MAX) | (x < _X_MIN), 0.0, out)


def photon_energy_grid(e_min_mev: float, n_photon: int,
                       bins_per_dec: int) -> np.ndarray:
    """Photon energies [erg], log-spaced (synch_emission.jl:39-42)."""
    log_min = math.log10(e_min_mev * MEV_ERG)
    return 10.0 ** (log_min + np.arange(n_photon) / bins_per_dec)


def synch_emission(dn_counts: np.ndarray, p_edges: np.ndarray,
                   bmag: float, e_gamma: np.ndarray) -> np.ndarray:
    """dP/d(lnE) [erg/s] for one zone (synch_emission.jl:28-171).

    dn_counts: electron counts per momentum bin (N, not dN/dp);
    p_edges: bin edges [g cm/s] (len = len(dn_counts) + 1);
    bmag: local field [G]; e_gamma: photon energies [erg].
    """
    if bmag < 1.0e-20:
        return np.full(len(e_gamma), 1.0e-99)
    mc = ME_CGS * C_CGS
    # R&L Eq 6.18 prefactor without sin(alpha) (synch_emission.jl:57-60)
    p_fac = math.sqrt(3.0) / (2.0 * math.pi) * (
        QE_CGS**3 * bmag / (ME_CGS * C_CGS**2))

    p = np.sqrt(p_edges[:-1] * p_edges[1:])      # geometric bin centers
    gam = np.hypot(p / mc, 1.0)
    omega_c = 3.0 * gam**2 * QE_CGS * bmag / (2.0 * mc)

    keep = (dn_counts > 1.0e-60) & (p * C_CGS >= _E_MIN_SYNCH) \
        & (omega_c >= 1.0e-55)
    if not np.any(keep):
        return np.full(len(e_gamma), 1.0e-99)

    omega_g = e_gamma / HBAR_CGS
    x = omega_g[None, :] / np.maximum(omega_c[keep, None], 1e-300)
    f = synchrotron_f(x)
    # dP/dw * w = dP/d(lnE) (synch_emission.jl:153-166)
    emis = (dn_counts[keep, None] * omega_g[None, :] * p_fac * f).sum(axis=0)
    return np.maximum(emis, 1.0e-99)
