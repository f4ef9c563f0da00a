"""Flat LambdaCDM cosmology: comoving distance <-> redshift.

Mirrors the Julia reference's src/cosmo_calc.jl:1-51 (Planck 2013 parameters,
h = 0.678) without Cosmology.jl: the comoving radial distance integral
is evaluated with fixed-order Gauss-Legendre quadrature and inverted
with Newton's method (Hogg 1999 conventions).
"""

from __future__ import annotations

import numpy as np

from .rootfind import newton

# Planck 2013 parameters as in cosmo_calc.jl:8-14
H_LITTLE = 0.678
OMEGA_R = 0.4165 / (H_LITTLE * 100.0) ** 2
OMEGA_VAC = 0.683 - 0.5 * OMEGA_R
OMEGA_M = 0.317 - 0.5 * OMEGA_R
OMEGA_K = 0.0

C_KM_S = 2.99792458e5
D_H_MPC = C_KM_S / (100.0 * H_LITTLE)   # Hubble distance at z=0 [Mpc]

_GL_X, _GL_W = np.polynomial.legendre.leggauss(96)


def _efunc(z: float) -> float:
    """Dimensionless Hubble parameter E(z) for flat LCDM + radiation."""
    zp1 = 1.0 + z
    return float(np.sqrt(
        OMEGA_R * zp1**4 + OMEGA_M * zp1**3 + OMEGA_K * zp1**2 + OMEGA_VAC))


def comoving_radial_dist(z: float) -> float:
    """Comoving radial distance D_C(z) [Mpc] = d_H * int_0^z dz'/E(z')."""
    if z <= 0:
        return 0.0
    zz = 0.5 * z * (_GL_X + 1.0)
    w = 0.5 * z * _GL_W
    e = np.sqrt(OMEGA_R * (1 + zz) ** 4 + OMEGA_M * (1 + zz) ** 3
                + OMEGA_VAC)
    return float(D_H_MPC * np.sum(w / e))


def get_redshift(d_cm_mpc: float) -> float:
    """Invert D_C(z) = d for z (cosmo_calc.jl:32-50).

    Distances below 0.443 Mpc return z = 0, matching the reference's
    shortcut threshold.
    """
    if d_cm_mpc <= 0:
        raise ValueError("d_CM must be positive")
    if d_cm_mpc < 0.443:
        return 0.0
    return newton(
        lambda z: comoving_radial_dist(z) - d_cm_mpc,
        x0=0.0,
        dfdx=lambda z: D_H_MPC / _efunc(z),
    )
