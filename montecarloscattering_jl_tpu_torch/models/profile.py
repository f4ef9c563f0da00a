"""Shock velocity / B-field profile state and its initialization.

Mirrors setup_profile + set_custom_epsB! (initializers.jl:774-930).
The profile is the small O(n_grid) state that the nonlinear outer loop
updates each iteration; it lives as NumPy host arrays and is shipped to
devices as constants of each jitted transport segment.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..utils.constants import C_CGS, MP_CGS
from ..utils.species import Species


@dataclass
class ShockProfile:
    """Per-boundary profile arrays (length nb = n_grid + 2)."""

    ux_sk: np.ndarray      # bulk flow speed along x, shock frame [cm/s]
    uz_sk: np.ndarray      # z component (0 for parallel shocks) [cm/s]
    utot: np.ndarray       # total bulk flow speed [cm/s]
    gamma_sf: np.ndarray   # Lorentz factor of flow in shock frame
    beta_ef: np.ndarray    # x speed of plasma relative to ISM frame / c
    gamma_ef: np.ndarray   # Lorentz factor of beta_ef
    btot: np.ndarray       # total magnetic field [G]
    theta: np.ndarray      # B angle from shock normal [rad]
    eps_b: np.ndarray      # magnetic energy-density fraction
    bmag2: float           # downstream field [G]

    def copy(self) -> "ShockProfile":
        return ShockProfile(
            self.ux_sk.copy(), self.uz_sk.copy(), self.utot.copy(),
            self.gamma_sf.copy(), self.beta_ef.copy(), self.gamma_ef.copy(),
            self.btot.copy(), self.theta.copy(), self.eps_b.copy(),
            self.bmag2)


def turbulence_b_factor(gamma0: float, u0: float, gamma_sf: float,
                        ux: float, bturb_comp_frac: float,
                        bfield_amp: float) -> float:
    """Field amplification from compressed turbulence
    (initializers.jl:805-811, smoothers.jl:331-336).

    z_comp = (g0 u0)/(g u); comp = 1 + (sqrt((1+2z^2)/3)-1)*bturb;
    amp = 1 + (comp-1)*bfield_amp.
    """
    z_comp = (gamma0 * u0) / (gamma_sf * ux)
    aux = math.sqrt((1.0 + 2.0 * z_comp**2) / 3.0)
    comp_fac = 1.0 + (aux - 1.0) * bturb_comp_frac
    return 1.0 + (comp_fac - 1.0) * bfield_amp


def setup_profile(u0: float, beta0: float, gamma0: float, bmag0: float,
                  theta_b0_deg: float, r_comp: float,
                  bturb_comp_frac: float, bfield_amp: float,
                  use_custom_eps_b: bool, species: Sequence[Species],
                  f_px_upstream: float, f_energy_upstream: float,
                  x_grid_cm: np.ndarray, x_grid_rg: np.ndarray
                  ) -> ShockProfile:
    """Initial step-function shock profile (initializers.jl:774-850)."""
    nb = len(x_grid_cm)
    ux = np.empty(nb)
    gamma_sf = np.empty(nb)
    beta_ef = np.empty(nb)
    gamma_ef = np.empty(nb)
    btot = np.empty(nb)
    theta = np.full(nb, math.radians(theta_b0_deg))

    comp_fac = 0.0
    u_dw = u0 / r_comp
    b_dw = u_dw / C_CGS
    for i in range(nb):
        if x_grid_cm[i] < 0.0:
            ux[i] = u0
            gamma_sf[i] = gamma0
            beta_ef[i] = 0.0
            gamma_ef[i] = 1.0
            btot[i] = bmag0
        else:
            ux[i] = u_dw
            gamma_sf[i] = 1.0 / math.sqrt(1.0 - b_dw**2)
            beta_ef[i] = (beta0 - b_dw) / (1.0 - beta0 * b_dw)
            gamma_ef[i] = 1.0 / math.sqrt(1.0 - beta_ef[i] ** 2)
            z_comp = (gamma0 * u0) / (gamma_sf[i] * u_dw)
            aux = math.sqrt((1.0 + 2.0 * z_comp**2) / 3.0)
            comp_fac = 1.0 + (aux - 1.0) * bturb_comp_frac
            amp_fac = 1.0 + (comp_fac - 1.0) * bfield_amp
            btot[i] = bmag0 * amp_fac

    eps_b = np.full(nb, 1.0e-99)
    if use_custom_eps_b:
        eps_b = set_custom_eps_b(
            species, bmag0, f_px_upstream, f_energy_upstream,
            ux, x_grid_rg, comp_fac, gamma0, beta0, u0)
        n0 = sum(s.number_density * s.mass for s in species) / MP_CGS
        e0 = n0 * MP_CGS * C_CGS**2
        for i in range(nb):
            energy_density = ((f_energy_upstream + gamma0 * u0 * e0) / ux[i]
                              - f_px_upstream)
            btot[i] = math.sqrt(abs(8 * math.pi * eps_b[i] * energy_density))

    return ShockProfile(
        ux_sk=ux, uz_sk=np.zeros(nb), utot=ux.copy(), gamma_sf=gamma_sf,
        beta_ef=beta_ef, gamma_ef=gamma_ef, btot=btot, theta=theta,
        eps_b=eps_b, bmag2=float(btot[-1]))


def set_custom_eps_b(species: Sequence[Species], bmag0: float,
                     f_px_upstream: float, f_energy_upstream: float,
                     ux_sk_grid: np.ndarray, x_grid_rg: np.ndarray,
                     comp_fac: float, gamma0: float, beta0: float,
                     u0: float) -> np.ndarray:
    """Blandford-McKee-inspired eps_B(x) profile
    (initializers.jl:868-930)."""
    n0 = sum(s.number_density * s.mass for s in species) / MP_CGS
    e0 = n0 * MP_CGS * C_CGS**2
    eps_b0 = bmag0**2 / (8 * math.pi * e0)

    # Zero electron density (as in the baseline config) degenerates to
    # rg2sd = 0 => eps_B = 1e-4 everywhere; the reference reaches the
    # same profile through Inf propagation (initializers.jl:895-897).
    n0_electron = species[-1].number_density
    sigma = 2.0 * eps_b0 / gamma0
    if n0_electron > 0.0:
        rg2sd = beta0 / math.sqrt(sigma * n0 / n0_electron)
    else:
        rg2sd = 0.0

    energy_density2 = ((f_energy_upstream + gamma0 * u0 * e0) / ux_sk_grid[-1]
                       - f_px_upstream)
    eps_b2 = (bmag0 * comp_fac) ** 2 / (8 * math.pi * energy_density2)
    end_decay_rg = ((5.0e-3 / eps_b2) / rg2sd if rg2sd > 0.0
                    else math.inf)

    out = np.empty(len(x_grid_rg))
    for i, x_rg in enumerate(x_grid_rg):
        x_sd = x_rg * rg2sd
        if x_sd < -50.0:
            out[i] = max(1.04e-5 / abs(x_sd) ** 0.6, eps_b0)
        elif x_sd < 50.0:
            out[i] = 1.0e-4
        elif x_rg < end_decay_rg:
            out[i] = 5.0e-3 / x_sd
        else:
            out[i] = eps_b2
    return out
