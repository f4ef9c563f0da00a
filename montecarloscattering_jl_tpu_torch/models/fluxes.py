"""Far-upstream fluxes and Mach numbers.

Mirrors the Julia reference's src/initializers.jl:513-736:
  * upstream_fluxes   (Ellison+ 1996 nonrel / Double+ 2004 rel)
  * upstream_machs    (Fujimura & Kennel 1979; Gedalin 1993)
and F_update! (initializers.jl:1156-1222) used by fast push.

All parallel-shock (theta_B0 = 0) simplifications are kept as in the
reference: the oblique forms reduce trivially with B_z = 0.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..utils.constants import C_CGS, KB_CGS
from ..utils.params import BETA_REL_FL
from ..utils.species import Species

GAMMA_SPH = 5.0 / 3.0
XI_SPH = GAMMA_SPH / (GAMMA_SPH - 1.0)


def upstream_fluxes(species: Sequence[Species], bmag0: float,
                    theta_b0_deg: float, u0: float, beta0: float,
                    gamma0: float) -> tuple[float, float, float]:
    """(F_px, F_pz, F_energy) far upstream (initializers.jl:513-622).

    Units: F_px, F_pz in erg/cm^3 (momentum flux density), F_energy in
    erg/(cm^2 s).  F_energy excludes the rest-mass-energy flux, matching
    what the MC tallies track.
    """
    p0 = sum(s.number_density * s.temperature for s in species) * KB_CGS
    rho0 = sum(s.number_density * s.mass for s in species)
    e0 = rho0 * C_CGS**2 + p0 / (GAMMA_SPH - 1.0)

    b_x = bmag0 * math.cos(math.radians(theta_b0_deg))
    b_z = bmag0 * math.sin(math.radians(theta_b0_deg))

    if beta0 >= BETA_REL_FL:
        # Double+ (2004) Eqs 20-26 (initializers.jl:572-621)
        f_px_fl = (gamma0 * beta0) ** 2 * (e0 + p0) + p0
        f_px_em = gamma0**2 * ((beta0 * bmag0) ** 2 + b_z**2 - b_x**2) / (8 * math.pi)
        f_px = f_px_fl + f_px_em
        f_pz = -gamma0 * b_x * b_z / (4 * math.pi)
        f_en_fl = gamma0**2 * beta0 * (e0 + p0)
        f_en_em = gamma0**2 * beta0 * b_z**2 / (4 * math.pi)
        f_energy = C_CGS * (f_en_fl + f_en_em) - gamma0 * u0 * rho0 * C_CGS**2
    else:
        # nonrelativistic, expanded to O(beta^2) (initializers.jl:565-609)
        u_b = b_z**2 / (8 * math.pi)
        f_px = (rho0 * u0**2 * (1 + beta0**2)
                + p0 * (1 + XI_SPH * beta0**2) + u_b)
        f_pz = -b_x * b_z / (4 * math.pi)
        f_energy = (rho0 * u0**3 * (1 + 1.25 * beta0**2) / 2.0
                    + p0 * u0 * XI_SPH * (1 + beta0**2)
                    + u0 * b_z**2 / (4 * math.pi))
    return f_px, f_pz, f_energy


def upstream_machs(beta0: float, species: Sequence[Species], bmag0: float
                   ) -> tuple[float, float]:
    """(sonic, Alfven) Mach numbers (initializers.jl:642-736)."""
    p0 = sum(s.number_density * s.temperature for s in species) * KB_CGS
    rho0 = sum(s.number_density * s.mass for s in species)
    u = beta0 * C_CGS
    relativistic = beta0 >= BETA_REL_FL

    if relativistic:
        # Fujimura & Kennel (1979) Eq 13
        r = p0 / (rho0 * C_CGS**2)
        a = GAMMA_SPH / (GAMMA_SPH - 1.0)
        cs = C_CGS * math.sqrt(GAMMA_SPH * r / (a * r + 1.0))
        # Gedalin (1993) Eq 46
        enthalpy = a * p0 + rho0 * C_CGS**2
        va = C_CGS / math.sqrt(1.0 + 4 * math.pi * enthalpy / bmag0**2)
    else:
        cs = math.sqrt(GAMMA_SPH * p0 / rho0)
        va = bmag0 / math.sqrt(4 * math.pi * rho0)
    return u / cs, u / va


def fast_push_fluxes(species: Sequence[Species], i_stop: int,
                     u0: float, gamma0: float,
                     gamma_sf_grid: np.ndarray, ux_sk_grid: np.ndarray,
                     nb: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Analytic flux backfill for grid boundaries skipped by fast push
    (F_update!, initializers.jl:1156-1222).

    Returns (pxx_flux, pxz_flux, energy_flux) arrays of length nb with
    entries 1..i_stop filled.
    """
    p0 = sum(s.number_density * s.temperature for s in species) * KB_CGS
    rho0 = sum(s.number_density * s.mass for s in species)
    beta0 = u0 / C_CGS
    relativistic = beta0 >= BETA_REL_FL

    pxx = np.zeros(nb)
    pxz = np.zeros(nb)
    energy = np.zeros(nb)
    for i in range(1, i_stop + 1):
        u_curr = ux_sk_grid[i]
        b_curr = u_curr / C_CGS
        g_curr = gamma_sf_grid[i]
        gb_curr = g_curr * b_curr
        density_ratio = (gamma0 * u0) / (g_curr * u_curr)
        rho_curr = rho0 * density_ratio
        p_curr = p0 * density_ratio**GAMMA_SPH
        if not relativistic:
            pxx[i] = (rho_curr * u_curr**2 * (1 + b_curr**2)
                      + p_curr * (1 + XI_SPH * b_curr**2))
            energy[i] = (rho_curr / 2 * u_curr**3 * (1 + 1.25 * b_curr**2)
                         + p_curr * u_curr * XI_SPH * (1 + b_curr**2))
        else:
            e_curr = rho_curr * C_CGS**2
            pxx[i] = p_curr + gb_curr**2 * (e_curr + XI_SPH * p_curr)
            energy[i] = (gb_curr * g_curr * C_CGS * (e_curr + XI_SPH * p_curr)
                         - gb_curr * C_CGS * e_curr)
    return pxx, pxz, energy
