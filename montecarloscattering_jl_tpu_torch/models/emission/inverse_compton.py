"""Inverse-Compton emission off the CMB photon field.

Re-derives inverse_compton.jl:191-383 (the Jones 1968 Eq 9
single-scattering kernel + blackbody photon field) as an einsum over
(electron bin, seed-photon bin, outgoing-photon bin).
"""

from __future__ import annotations

import math

import numpy as np

from ...utils.constants import (
    C_CGS,
    H_CGS,
    KB_CGS,
    ME_C2,
    ME_CGS,
    MEV_ERG,
    QE_CGS,
    T_CMB0,
)
from ...utils.params import E_REL_PT

# Wien displacement constant in frequency (inverse_compton.jl:163)
WIENS_B_NU = 5.879e10   # Hz / K
N_NU = 60               # seed-photon frequency bins


def cmb_photon_field(redshift: float) -> tuple[np.ndarray, np.ndarray]:
    """(E_gamma / me c^2, photon number density per bin [1/cm^3]) of
    the CMB at the source redshift (photon_field!,
    inverse_compton.jl:313-383)."""
    temp = T_CMB0 * (1.0 + redshift)
    nu_peak = WIENS_B_NU * temp
    nu_min, nu_max = nu_peak / 30.0, nu_peak * 20.0
    log_nu = np.linspace(math.log10(nu_min), math.log10(nu_max),
                         N_NU + 1)
    nu1 = 10.0 ** log_nu[:-1]
    nu2 = 10.0 ** log_nu[1:]
    nu = np.sqrt(nu1 * nu2)
    con1 = 8.0 * math.pi * H_CGS / C_CGS**3
    con2 = H_CGS / (KB_CGS * temp)
    exp_fac = np.exp(np.minimum(con2 * nu, 200.0))
    u_nu = (nu2 - nu1) * con1 * nu**3 / (exp_fac - 1.0)
    e_ph = H_CGS * nu
    return e_ph / ME_C2, u_nu / e_ph


def ic_photon_energy_grid(e_min_mev: float, n_photon: int,
                          bins_per_dec: int) -> np.ndarray:
    """Outgoing photon energies in electron-rest-mass units
    (inverse_compton.jl:200-208)."""
    a_min = math.log10(e_min_mev * MEV_ERG / ME_C2)
    return 10.0 ** (a_min + np.arange(n_photon) / bins_per_dec)


def ic_emission(d2n_slice: np.ndarray, p_edges: np.ndarray,
                cos_bounds: np.ndarray, alpha_out: np.ndarray,
                redshift: float, jet_sph_frac: float, dist_lum: float,
                mc: float,
                seed: tuple[np.ndarray, np.ndarray] | None = None
                ) -> np.ndarray:
    """Observed IC spectrum of one zone [erg/(s cm^2)] per log energy
    bin (IC_emission_FCJ, inverse_compton.jl:191-311).

    d2n_slice: particle counts [n_mom+1, n_theta+1] (per bin, NOT per
    dp) in the ISM frame; p_edges momentum bin edges; cos_bounds the
    true pitch-cosine bounds (ascending); alpha_out the outgoing grid
    in me c^2 units.

    seed: optional (E_seed / me c^2, photon number density per bin
    [1/cm^3]) replacing the CMB field — the hook the SSC pass uses
    with the zone's own synchrotron photons (the loop the reference
    scoped but never finished, synch_emission.jl:78-105).
    """
    # jet-opening-angle pitch cut: only electrons aimed within the cone
    # reach the observer (inverse_compton.jl:210-214)
    jt_max = int(np.searchsorted(cos_bounds, 2.0 * jet_sph_frac - 1.0))
    jt_max = max(jt_max, 1)
    n_e = d2n_slice[:, :jt_max].sum(axis=1)          # [n_mom+1]

    p1 = np.sqrt(p_edges[:-1] * p_edges[1:])
    gam = np.where(p1 / mc < E_REL_PT, 1.0, np.hypot(p1 / mc, 1.0))

    keep = n_e > 1.0e-99
    if not np.any(keep):
        return np.full(len(alpha_out), 1.0e-99)
    n_e, gam = n_e[keep], gam[keep]

    if seed is None:
        a1, n_ph = cmb_photon_field(redshift)        # [N_NU]
    else:
        a1, n_ph = seed
        use = n_ph > 1.0e-60 * max(n_ph.max(), 1e-300)
        if not np.any(use):
            return np.full(len(alpha_out), 1.0e-99)
        a1, n_ph = a1[use], n_ph[use]
    r0 = QE_CGS**2 / ME_C2                           # classical radius

    g = gam[:, None, None]
    al1 = a1[None, :, None]
    al = alpha_out[None, None, :]

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        q = al / (4.0 * al1 * g**2 * (1.0 - al / g))
        # Jones (1968) Eq 9 bracket
        brack = (2.0 * q * np.log(q) + (1.0 + 2.0 * q) * (1.0 - q)
                 + 8.0 * (al1 * g * q)**2 * (1.0 - q)
                 / (1.0 + 4.0 * al1 * g * q))
        norm = n_ph[None, :, None] * 2.0 * math.pi * r0**2 * C_CGS \
            / (al1 * g**2)
        d2n = norm * n_e[:, None, None] * brack
    d2n = np.where((al < g) & (q > 0) & (q <= 1.0) & np.isfinite(d2n)
                   & (d2n > 1.0e-60), d2n, 0.0)
    d2n_dtda = d2n.sum(axis=(0, 1))                  # [n_out]

    # flux at Earth over the jet beam (inverse_compton.jl:287-303)
    beam_area = 4.0 * math.pi * dist_lum**2 * max(jet_sph_frac, 1e-12)
    d2n_dtda = d2n_dtda / beam_area
    e_gamma = alpha_out * ME_C2
    ic_emis = d2n_dtda / ME_C2 * e_gamma**2          # dP/dlnE / area
    return np.where(ic_emis <= 1.0e-55, 1.0e-99, ic_emis)
