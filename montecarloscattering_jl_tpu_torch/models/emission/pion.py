"""pi0-decay gamma-ray emission from hadronic collisions.

Vectorized re-derivation of the Kafexhiu et al. (2014) [PhRvD 90,
123014] parametrization (KATV2014.jl:22-296) and the per-zone driver
pion_kafexhiu.jl:36-245.  All formula constants are from the paper's
Table VII / Eqs 1-15; i_data selects the GEANT4 (1), PYTHIA8 (2),
SIBYLL (3) or QGSJET (4) high-energy fits.
"""

from __future__ import annotations

import math

import numpy as np

from ...utils.constants import (
    C_CGS,
    E0_PI0_GEV,
    GAMMA_RES_GEV,
    GEV_ERG,
    M_RES_GEV,
    MEV_ERG,
    MP_GEV,
    T_TH_GEV,
)

_MB_CM2 = 1.0e-27   # millibarn in cm^2


def sigma_pi(tp: np.ndarray, i_data: int = 1) -> np.ndarray:
    """Inclusive pi0 production cross section [mb] vs proton kinetic
    energy Tp [GeV] (get_sigma_pi, KATV2014.jl:22-102)."""
    tp = np.asarray(tp, float)
    s_ecm = 2.0 * MP_GEV * (tp + 2.0 * MP_GEV)
    out = np.zeros_like(tp)

    # Tp < 2 GeV: resonance (Eqs 2-5)
    low = (tp >= T_TH_GEV) & (tp < 2.0)
    with np.errstate(invalid="ignore"):
        g2 = M_RES_GEV * math.hypot(M_RES_GEV, GAMMA_RES_GEV)
        kk = (math.sqrt(8.0) * M_RES_GEV * GAMMA_RES_GEV * g2
              / (math.pi * math.sqrt(M_RES_GEV**2 + g2)))
        f_bw = MP_GEV * kk / (
            ((np.sqrt(s_ecm) - MP_GEV) ** 2 - M_RES_GEV**2) ** 2
            + M_RES_GEV**2 * GAMMA_RES_GEV**2)
        eta = np.sqrt(np.maximum(
            (s_ecm - E0_PI0_GEV**2 - 4.0 * MP_GEV**2) ** 2
            - (4.0 * E0_PI0_GEV * MP_GEV) ** 2, 0.0)) \
            / (2.0 * E0_PI0_GEV * np.sqrt(s_ecm))
        s1 = 7.66e-3 * eta**1.95 * (1.0 + eta + eta**5) * f_bw**1.86
        s2 = np.where(tp < 2.0 * T_TH_GEV, 0.0,
                      5.7 / (1.0 + np.exp(-9.3 * (tp - 1.4))))
    out = np.where(low, s1 + s2, out)

    # inelastic cross section (Eq 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = tp / T_TH_GEV
        lr = np.log(np.maximum(ratio, 1e-12))
        sig_inel = ((30.7 - 0.96 * lr + 0.18 * lr**2)
                    * np.maximum(1.0 - ratio**-1.9, 0.0) ** 3)

    # 2 < Tp < 5 GeV: multiplicity fit (Eq 6)
    mid = (tp >= 2.0) & (tp < 5.0)
    q6 = (tp - T_TH_GEV) / MP_GEV
    n_pi_mid = -6.0e-3 + 0.237 * q6 - 0.023 * q6**2
    out = np.where(mid, n_pi_mid * sig_inel, out)

    # Tp >= 5 GeV: Eq 7 with model-dependent a1..a5
    if i_data == 2:
        hi_model = tp > 50.0
        a = (0.652, 0.0016, 0.488, 0.1928, 0.483)
    elif i_data == 3:
        hi_model = tp > 100.0
        a = (5.436, 0.254, 0.072, 0.075, 0.166)
    elif i_data == 4:
        hi_model = tp > 100.0
        a = (0.908, 0.0009, 6.089, 0.176, 0.448)
    else:
        hi_model = np.zeros_like(tp, bool)
        a = (0.728, 0.596, 0.491, 0.2503, 0.117)
    ag = (0.728, 0.596, 0.491, 0.2503, 0.117)  # GEANT4 fallback

    hi = tp >= 5.0
    with np.errstate(invalid="ignore"):
        xi = np.maximum((tp - 3.0) / MP_GEV, 1e-12)

        def npi(av):
            a1, a2, a3, a4, a5 = av
            return (a1 * xi**a4 * (1.0 + np.exp(-a2 * xi**a5))
                    * (1.0 - np.exp(-a3 * xi**0.25)))

        n_hi = np.where(hi_model, npi(a), npi(ag))
    out = np.where(hi, n_hi * sig_inel, out)
    return np.where(tp < T_TH_GEV, 0.0, out)


def amax_and_egmax(tp: np.ndarray, sig: np.ndarray, i_data: int = 1
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(E_gamma_max [GeV], Amax [mb/GeV]) (get_Amax,
    KATV2014.jl:223-296)."""
    tp = np.asarray(tp, float)
    s_ecm = 2.0 * MP_GEV * (tp + 2.0 * MP_GEV)
    sqrt_s = np.sqrt(s_ecm)
    e_pi_cm = (s_ecm - 4.0 * MP_GEV**2 + E0_PI0_GEV**2) / (2.0 * sqrt_s)
    g_cm = (tp + 2.0 * MP_GEV) / sqrt_s
    b_cm = np.sqrt(np.maximum(1.0 - 1.0 / g_cm**2, 0.0))
    p_pi_cm = np.sqrt(np.maximum(e_pi_cm**2 - E0_PI0_GEV**2, 0.0))
    emax_lab = g_cm * (e_pi_cm + p_pi_cm * b_cm)
    g_lab = np.maximum(emax_lab / E0_PI0_GEV, 1.0 + 1e-12)
    b_lab = np.sqrt(np.maximum(1.0 - 1.0 / g_lab**2, 0.0))
    eg_max = E0_PI0_GEV / 2.0 * g_lab * (1.0 + b_lab)

    theta = tp / MP_GEV
    lo = tp < 1.0
    with np.errstate(divide="ignore", invalid="ignore"):
        amax_lo = 5.9 * sig / np.maximum(emax_lab, 1e-12)
    if i_data == 1:
        b_lo5 = (9.53, 0.52, 0.054)
    else:
        b_lo5 = None
    if i_data == 2:
        b_hi, hi_thresh = (9.06, 0.3795, 0.01105), 50.0
    elif i_data == 3:
        b_hi, hi_thresh = (10.77, 0.412, 0.01264), 100.0
    elif i_data == 4:
        b_hi, hi_thresh = (13.16, 0.4419, 0.01439), 100.0
    else:
        b_hi, hi_thresh = None, np.inf
    b_def = (9.13, 0.35, 0.0097)

    def amax_form(bv):
        b1, b2, b3 = bv
        return (b1 * theta**(-b2) * sig / MP_GEV
                * np.exp(b3 * np.log(np.maximum(theta, 1e-12)) ** 2))

    amax = amax_form(b_def)
    if b_lo5 is not None:
        amax = np.where(tp < 5.0, amax_form(b_lo5), amax)
    if b_hi is not None:
        amax = np.where(tp > hi_thresh, amax_form(b_hi), amax)
    amax = np.where(lo, amax_lo, amax)
    return eg_max, amax


def f_func(tp: np.ndarray, eg: np.ndarray, eg_max: np.ndarray,
           i_data: int = 1) -> np.ndarray:
    """Spectral shape F(Tp, Eg) (get_Ffunc, KATV2014.jl:140-211).

    tp, eg_max: [n_p]; eg: [n_g]; returns [n_p, n_g].
    """
    tp = np.asarray(tp, float)[:, None]
    egm = np.asarray(eg_max, float)[:, None]
    eg = np.asarray(eg, float)[None, :]

    with np.errstate(divide="ignore", invalid="ignore"):
        yg = eg + E0_PI0_GEV**2 / (4.0 * eg)
        ymax = egm + E0_PI0_GEV**2 / (4.0 * egm)
        xg = (yg - E0_PI0_GEV) / np.maximum(ymax - E0_PI0_GEV, 1e-30)

        theta = tp / MP_GEV
        kappa = 3.29 - 0.2 * theta**(-1.5)
        f_low = np.maximum(1.0 - xg, 0.0) ** kappa     # Eq 14, Tp < 1

        q = (tp - 1.0) / MP_GEV
        mu = 1.25 * np.maximum(q, 0.0) ** 1.25 * np.exp(-1.25 * q)

        def f_param(lam, alpha, beta, gam):
            cc = lam * E0_PI0_GEV / ymax
            return (np.maximum(1.0 - xg**alpha, 0.0) ** beta
                    / (1.0 + xg / cc) ** gam)

        f_geant_low = f_param(3.0, 1.0, mu + 2.45, mu + 1.45)
        f_geant_mid = f_param(3.0, 1.0, 1.5 * mu + 4.95, mu + 1.5)
        if i_data == 1:
            f_hi = f_param(3.0, 0.5, 4.9, 1.0)
            hi_thresh = 100.0
        elif i_data == 2:
            f_hi = f_param(3.5, 0.5, 4.0, 1.0)
            hi_thresh = 50.0
        elif i_data == 3:
            f_hi = f_param(3.55, 0.5, 3.6, 1.0)
            hi_thresh = 100.0
        else:
            f_hi = f_param(3.55, 0.5, 4.5, 1.0)
            hi_thresh = 100.0
        f_def = f_param(3.0, 0.5, 4.2, 1.0)

    out = np.where(tp < 1.0, f_low,
                   np.where(tp < 4.0, f_geant_low,
                            np.where(tp < 20.0, f_geant_mid,
                                     np.where(tp > hi_thresh, f_hi,
                                              f_def))))
    return np.where((xg < 0) | (xg > 1) | ~np.isfinite(xg), 0.0, out)


def heavy_nuclei_scaling(aa: float, aa_ion, n0_ion) -> float:
    """Baring+ (1999) Eq 26 A^0.375 scaling summed over target species
    (pion_kafexhiu.jl:58-63)."""
    s = 0.0
    for a_i, n_i in zip(aa_ion, n0_ion):
        if a_i >= 1:
            s += (aa**0.375 + a_i**0.375 - 1.0) ** 2 * n_i / n0_ion[0]
    return s


def pion_emission(dn_counts: np.ndarray, p_edges: np.ndarray,
                  e_gamma: np.ndarray, target_density: float, aa: float,
                  mc: float, aa_ion, n0_ion, i_data: int = 1
                  ) -> np.ndarray:
    """dP/d(lnE) [erg/s] of pi0-decay photons for one zone
    (pion_kafexhiu.jl:36-245).

    dn_counts: particle counts per momentum bin; p_edges the bin edges
    [g cm/s]; e_gamma the photon grid [erg]; target_density [cm^-3].
    """
    scaling = heavy_nuclei_scaling(aa, aa_ion, n0_ion)
    mass = mc / C_CGS
    e0_erg = mc * C_CGS

    p2 = p_edges[:-1] * p_edges[1:]
    gam = np.sqrt(1.0 + p2 / mc**2)
    tp = (gam - 1.0) * e0_erg / GEV_ERG / aa     # kinetic energy/nucleon
    vel = np.sqrt(p2) / (gam * mass)

    keep = (dn_counts > 1.0e-99) & (tp >= T_TH_GEV)
    if not np.any(keep):
        return np.full(len(e_gamma), 1.0e-99)
    tpk, velk, nk = tp[keep], vel[keep], dn_counts[keep]

    sig = sigma_pi(tpk, i_data)
    eg_max, amax = amax_and_egmax(tpk, sig, i_data)
    eg_gev = e_gamma / GEV_ERG
    ff = f_func(tpk, eg_gev, eg_max, i_data)         # [n_p, n_g]
    # dsigma/dlnE = Amax * F * Eg; production rate x target density and
    # primary velocity; x Eg again for dP/dlnE (pion_kafexhiu.jl:140-153)
    dsig = amax[:, None] * ff * eg_gev[None, :]
    rate = (target_density * nk[:, None] * velk[:, None]
            * dsig * _MB_CM2)
    emis = (rate * e_gamma[None, :]).sum(axis=0)
    return np.where(emis < 1.0e-99, 1.0e-99, emis * scaling)
