"""Nonlinear shock smoothing: the per-iteration profile update.

Host-side O(n_grid) replacement for smoothers.jl:54-605 and the
iteration close-out pieces of iter_finalize.jl:1-146.  The per-zone
flux-conservation solves are tiny (99 zones x 2 equations), so they
stay in NumPy with analytic/Newton roots rather than on-device.

Note: the reference's nonrelativistic branch references undefined
variables (smoothers.jl:519 `ux_guess`) and so cannot run; the
relativistic branch (smoothers.jl:351-458) is the working spec and the
nonrelativistic form here is the same scheme with the documented
O(beta^2)-expanded fluxes.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np

from ..utils.constants import C_CGS, KB_CGS, MP_CGS
from ..utils.params import BETA_REL_FL
from ..utils.rootfind import newton
from .profile import ShockProfile, turbulence_b_factor


@dataclass
class SmoothDiagnostics:
    """Per-zone diagnostics written to mc_grid.dat
    (smoothers.jl:111-277)."""

    pxx_norm: np.ndarray
    pxz_norm: np.ndarray
    energy_norm: np.ndarray
    pressure_px: np.ndarray
    pressure_energy: np.ndarray
    pressure_tot_mc: np.ndarray
    pressure_aniso: np.ndarray
    pressure_px_tp: float
    pressure_energy_tp: float


def set_gamma_adiab_grid(gamma_grid: np.ndarray, i_iter: int,
                         x_grid_cm: np.ndarray, gamma2_rh: float,
                         p_psd_par: np.ndarray, p_psd_perp: np.ndarray,
                         energy_density_psd: np.ndarray) -> np.ndarray:
    """Two-column adiabatic-index grid (set_Gamma_adiab_grid!,
    iter_finalize.jl:128-146): column 0 = pre-iteration, column 1 =
    from this iteration's pressures."""
    nb = len(p_psd_par)
    if i_iter == 0:
        up = x_grid_cm[:nb] <= 0.0
        gamma_grid[:, 0] = np.where(up, 5.0 / 3.0, gamma2_rh)
    else:
        gamma_grid[:, 0] = gamma_grid[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        g = 1.0 + (p_psd_par + p_psd_perp) / energy_density_psd
    g = np.where(energy_density_psd <= 1e-90, 1e-99, g)
    gamma_grid[:, 1] = g
    return gamma_grid


def smooth_profile_inplace(y: np.ndarray, lo: int, hi: int) -> None:
    """Monotonicity sweep + 3-point smoothing over boundary indices
    [lo, hi] inclusive (smooth_profile!, smoothers.jl:583-604)."""
    for i in range(hi, lo, -1):
        if y[i - 1] < y[i]:
            y[i - 1] = y[i]
    dup = y.copy()
    dup[lo + 1] = (2 * y[lo] + y[lo + 1] + y[lo + 2]) / 4.0
    for i in range(lo + 2, hi - 1):
        dup[i] = (y[i - 1] + y[i] + y[i + 1]) / 3.0
    dup[hi - 1] = (y[hi - 2] + y[hi - 1] + 2 * y[hi]) / 4.0
    y[lo + 1:hi] = dup[lo + 1:hi]


def _rescale(u_new: np.ndarray, lo: int, hi: int, u0: float, u2: float,
             x_grid_rg: np.ndarray) -> bool:
    """Rescale so the profile spans exactly (u0 -> u2), pinning the
    downstream side (smoothers.jl:437-454).

    Returns False when the solve is DEGENERATE: if the per-zone flux
    solves came out (near-)flat — a dead or starved population gives
    Gamma_grid -> 1, xi = Gamma/(Gamma-1) -> 1e6, and every zone
    solves to the same tiny velocity — the span (u_new[lo] - avg_dw)
    vanishes and no rescale can recover the (u0 -> u2) boundary
    conditions.  The round-7 gamma0=5 science run hit exactly this:
    fac = 0 silently flattened the WHOLE profile to u2, the
    old-profile averaging then relaxed the far-upstream inflow toward
    u2 by half per iteration, and the shock evaporated (STATUS.md
    round 7).  Callers keep the previous profile instead."""
    avg_dw = u_new[hi - 9:hi + 1].mean()
    denom = u_new[lo] - avg_dw
    if abs(denom) < 1e-3 * abs(u0 - u2):
        return False
    fac = (u0 - u2) / denom
    u_new[lo:hi + 1] = fac * (u_new[lo:hi + 1] - avg_dw) + u2
    u_new[lo:hi + 1] = np.where(x_grid_rg[lo:hi + 1] >= 0.0, u2,
                                u_new[lo:hi + 1])
    return True


def new_velocity_profile(relativistic: bool, n0: float, u0: float,
                         beta0: float, gamma0: float, u2: float,
                         pxx_flux: np.ndarray, energy_flux: np.ndarray,
                         q_esc_px: float, q_esc_en: float,
                         x_grid_rg: np.ndarray, ux_sk: np.ndarray,
                         gamma_sf: np.ndarray, gamma_grid: np.ndarray,
                         btot: np.ndarray, theta: np.ndarray,
                         omega: float, pressure_tot_mc: np.ndarray,
                         f_px_up: float, f_en_up: float,
                         smooth_mom_energy_fac: float) -> np.ndarray:
    """Per-zone solve of the momentum and energy flux-conservation
    relations for the new velocity (new_velocity_profile,
    smoothers.jl:351-570).  Returns ux over boundary indices 1..nb-2.
    """
    nb = len(ux_sk)
    lo, hi = 1, nb - 2
    q_px_flux = q_esc_px * pxx_flux[lo]
    q_en_flux = q_esc_en * energy_flux[lo]
    if not relativistic:
        q_px_flux = 0.0  # smoothers.jl:470

    u_px = np.zeros(nb)
    u_en = np.zeros(nb)
    rho0 = n0 * MP_CGS

    for i in range(lo, hi + 1):
        bx = btot[i] * math.cos(theta[i])
        bz = btot[i] * math.sin(theta[i])
        g = gamma_sf[i]
        bu = ux_sk[i] / C_CGS
        gb = g * bu
        gpost = max(gamma_grid[i, 1], 1.0 + 1e-6)
        xi = gpost / (gpost - 1.0)

        pxx_em = (gb**2 * btot[i]**2 / (8 * math.pi)
                  + g**2 * (bz**2 - bx**2) / (8 * math.pi))
        en_em = g**2 * bu * bz**2 / (4 * math.pi) * C_CGS

        if relativistic:
            density_loc = gamma0 * beta0 / gb * n0
            pres_px = ((pxx_flux[i] - gb**2 * density_loc * MP_CGS
                        * C_CGS**2)
                       / (1.0 + gb**2 * xi))
            pres = (1.0 - omega) * pres_px + omega * pressure_tot_mc[i]
            pres = max(pres, 1e-99)

            # momentum equation is linear in gamma*beta
            # (smoothers.jl:404-409)
            coeff = gamma0 * beta0 * n0 * (
                MP_CGS * C_CGS**2 + pres * xi / density_loc)
            rhs = f_px_up - q_px_flux - pxx_em - pres
            gb_new = rhs / coeff if coeff != 0 else gb
            gb_new = max(gb_new, 1e-12)
            u_px[i] = gb_new / math.sqrt(1.0 + gb_new**2) * C_CGS

            # energy equation: gb*sqrt(1+gb^2) = rhs/k, quadratic in
            # gb^2 (smoothers.jl:414-420)
            k = C_CGS * (density_loc * MP_CGS * C_CGS**2 + xi * pres)
            rhs = f_en_up - q_en_flux - en_em
            a = rhs / k if k != 0 else gb
            # gb^2 (1+gb^2) = a^2 -> gb^2 = (-1+sqrt(1+4a^2))/2
            gb2 = (-1.0 + math.sqrt(1.0 + 4.0 * a * a)) / 2.0
            gb_new = math.sqrt(max(gb2, 1e-24)) * math.copysign(1.0, a)
            gb_new = max(gb_new, 1e-12)
            u_en[i] = gb_new / math.sqrt(1.0 + gb_new**2) * C_CGS
        else:
            pres_px = ((pxx_flux[i] - rho0 * u0 * ux_sk[i]
                        * (1.0 + bu**2))
                       / (1.0 + bu**2 * xi))
            pres = (1.0 - omega) * pres_px + omega * pressure_tot_mc[i]
            pres = max(pres, 1e-99)

            def fp(b):
                u = b * C_CGS
                return (f_px_up - q_px_flux - pxx_em
                        - rho0 * u0 * u * (1.0 + b**2)
                        - (1.0 + b**2 * xi) * pres)

            b_new = newton(fp, beta0 * 1.0e-4)
            u_px[i] = max(b_new, 1e-12) * C_CGS

            def fe(u):
                b = u / C_CGS
                return (f_en_up - q_en_flux - en_em
                        - 0.5 * rho0 * u0 * u**2 * (1.0 + 1.25 * b**2)
                        - xi * pres * u * (1.0 + b**2))

            u_en[i] = max(newton(fe, u0 * 1.0e-4), 1.0)

    if relativistic:
        # Downstream (x >= 0) is u2 BY CONSTRUCTION — the reference
        # forces it after rescaling (smoothers.jl:441-443, 449-451);
        # here the constraint lands BEFORE the monotonicity sweep.
        # Rationale (round-5 root cause of the gamma0=5 freeze): the
        # far-downstream flux tallies are structurally starved — the
        # PRP culls everything but the highest-energy particles long
        # before the last grid zones, so pxx_flux there falls to
        # O(1e-2) of F_px and those zones solve to u ~ u0.  Fed into
        # smooth_profile_inplace, that garbage propagates UPSTREAM
        # through the monotone sweep (y[i-1] = max(y[i-1], y[i])) and
        # flattens the entire precursor to u0 (span -> 0, degenerate
        # rescale, frozen profile — the round-7 failure).  Pinning
        # x >= 0 to u2 first keeps the sweep inside the precursor,
        # makes avg_dw exactly u2, and turns the rescale factor into
        # ~1 — so the precursor depth is what the flux solve actually
        # supports instead of a noise-amplified stretch, and a
        # dead-tally iteration relaxes toward the step profile rather
        # than evaporating the shock.
        dw = x_grid_rg[lo:hi + 1] >= 0.0
        u_px[lo:hi + 1] = np.where(dw, u2, u_px[lo:hi + 1])
        u_en[lo:hi + 1] = np.where(dw, u2, u_en[lo:hi + 1])
        smooth_profile_inplace(u_px, lo, hi)
        smooth_profile_inplace(u_en, lo, hi)
        ok = _rescale(u_px, lo, hi, u0, u2, x_grid_rg)
        ok &= _rescale(u_en, lo, hi, u0, u2, x_grid_rg)
    else:
        ok = _rescale(u_px, lo, hi, u0, u2, x_grid_rg)
        ok &= _rescale(u_en, lo, hi, u0, u2, x_grid_rg)
        smooth_profile_inplace(u_px, lo, hi)
        smooth_profile_inplace(u_en, lo, hi)

    if not ok:
        return None
    return ((1.0 - smooth_mom_energy_fac) * u_px
            + smooth_mom_energy_fac * u_en)


def smooth_grid(i_iter: int, i_shock: int, prof: ShockProfile,
                cfg, x_grid_rg: np.ndarray, gamma_grid: np.ndarray,
                p_psd_par: np.ndarray, p_psd_perp: np.ndarray,
                pxx_flux: np.ndarray, energy_flux: np.ndarray,
                q_esc_px_avg: float, q_esc_en_avg: float,
                f_px_up: float, f_en_up: float, gamma2_rh: float,
                u2: float, beta2: float, gamma2: float,
                prof_weight_fac: float,
                species_n0: float, species_t0: float, rho0: float,
                eps_b_override: bool
                ) -> tuple[ShockProfile, SmoothDiagnostics, float]:
    """One smoothing pass (smooth_grid_par, smoothers.jl:54-349):
    diagnostics, new velocity profile, artificial smoothing, old-profile
    averaging, and rebuilt gamma / B / eps_B grids.

    Returns (new profile, diagnostics, updated prof_weight_fac).
    """
    nb = len(prof.ux_sk)
    n0 = rho0 / MP_CGS
    p0 = species_n0 * species_t0 * KB_CGS
    e_rest = n0 * MP_CGS * C_CGS**2
    u0, beta0, gamma0 = cfg.u0, cfg.beta0, cfg.gamma0

    # profile-weighting damping schedule (smoothers.jl:95-98)
    if cfg.do_prof_fac_damp and i_iter != 0:
        prof_weight_fac *= 1.15 if i_iter < 5 else 1.5
        prof_weight_fac = min(10.0, prof_weight_fac)

    # ---- diagnostics (smoothers.jl:111-277) --------------------------------
    with np.errstate(divide="ignore", invalid="ignore"):
        g = prof.gamma_sf
        bu = prof.ux_sk / C_CGS
        gb = g * bu
        bx = prof.btot * np.cos(prof.theta)
        bz = prof.btot * np.sin(prof.theta)
        pxx_em = (gb**2 * prof.btot**2 / (8 * np.pi)
                  + g**2 * (bz**2 - bx**2) / (8 * np.pi))
        en_em = g**2 * bu * bz**2 / (4 * np.pi) * C_CGS
        pxx_norm = (pxx_flux + pxx_em) / f_px_up
        energy_norm = (energy_flux + en_em) / f_en_up

        gpre = np.maximum(gamma_grid[:, 0], 1.0 + 1e-9)
        xi_pre = gpre / (gpre - 1.0)
        density_ratio = gamma0 * beta0 / np.maximum(gb, 1e-30)
        pres_px = ((f_px_up * (1.0 - q_esc_px_avg)
                    - gb**2 * density_ratio * e_rest)
                   / (1.0 + gb**2 * xi_pre))
        pres_en = ((f_en_up * (1.0 - q_esc_en_avg)
                    + gamma0 * beta0 * C_CGS * e_rest
                    - g**2 * prof.ux_sk * density_ratio * e_rest)
                   / (g**2 * prof.ux_sk * xi_pre))
        pres_px = np.maximum(pres_px, 1e-99)
        pres_en = np.maximum(pres_en, 1e-99)
        pressure_tot_mc = p_psd_par + p_psd_perp
        aniso = 2.0 * p_psd_par / np.maximum(p_psd_perp, 1e-300)

        # test-particle downstream pressures (smoothers.jl:219-226)
        ppx_tp = ((f_px_up - gamma2 * beta2 * gamma0 * e_rest)
                  / (1.0 + (gamma2 * beta2) ** 2 * gamma2_rh
                     / (gamma2_rh - 1.0)))
        pen_tp = ((f_en_up + gamma0 * u0 * e_rest * (1.0 - gamma2))
                  / (gamma2**2 * u2 * gamma2_rh / (gamma2_rh - 1.0)))

    # pxz_norm: for a parallel shock the z-momentum flux is irrelevant
    # and the reference hardcodes the column to 1e-99
    # (smoothers.jl:182-185); kept identical for mc_grid.dat parity.
    diag = SmoothDiagnostics(
        pxx_norm=pxx_norm, pxz_norm=np.full(nb, 1e-99),
        energy_norm=energy_norm, pressure_px=pres_px,
        pressure_energy=pres_en, pressure_tot_mc=pressure_tot_mc,
        pressure_aniso=aniso, pressure_px_tp=ppx_tp,
        pressure_energy_tp=pen_tp)

    if not cfg.do_smoothing:
        return prof, diag, prof_weight_fac

    # diagnostic capture of everything the per-zone flux solve consumes
    # (MCS_SMOOTH_DUMP=<dir> writes smooth_inputs_iterNN.npz), so solver
    # conditioning can be developed offline against recorded on-chip
    # tallies instead of re-running the science workload per experiment
    import os as _os
    dump_dir = _os.environ.get("MCS_SMOOTH_DUMP", "")
    if dump_dir:
        _os.makedirs(dump_dir, exist_ok=True)
        np.savez(
            _os.path.join(dump_dir, f"smooth_inputs_iter{i_iter:02d}.npz"),
            i_iter=i_iter, i_shock=i_shock, x_grid_rg=x_grid_rg,
            gamma_grid=gamma_grid, p_psd_par=p_psd_par,
            p_psd_perp=p_psd_perp, pxx_flux=pxx_flux,
            energy_flux=energy_flux, q_esc_px_avg=q_esc_px_avg,
            q_esc_en_avg=q_esc_en_avg, f_px_up=f_px_up,
            f_en_up=f_en_up, gamma2_rh=gamma2_rh, u2=u2, beta2=beta2,
            gamma2=gamma2, prof_weight_fac=prof_weight_fac,
            species_n0=species_n0, species_t0=species_t0, rho0=rho0,
            ux_sk=prof.ux_sk, gamma_sf=prof.gamma_sf, btot=prof.btot,
            theta=prof.theta, u0=cfg.u0, beta0=cfg.beta0,
            gamma0=cfg.gamma0,
            omega=cfg.smooth_pressure_flux_psd_fac,
            smooth_mom_energy_fac=cfg.smooth_mom_energy_fac)

    # ---- new velocity profile ----------------------------------------------
    relativistic = beta0 >= BETA_REL_FL
    ux_new = new_velocity_profile(
        relativistic, n0, u0, beta0, gamma0, u2, pxx_flux, energy_flux,
        q_esc_px_avg, q_esc_en_avg, x_grid_rg, prof.ux_sk, prof.gamma_sf,
        gamma_grid, prof.btot, prof.theta, cfg.smooth_pressure_flux_psd_fac,
        pressure_tot_mc, f_px_up, f_en_up, cfg.smooth_mom_energy_fac)
    if ux_new is None:
        # degenerate flux solve (dead/starved population): no profile
        # update can honor the (u0 -> u2) boundary conditions, so keep
        # the previous profile rather than flattening the shock away
        logging.getLogger(__name__).warning(
            "smoothing iteration %d: degenerate flux solve (starved "
            "tallies) — keeping the previous velocity profile", i_iter)
        return prof, diag, prof_weight_fac

    # artificial smoothing (smoothers.jl:306-312)
    if cfg.x_art_start_rg < 0:
        i_trans = int(np.searchsorted(x_grid_rg, cfg.x_art_start_rg)) - 1
        fac = (-(ux_new[i_trans] - ux_new[nb - 2])
               / math.atan(x_grid_rg[i_trans]))
        for i in range(i_trans, i_shock + 1):
            ux_new[i] = -math.atan(x_grid_rg[i]) * fac + ux_new[nb - 2]

    # average with the previous profile (smoothers.jl:318-320)
    sl = slice(1, nb - 1)
    ux_new[sl] = ((ux_new[sl] + prof_weight_fac * prof.ux_sk[sl])
                  / (1.0 + prof_weight_fac))
    ux_new[0] = ux_new[1]
    ux_new[nb - 1] = ux_new[nb - 2]

    # rebuild derived grids (smoothers.jl:324-346)
    new = prof.copy()
    new.ux_sk = ux_new
    new.utot = ux_new.copy()
    new.gamma_sf = 1.0 / np.sqrt(np.maximum(
        1.0 - (ux_new / C_CGS) ** 2, 1e-30))
    new.beta_ef = ((u0 - ux_new) / (C_CGS - u0 * ux_new / C_CGS))
    new.gamma_ef = 1.0 / np.sqrt(np.maximum(1.0 - new.beta_ef**2, 1e-30))
    for i in range(nb):
        amp = turbulence_b_factor(gamma0, u0, new.gamma_sf[i], ux_new[i],
                                  cfg.bturb_comp_frac, cfg.bfield_amp)
        new.btot[i] = cfg.bmag0 * amp
        if eps_b_override:
            e_dens = ((f_en_up + gamma0 * u0 * e_rest) / ux_new[i]
                      - f_px_up)
            new.btot[i] = math.sqrt(max(
                8 * math.pi * prof.eps_b[i] * e_dens, 0.0))
    new.bmag2 = float(new.btot[nb - 2])
    return new, diag, prof_weight_fac
