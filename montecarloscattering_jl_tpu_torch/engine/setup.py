"""Run setup: everything derived from the config before the main loops.

Covers the driver preamble of the reference
(MonteCarloScattering.jl:66-598): grid, PSD bins, jump conditions,
upstream fluxes, Mach numbers, photon shells, redshift, initial
profile, shock/FEB indices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models import grid as grid_mod
from ..models.fluxes import upstream_fluxes, upstream_machs
from ..models.profile import ShockProfile, setup_profile
from ..models.psd_bins import PsdBins, build_psd_bins
from ..models.rankine_hugoniot import calc_downstream, calc_rRH
from ..utils import constants as K
from ..utils.config import RunConfig
from ..utils.cosmology import get_redshift


@dataclass
class RunSetup:
    cfg: RunConfig
    x_grid_rg: np.ndarray
    x_grid_cm: np.ndarray
    x_grid_start: float
    x_grid_stop: float
    n_grid: int
    nb: int
    i_shock: int
    i_grid_feb: int
    bins: PsdBins
    f_px_upstream: float
    f_pz_upstream: float
    f_energy_upstream: float
    mach_sonic: float
    mach_alfven: float
    r_comp: float
    r_rh: float
    gamma2_rh: float
    beta2: float
    gamma2: float
    u2: float
    bmag2_init: float
    redshift: float
    b_cmbz: float
    electron_weight_fac: float
    n_pts_max: int
    x_shell_mid: np.ndarray | None = None
    x_shell_end: np.ndarray | None = None
    n_shell_endpoints: np.ndarray | None = None
    profile: ShockProfile = field(default=None)  # initial profile


def build_setup(cfg: RunConfig) -> RunSetup:
    """Derive the full static run state (MonteCarloScattering.jl:66-503)."""
    # jump conditions (MonteCarloScattering.jl:149-159)
    r_rh, gamma2_rh = calc_rRH(cfg.beta0, cfg.gamma0, cfg.species)
    r_comp = r_rh if cfg.r_comp == -1 else cfg.r_comp
    beta2, gamma2, bmag2, _, _ = calc_downstream(cfg.bmag0, r_comp, cfg.beta0)
    u2 = beta2 * K.C_CGS

    # grid (MonteCarloScattering.jl:263-266)
    x_grid_rg, x_start, x_stop = grid_mod.setup_grid(
        cfg.x_grid_start_rg, cfg.x_grid_stop_rg, cfg.use_prp,
        cfg.feb_downstream, cfg.rg0)
    x_grid_cm = x_grid_rg * cfg.rg0
    nb = len(x_grid_rg)
    n_grid = nb - 2
    i_shock = grid_mod.find_shock_index(x_grid_rg)
    i_grid_feb = grid_mod.find_feb_index(x_grid_cm, cfg.feb_upstream)

    # PSD bins (MonteCarloScattering.jl:276-338)
    bins = build_psd_bins(
        cfg.species, cfg.inp_distr, cfg.energy_inj, cfg.emin_therm_fac,
        cfg.emax, cfg.emax_per_aa, cfg.pmax, cfg.gamma0,
        cfg.psd_bins_per_dec_mom, cfg.psd_bins_per_dec_theta,
        cfg.psd_lin_cos_bins, cfg.psd_log_theta_decs)

    # photon shells (MonteCarloScattering.jl:341-412)
    x_shell_mid = x_shell_end = n_shell_end = None
    if cfg.do_photons:
        x_shell_mid, x_shell_end = grid_mod.set_photon_shells(
            cfg.num_upstream_shells, cfg.num_downstream_shells, cfg.use_prp,
            cfg.feb_upstream, cfg.feb_downstream, cfg.rg0,
            cfg.x_grid_stop_rg)
        n_shell_end = grid_mod.shell_zone_endpoints(
            x_grid_cm, x_shell_end, n_grid)

    # redshift from jet distance (MonteCarloScattering.jl:419-421)
    redshift = cfg.redshift
    if cfg.jet_dist_mpc > 0:
        redshift = get_redshift(cfg.jet_dist_mpc)
    b_cmbz = K.B_CMB0 * (1.0 + redshift) ** 2

    # fluxes and Machs (MonteCarloScattering.jl:442-448)
    f_px, f_pz, f_en = upstream_fluxes(
        cfg.species, cfg.bmag0, cfg.theta_b0, cfg.u0, cfg.beta0, cfg.gamma0)
    mach_s, mach_a = upstream_machs(cfg.beta0, cfg.species, cfg.bmag0)

    # initial profile (MonteCarloScattering.jl:451-474)
    prof = setup_profile(
        cfg.u0, cfg.beta0, cfg.gamma0, cfg.bmag0, cfg.theta_b0, r_comp,
        cfg.bturb_comp_frac, cfg.bfield_amp, cfg.use_custom_eps_b,
        cfg.species, f_px, f_en, x_grid_cm, x_grid_rg)

    # electron MC-weight ratio (MonteCarloScattering.jl:493); the
    # zero-density degenerate case gives inf in the reference — gate it
    n_e = cfg.species[-1].number_density
    e_weight_fac = 1.0 / n_e if n_e > 0 else 0.0

    return RunSetup(
        cfg=cfg, x_grid_rg=x_grid_rg, x_grid_cm=x_grid_cm,
        x_grid_start=x_start, x_grid_stop=x_stop, n_grid=n_grid, nb=nb,
        i_shock=i_shock, i_grid_feb=i_grid_feb, bins=bins,
        f_px_upstream=f_px, f_pz_upstream=f_pz, f_energy_upstream=f_en,
        mach_sonic=mach_s, mach_alfven=mach_a,
        r_comp=r_comp, r_rh=r_rh, gamma2_rh=gamma2_rh,
        beta2=beta2, gamma2=gamma2, u2=u2, bmag2_init=bmag2,
        redshift=redshift, b_cmbz=b_cmbz,
        electron_weight_fac=e_weight_fac,
        n_pts_max=max(cfg.n_pts_pcut, cfg.n_pts_pcut_hi),
        x_shell_mid=x_shell_mid, x_shell_end=x_shell_end,
        n_shell_endpoints=n_shell_end, profile=prof,
    )
