"""Top-level run driver: iteration fixed point + per-ion reductions.

Counterpart of the JAX package's engine/driver.py (run, ion_finalize;
MonteCarloScattering.jl:600-654, iter_finalize.jl:1-146,
ion_finalize.jl:1-84) on one device, without mesh, checkpoint or
resume.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.config import RunConfig, load_config
from ..utils.tracing import PhaseTimers
from ..models.emission import photon_calcs
from ..models.rankine_hugoniot import q_esc_calcs
from ..models.smoothing import (
    SmoothDiagnostics, set_gamma_adiab_grid, smooth_grid)
from ..ops import reduce as red
from ..ops.finish import EscapeTallies
from .run import IonResult, IterationTallies, TransportEngine
from .setup import RunSetup, build_setup

log = logging.getLogger("mcs.torch.driver")


@dataclass
class IonFinal:
    """Per-(iteration, ion) reduction products (ion_finalize.jl:1-84)."""

    dndp_therm: np.ndarray      # [n_mom+1, nb, 3] normalized dN/dp
    dndp_cr: np.ndarray         # [n_mom+1, nb, 3]
    zone_pop: np.ndarray        # [nb]
    zone_vol: np.ndarray
    p_psd_par: np.ndarray       # [nb]
    p_psd_perp: np.ndarray
    energy_density_psd: np.ndarray
    d2n_ef: np.ndarray | None   # ISM-frame d2N/(dp dcos)
    esc: EscapeTallies
    psd: np.ndarray
    therm_psd: np.ndarray
    num_crossings: np.ndarray
    spectra_sf: np.ndarray      # x_spec detector spectra [n_mom+1, nx]
    spectra_pf: np.ndarray
    n_pushes: int
    n_trajectories: int
    # the port's own counters (engine/run.py IonResult)
    reason_counts: np.ndarray = None
    retro_entries: float = 0.0
    energy_received: float = 0.0
    energy_radiated: float = 0.0


@dataclass
class IterationResult:
    ion_finals: list
    tallies: IterationTallies
    diag: SmoothDiagnostics
    gamma_downstream: float
    q_esc_px: float
    q_esc_en: float
    px_esc_frac: float
    en_esc_frac: float
    profile_after: object = None
    emission: object = None     # models.emission.EmissionResult


@dataclass
class RunResult:
    setup: RunSetup
    iterations: list = field(default_factory=list)
    wall_time: float = 0.0
    n_pushes: int = 0
    n_trajectories: int = 0
    timers: object = None

    @property
    def last(self) -> IterationResult:
        return self.iterations[-1]


def ion_finalize(setup: RunSetup, res: IonResult, prof, i_ion: int,
                 want_d2n_ef: bool) -> IonFinal:
    """Per-species reductions: dN/dp in 3 frames, zone populations,
    normalization, pressures, ISM-frame d2N (ion_finalize.jl:25-59).
    The rebinning runs on the PSD's device, its cell spreading chosen by
    the environment variable MCS_I_APPROX (0, 1, 2 or 3; default 2); the
    ~1e50-scale zone normalizations stay on the host in float64."""
    cfg, bins = setup.cfg, setup.bins
    s = cfg.species[i_ion]
    e0 = s.rest_energy

    # cell-weight spreading mode, read as the JAX driver reads it
    # (driver.py:112): 2, the reference's scalene triangle
    # (particle_counter.jl:72), unless MCS_I_APPROX says otherwise
    i_approx = int(os.environ.get("MCS_I_APPROX", "2"))

    zone_pop, zone_vol = red.zone_populations(
        setup.x_grid_cm, setup.i_shock, s.number_density, cfg.beta0,
        cfg.gamma0, cfg.jet_rad_pc, cfg.jet_sph_frac, prof.ux_sk,
        prof.gamma_sf)

    dn_cr, dn_th, d2n_tot, d2n_ef = red.ion_reduce_device(
        res.psd, res.therm_psd, bins, e0, prof.gamma_sf, prof.ux_sk,
        cfg.gamma0, i_approx=i_approx, want_ef=want_d2n_ef)
    psd = res.psd.cpu().numpy()
    therm = res.therm_psd.cpu().numpy()
    if want_d2n_ef:
        ef_norm = red.ef_zone_norm(psd, therm, zone_pop,
                                   res.num_crossings, s.number_density)
        d2n_ef = d2n_ef * ef_norm[None, None, :]

    dn_th, dn_cr = red.normalize_dndp(
        dn_cr, dn_th, bins.mom_edges, zone_pop, s.number_density,
        cfg.gamma0, prof.ux_sk, prof.gamma_sf)

    p_par, p_perp, e_dens = red.thermo_calcs(
        psd, therm, bins, s.mass, zone_pop, res.num_crossings,
        s.number_density, s.temperature, s.zz, cfg.beta0, cfg.gamma0,
        prof.ux_sk, prof.gamma_sf, d2n=d2n_tot)

    return IonFinal(
        dndp_therm=dn_th, dndp_cr=dn_cr, zone_pop=zone_pop,
        zone_vol=zone_vol, p_psd_par=p_par, p_psd_perp=p_perp,
        energy_density_psd=e_dens, d2n_ef=d2n_ef, esc=res.esc, psd=psd,
        therm_psd=therm, num_crossings=res.num_crossings,
        spectra_sf=res.spectra_sf, spectra_pf=res.spectra_pf,
        n_pushes=res.n_pushes, n_trajectories=res.n_trajectories,
        reason_counts=res.reason_counts, retro_entries=res.retro_entries,
        energy_received=res.energy_received,
        energy_radiated=res.energy_radiated)


def run(cfg: RunConfig | str, device, out_dir: str | None = None,
        p_dtype: torch.dtype = torch.float64,
        emission_hook=None) -> RunResult:
    """Full nonlinear run (main_loops.jl:52-391) on `device`.  `p_dtype`
    is the momentum precision, float64 by default as in the JAX package
    (driver.py:173-210); float32 runs the configs K1 accepts on K1
    (engine/run.py).  Positions, PRP and times stay float64.
    `emission_hook(setup, prof, ion_finals, i_iter)` is called after
    each iteration's emission pass when photon production is enabled."""
    timers = PhaseTimers()
    t_start = time.time()
    if isinstance(cfg, str):
        cfg = load_config(cfg)
    with timers.phase("setup"):
        setup = build_setup(cfg)
    engine = TransportEngine(setup, device=device, p_dtype=p_dtype)
    prof = setup.profile
    nb = setup.nb
    if cfg.do_old_prof:
        from .old_profile import read_old_profile
        prof = read_old_profile(
            "mc_grid_old.dat", cfg, setup.x_grid_cm, cfg.n_old_skip,
            cfg.n_old_profs, cfg.n_old_per_prof)
        log.info("restarted profile from mc_grid_old.dat")

    gamma_grid = np.zeros((nb, 2))
    q_px_hist = np.zeros(cfg.n_itrs)
    q_en_hist = np.zeros(cfg.n_itrs)
    prof_weight_fac = cfg.prof_weight_fac
    rho0 = sum(sp.number_density * sp.mass for sp in cfg.species)
    result = RunResult(setup=setup)

    for i_iter in range(cfg.n_itrs):
        log.info("iteration %d/%d", i_iter + 1, cfg.n_itrs)
        it = engine.new_iteration_tallies(prof)
        ion_finals = []
        for i_ion in range(cfg.n_ions):
            with timers.phase("transport"):
                res = engine.run_ion(i_iter, i_ion, prof, it)
            want_2d = (cfg.species[i_ion].is_electron
                       or i_ion == cfg.n_ions - 1)
            with timers.phase("reductions"):
                ion_finals.append(ion_finalize(setup, res, prof, i_ion,
                                               want_2d))

        # ---- iteration close-out (iter_finalize.jl:20-54) ------------------
        px_esc_frac = it.px_esc_upstream / setup.f_px_upstream
        en_esc_frac = it.energy_esc_upstream / setup.f_energy_upstream
        p_par = sum(f.p_psd_par for f in ion_finals)
        p_perp = sum(f.p_psd_perp for f in ion_finals)
        e_dens = sum(f.energy_density_psd for f in ion_finals)
        gamma_grid = set_gamma_adiab_grid(
            gamma_grid, i_iter, setup.x_grid_cm, setup.gamma2_rh,
            p_par, p_perp, e_dens)
        gamma_dw = 1.0 + (it.sum_p_downstream
                          / max(it.sum_ke_downstream, 1e-300))
        q_px, q_en = q_esc_calcs(
            gamma_dw, setup.r_comp, setup.r_rh, cfg.u0, cfg.beta0,
            cfg.gamma0, cfg.species, setup.gamma2, setup.beta2, setup.u2)
        q_px_hist[i_iter] = q_px
        q_en_hist[i_iter] = q_en
        n_avg = min(i_iter + 1, 4)
        q_px_avg = q_px_hist[i_iter - n_avg + 1:i_iter + 1].mean()
        q_en_avg = q_en_hist[i_iter - n_avg + 1:i_iter + 1].mean()

        with timers.phase("smoothing"):
            prof_new, diag, prof_weight_fac = smooth_grid(
                i_iter, setup.i_shock, prof, cfg, setup.x_grid_rg,
                gamma_grid, p_par, p_perp, it.pxx_flux, it.energy_flux,
                q_px_avg, q_en_avg, setup.f_px_upstream,
                setup.f_energy_upstream, setup.gamma2_rh, setup.u2,
                setup.beta2, setup.gamma2, prof_weight_fac,
                cfg.species[0].number_density, cfg.species[0].temperature,
                rho0, cfg.use_custom_eps_b)

        itres = IterationResult(
            ion_finals=ion_finals, tallies=it, diag=diag,
            gamma_downstream=gamma_dw, q_esc_px=q_px_avg,
            q_esc_en=q_en_avg, px_esc_frac=px_esc_frac,
            en_esc_frac=en_esc_frac, profile_after=prof_new)
        if cfg.do_photons:
            # photon production per shell/zone (ion_finalize.jl:72-78)
            with timers.phase("emission"):
                itres.emission = photon_calcs(setup, prof, ion_finals,
                                              i_iter, device=engine.device)
            if emission_hook is not None:
                emission_hook(setup, prof, ion_finals, i_iter)
        result.iterations.append(itres)
        prof = prof_new

    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    result.wall_time = time.time() - t_start
    result.n_pushes = engine.n_pushes_total
    result.n_trajectories = engine.n_trajectories_total
    result.timers = timers

    if out_dir is not None:
        from .io import write_outputs
        with timers.phase("io"):
            write_outputs(result, out_dir)
    return result
