"""Output files: run reports and plot-ready grids.

Mirrors the reference's L6 surface (io.jl, smoothers.jl:234-272,
particle_counter.jl:786-931): mc_out.dat run summary, mc_grid.dat
33-column convergence dashboard, mc_dNdp_grid_{therm,CR}[_i].dat
spectra, and mc_coupled_{weights,spectra}.csv tcut tracking.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import constants as K


def _log10s(x):
    return np.log10(np.maximum(np.asarray(x, float), 1e-99))


def _lines(fmt: str, *cols) -> str:
    """`fmt` % each row of the columns `cols` (arrays of one length, or
    scalars repeated), formatted from Python numbers: the text a row-by-
    row f-string of the same specs writes, without NumPy's per-scalar
    cost."""
    n = max(np.size(c) for c in cols)
    rows = zip(*(np.broadcast_to(c, (n,)).tolist() for c in cols))
    return "".join(fmt % r for r in rows)


def write_mc_grid(result, path: str) -> None:
    """33-column per-zone dashboard, one block per iteration
    (smoothers.jl:234-272 column list)."""
    setup = result.setup
    nb = setup.nb
    x_rg = setup.x_grid_rg
    x_cm = setup.x_grid_cm
    with open(path, "w") as f:
        cols = ("i_iter i x_rg x_log x_cm x_log_cm pxx_norm pxx_norm_log "
                "pxz_norm pxz_norm_log en_norm en_norm_log ux_norm "
                "ux_norm_log uz_norm uz_norm_log B B_log theta_deg "
                "gamma_sf inv_density_ratio density_ratio log_P_px "
                "log_P_en log_P_par log_P_perp log_P_tot aniso "
                "log_P_px_tp log_P_en_tp log_P0 log_rem_px log_rem_en "
                "epsB epsB_log")
        f.write("# " + cols + "\n")
        p0 = sum(s.number_density * s.temperature
                 for s in setup.cfg.species) * K.KB_CGS
        for i_iter, itr in enumerate(result.iterations):
            prof = itr.profile_after
            d = itr.diag
            p_par = sum(fi.p_psd_par for fi in itr.ion_finals)
            p_perp = sum(fi.p_psd_perp for fi in itr.ion_finals)
            for i in range(1, nb - 1):
                x_log = (-np.log10(-x_rg[i]) if x_rg[i] < -1
                         else (np.log10(x_rg[i]) if x_rg[i] > 1 else 0.0))
                x_log_cm = (0.0 if x_cm[i] == 0 else
                            np.sign(x_rg[i]) * np.log10(abs(x_cm[i])))
                ux_norm = prof.ux_sk[i] / prof.ux_sk[1]
                row = [
                    i_iter + 1, i, x_rg[i], x_log, x_cm[i], x_log_cm,
                    d.pxx_norm[i], _log10s(abs(d.pxx_norm[i])),
                    d.pxz_norm[i], -99.0,
                    d.energy_norm[i], _log10s(abs(d.energy_norm[i])),
                    ux_norm, _log10s(ux_norm), 1e-99, -99.0,
                    prof.btot[i], _log10s(prof.btot[i]),
                    np.degrees(prof.theta[i]), prof.gamma_sf[i],
                    1.0 / max(setup.cfg.gamma0 * setup.cfg.beta0
                              / max(prof.gamma_sf[i] * prof.ux_sk[i]
                                    / K.C_CGS, 1e-30), 1e-30),
                    setup.cfg.gamma0 * setup.cfg.beta0
                    / max(prof.gamma_sf[i] * prof.ux_sk[i] / K.C_CGS,
                          1e-30),
                    _log10s(d.pressure_px[i]), _log10s(d.pressure_energy[i]),
                    _log10s(p_par[i]), _log10s(p_perp[i]),
                    _log10s(d.pressure_tot_mc[i]), d.pressure_aniso[i],
                    _log10s(d.pressure_px_tp), _log10s(d.pressure_energy_tp),
                    _log10s(p0), _log10s(1 - itr.q_esc_px),
                    _log10s(1 - itr.q_esc_en),
                    prof.eps_b[i], _log10s(prof.eps_b[i]),
                ]
                f.write(" ".join(f"{v:.7e}" if isinstance(v, float)
                                 else str(v) for v in row) + "\n")
        f.write(plot_vals_footer(setup))


def write_dndp(result, out_dir: str) -> None:
    """Per-zone dN/dp spectra for thermal and CR populations
    (mc_dNdp_grid_{therm,CR}[_i].dat, particle_counter.jl:786-931)."""
    setup = result.setup
    bins = setup.bins
    logp = bins.mom_bounds_log[:-1]
    logp_nat = logp - np.log10(K.MP_C)
    for i_iter, itr in enumerate(result.iterations):
        suffix = (f"_{i_iter + 1}" if setup.cfg.do_multi_dndps else "")
        for name, attr in (("therm", "dndp_therm"), ("CR", "dndp_cr")):
            path = os.path.join(out_dir, f"mc_dNdp_grid_{name}{suffix}.dat")
            with open(path, "w") as f:
                f.write("# i_zone i_ion log_p_cgs log_p_natural "
                        "log_dNdp_sf log_dNdp_pf log_dNdp_ism\n")
                for i_ion, fi in enumerate(itr.ion_finals):
                    dn = getattr(fi, attr)
                    lg = _log10s(dn)
                    for i in range(1, setup.nb - 1):
                        if dn[:, i, :].max() <= 1e-66:
                            continue
                        f.write(_lines("%d %d %.5f %.5f %.5e %.5e %.5e\n",
                                       i, i_ion + 1, logp, logp_nat,
                                       lg[:, i, 0], lg[:, i, 1],
                                       lg[:, i, 2]))
                f.write(plot_vals_footer(setup))
        if not setup.cfg.do_multi_dndps:
            break  # single file covers the final iteration only


def write_coupled(result, out_dir: str) -> None:
    """Time-resolved coupled weights and spectra
    (tcut_print, io.jl:21-76)."""
    setup = result.setup
    cfg = setup.cfg
    if not cfg.do_tcuts:
        return
    wpath = os.path.join(out_dir, "mc_coupled_weights.csv")
    spath = os.path.join(out_dir, "mc_coupled_spectra.csv")
    with open(wpath, "w") as fw, open(spath, "w") as fs:
        fw.write("i_iter,i_ion,i_tcut,tcut_s,weight_coupled\n")
        fs.write("i_iter,i_ion,i_tcut,log_p_cgs,spectra_coupled\n")
        logp = setup.bins.mom_bounds_log[:-1]
        for i_iter, itr in enumerate(result.iterations):
            w = itr.tallies.weight_coupled
            s = itr.tallies.spectra_coupled
            for i_ion in range(cfg.n_ions):
                for k, t in enumerate(cfg.tcuts):
                    fw.write(f"{i_iter + 1},{i_ion + 1},{k + 1},{t:g},"
                             f"{w[k, i_ion]:.6e}\n")
                    for j in range(setup.bins.n_mom + 1):
                        if s[j, k, i_ion] > 0:
                            fs.write(f"{i_iter + 1},{i_ion + 1},{k + 1},"
                                     f"{logp[j]:.4f},"
                                     f"{s[j, k, i_ion]:.6e}\n")


def plot_vals_footer(setup) -> str:
    """36-column run-parameter footer appended to each plot-ready data
    set, in the column order the reference's plotting program reads
    (print_plot_vals, io.jl:178-253 — stubbed to a no-op there at
    io.jl:254; functional here).  Leads with the `3333 333` sentinel
    pair the reader keys on, ends with one (aa, zz, n0, T0) block per
    species."""
    cfg = setup.cfg
    vals = [
        cfg.u0 / 1.0e5,                       # 1  u0 [km/s]
        cfg.gamma0,                           # 2
        setup.r_comp,                         # 3
        setup.r_rh,                           # 4
        cfg.theta_b0,                         # 5
        np.degrees(setup.profile.theta[-2]),  # 6  theta_B2
        0.0,                                  # 7  theta_u2 (parallel)
        cfg.bmag0,                            # 8
        cfg.feb_upstream / cfg.rg0,           # 9  [rg0]
        cfg.emax / K.KEV_ERG if cfg.emax > 0 else 0.0,        # 10 [keV]
        cfg.emax_per_aa / K.KEV_ERG if cfg.emax_per_aa > 0
        else 0.0,                             # 11 [keV/aa]
        cfg.pmax / K.MP_C if cfg.pmax > 0 else 0.0,           # 12 [mp c]
        float(cfg.n_pts_inj),                 # 13
        float(cfg.n_pts_pcut),                # 14
        cfg.xn_per_coarse,                    # 15
        cfg.xn_per_fine,                      # 16
        setup.mach_sonic,                     # 17
        setup.mach_alfven,                    # 18
        cfg.x_grid_start_rg,                  # 19
        float(cfg.random_seed),               # 20
        cfg.x_grid_stop_rg,                   # 21
        66.0 if cfg.do_fast_push else 0.0,    # 22
        cfg.x_fast_stop_rg,                   # 23
        cfg.eta_mfp,                          # 24
        cfg.x_art_start_rg,                   # 25
        cfg.x_art_scale,                      # 26
        cfg.feb_downstream / cfg.rg0,         # 27 [rg0]
        cfg.jet_rad_pc,                       # 28
        cfg.jet_sph_frac,                     # 29
        cfg.jet_dist_mpc * 1.0e3,             # 30 [kpc]
        cfg.smooth_mom_energy_fac,            # 31
        float(cfg.inp_distr),                 # 32
        cfg.energy_inj,                       # 33
        cfg.smooth_pressure_flux_psd_fac,     # 34
        66.0 if cfg.dont_dsa else 0.0,        # 35
        cfg.energy_transfer_frac,             # 36
        float(len(cfg.species)),
    ]
    for s in cfg.species:
        vals += [s.aa, s.zz, s.number_density, s.temperature]
    return ("3333 333 "
            + " ".join(f"{v:.7e}" for v in vals) + "\n")


def write_mc_out(result, path: str) -> None:
    """Run summary + config banner (mc_out.dat; print_input,
    io.jl:101-166; MonteCarloScattering.jl:371-412;
    iter_finalize.jl:73-126)."""
    setup = result.setup
    cfg = setup.cfg
    with open(path, "w") as f:
        f.write("MonteCarloScattering TPU framework run summary\n\n")
        f.write(f"shock: u0={cfg.u0:.6e} cm/s beta0={cfg.beta0:.6f} "
                f"gamma0={cfg.gamma0:.4f}\n")
        f.write(f"downstream: u2={setup.u2:.6e} cm/s "
                f"beta2={setup.beta2:.6f} gamma2={setup.gamma2:.4f}\n")
        f.write(f"r_RH={setup.r_rh:.5f} Gamma2_RH={setup.gamma2_rh:.5f} "
                f"r_comp={setup.r_comp:.5f}\n")
        f.write(f"Mach sonic={setup.mach_sonic:.2f} "
                f"alfven={setup.mach_alfven:.2f}\n")
        f.write(f"B0={cfg.bmag0:.4e} G  B2(init)={setup.bmag2_init:.4e} G"
                f"  theta_B0={cfg.theta_b0} deg\n")
        f.write(f"rg0={cfg.rg0:.6e} cm; grid {setup.n_grid} zones; "
                f"shock index {setup.i_shock}; "
                f"FEB index {setup.i_grid_feb}\n")
        f.write(f"FEB upstream={cfg.feb_upstream:.4e} cm "
                f"({cfg.feb_upstream / cfg.rg0:.1f} rg0); "
                f"downstream="
                + (f"{cfg.feb_downstream:.4e} cm"
                   if cfg.feb_downstream > 0 else "PRP") + "\n")
        f.write(f"particles: inject {cfg.n_pts_inj}, per pcut "
                f"{cfg.n_pts_pcut} (hi {cfg.n_pts_pcut_hi} above "
                f"{cfg.energy_pcut_hi:g} keV/aa); {len(cfg.pcuts)} "
                f"pcuts\n")
        f.write(f"scattering: eta_mfp={cfg.eta_mfp}, N_g coarse/fine = "
                f"{cfg.xn_per_coarse:g}/{cfg.xn_per_fine:g}\n")
        f.write(f"PSD: {setup.bins.n_mom} momentum x "
                f"{setup.bins.n_theta} angle bins "
                f"({cfg.psd_bins_per_dec_mom}/dec mom, "
                f"{cfg.psd_lin_cos_bins} lin-cos + "
                f"{cfg.psd_log_theta_decs} log-theta decades)\n")
        f.write(f"switches: no-shock={cfg.dont_shock} "
                f"no-scatter={cfg.dont_scatter} no-DSA={cfg.dont_dsa} "
                f"smoothing={cfg.do_smoothing} retro={cfg.do_retro} "
                f"fast-push={cfg.do_fast_push} "
                f"rad-losses={cfg.do_rad_losses} "
                f"photons={cfg.do_photons}\n")
        f.write(f"age_max={cfg.age_max:g} s; "
                f"b-turbulence={cfg.bturb_comp_frac} "
                f"b-amplify={cfg.bfield_amp} "
                f"custom-epsB={cfg.use_custom_eps_b}\n")
        for i, s in enumerate(cfg.species):
            f.write(f"species {i + 1}: aa={s.aa:.6g} zz={s.zz:+.0f} "
                    f"T0={s.temperature:g} K n0={s.number_density:g} "
                    f"/cm^3\n")
        f.write(f"redshift={setup.redshift:.5f} "
                f"(jet distance {cfg.jet_dist_mpc:g} Mpc)\n")
        f.write(f"F_px_upstream={setup.f_px_upstream:.6e} erg/cm^3\n")
        f.write(f"F_energy_upstream={setup.f_energy_upstream:.6e} "
                f"erg/cm^2/s\n\n")
        for i, itr in enumerate(result.iterations):
            f.write(f"Iteration {i + 1}\n")
            f.write(f"  esc momentum flux / upstream = "
                    f"{itr.px_esc_frac:.6e} (predicted "
                    f"{itr.q_esc_px:.6e})\n")
            f.write(f"  esc energy flux / upstream   = "
                    f"{itr.en_esc_frac:.6e} (predicted "
                    f"{itr.q_esc_en:.6e})\n")
            f.write(f"  adiab index downstream PRP particles = "
                    f"{itr.gamma_downstream:.5f} (R-H "
                    f"{setup.gamma2_rh:.5f})\n")
        f.write(f"\npushes={result.n_pushes} "
                f"trajectories={result.n_trajectories} "
                f"wall={result.wall_time:.1f}s\n")


def write_photons(result, out_dir: str) -> None:
    """Per-zone and summed photon spectra (photon_synch.jl:109-131,
    inverse_compton.jl:107-155, photon_pion_decay.jl:114-176,
    get_summed_emission.jl:327-406)."""
    em = result.iterations[-1].emission
    if em is None:
        return

    def grid_file(name, e_gamma, grid):
        path = os.path.join(out_dir, f"photon_{name}_grid.dat")
        with open(path, "w") as f:
            f.write("# i_zone log_photon_flux log_E_MeV "
                    "log_energy_flux_MeV log_dN_dE\n")
            e_mev = e_gamma[:-1] / K.MEV_ERG
            for i in range(grid.shape[1]):
                col = grid[:, i]
                if col.max() <= 1e-90:
                    continue
                emis_mev = col[:-1] / K.MEV_ERG
                pf = np.where(emis_mev > 1e-99, emis_mev / e_mev, 1e-99)
                f.write(_lines("%d %.5f %.5f %.5f %.5f\n", i, _log10s(pf),
                               np.log10(e_mev), _log10s(emis_mev),
                               _log10s(pf / e_mev)))

    grid_file("pion_decay", em.e_pion, em.pion_grid)
    grid_file("synch", em.e_synch, em.synch_grid)
    grid_file("IC", em.e_ic, em.ic_grid)
    if em.ssc_grid is not None:
        grid_file("SSC", em.e_ic, em.ssc_grid)

    def summed_file(name, e_gamma, shells):
        path = os.path.join(out_dir, f"photon_{name}_summed.dat")
        with open(path, "w") as f:
            f.write("# i_shell log_photon_flux log_E_MeV "
                    "log_energy_flux_MeV\n")
            e_mev = e_gamma[:-1] / K.MEV_ERG
            for n in range(shells.shape[1]):
                v = shells[:-1, n] / K.MEV_ERG
                pf = np.where(v > 1e-99, v / e_mev, 1e-99)
                f.write(_lines("%d %.5f %.5f %.5f\n", n + 1, _log10s(pf),
                               np.log10(e_mev), _log10s(v)))

    summed_file("pion", em.e_pion, em.pion_shell)
    summed_file("synch", em.e_synch, em.synch_shell)
    summed_file("IC", em.e_ic, em.ic_shell)
    if em.ssc_shell is not None:
        summed_file("SSC", em.e_ic, em.ssc_shell)
    summed_file("tot", em.e_tot, em.tot_shell)

    with open(os.path.join(out_dir, "photon_tot.dat"), "w") as f:
        f.write("# log_E_MeV log_energy_flux_MeV log_photon_flux\n")
        e_mev = em.e_tot / K.MEV_ERG
        v = em.tot / K.MEV_ERG
        pf = np.where(v > 1e-99, v / e_mev, 1e-99)
        f.write(_lines("%.5f %.5f %.5f\n", np.log10(e_mev), _log10s(v),
                       _log10s(pf)))


def write_xspec(result, out_dir: str) -> None:
    """Detector spectra at the configured x positions
    (calculate_x_spec_spectra!, all_flux.jl:164-190)."""
    setup = result.setup
    if not setup.cfg.x_spec:
        return
    path = os.path.join(out_dir, "mc_xspec.dat")
    logp = setup.bins.mom_bounds_log[:-1]
    with open(path, "w") as f:
        f.write("# i_iter i_ion i_xspec x_cm log_p_cgs "
                "spectrum_sf spectrum_pf\n")
        for i_iter, itr in enumerate(result.iterations):
            for i_ion, fi in enumerate(itr.ion_finals):
                for ix, xs in enumerate(setup.cfg.x_spec):
                    for j in range(fi.spectra_sf.shape[0]):
                        if (fi.spectra_sf[j, ix] <= 0
                                and fi.spectra_pf[j, ix] <= 0):
                            continue
                        f.write(f"{i_iter + 1} {i_ion + 1} {ix + 1} "
                                f"{xs:.5e} {logp[j]:.4f} "
                                f"{fi.spectra_sf[j, ix]:.6e} "
                                f"{fi.spectra_pf[j, ix]:.6e}\n")


def write_timers(result, out_dir: str) -> None:
    """Per-phase wall-clock report (tracing subsystem, SURVEY.md 5.1)."""
    if result.timers is None:
        return
    result.timers.dump(
        os.path.join(out_dir, "mc_profile.json"),
        extra={
            "pushes": result.n_pushes,
            "trajectories": result.n_trajectories,
            "wall_time_s": round(result.wall_time, 3),
            "pushes_per_sec": round(
                result.n_pushes / max(result.wall_time, 1e-9), 1),
        })


def write_outputs(result, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    write_mc_out(result, os.path.join(out_dir, "mc_out.dat"))
    write_mc_grid(result, os.path.join(out_dir, "mc_grid.dat"))
    write_dndp(result, out_dir)
    write_coupled(result, out_dir)
    write_xspec(result, out_dir)
    write_timers(result, out_dir)
    if result.setup.cfg.do_photons and result.iterations:
        write_photons(result, out_dir)
