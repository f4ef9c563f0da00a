"""Emission driver: per-shell/zone photon production + SED summation.

Counterpart of the JAX package's models/emission/driver.py, which
re-derives photon_calcs.jl:10-161 and get_summed_emission.jl:37-415 with
a pure array dataflow (per-zone grids in memory, no scratch files).

``photon_calcs`` has two bodies.  With a torch device it runs the
batched functions of device.py there, in float64 (IEEE float64 on an
NVIDIA card holds the CGS magnitudes of the pass).  With ``device=None``
it runs the per-zone NumPy loop over synchrotron.py, inverse_compton.py
and pion.py: the oracle the batched path is tested against.

Frames: pion and synchrotron spectra are computed in the local plasma
frame and Doppler-shifted into the ISM frame here; IC is computed
directly in the ISM frame (photon_calcs.jl:148-158 note).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ...ops.reduce import shell_surface_areas
from ...utils.constants import C_CGS, ME_C2, MEV_ERG, MPC_CM
from ...utils.tracing import span
from . import device as dev
from .inverse_compton import (cmb_photon_field, ic_emission,
                              ic_photon_energy_grid)
from .pion import heavy_nuclei_scaling, pion_emission
from .synchrotron import photon_energy_grid, synch_emission

# photon grid constants (photon_calcs.jl:10-19), energies in MeV
EG_MIN_MEV = 1.0e-13
EG_MAX_MEV = 1.0e12
BINS_PER_DEC_PHOTON = 10
EG_PION_MIN_MEV = 1.0
EG_SYNCH_MIN_MEV = EG_MIN_MEV
EG_SYNCH_MAX_MEV = 1.0e5
EG_IC_MIN_MEV = 1.0e-2

N_COS_BINS = dev.N_COS_BINS


def _n_photon(emin, emax):
    return int(math.log10(emax / emin) * BINS_PER_DEC_PHOTON)


@dataclass
class EmissionResult:
    """Per-zone and summed photon spectra.

    Grids are dP/d(lnE) energy flux at Earth [erg/(cm^2 s)]; energies
    in erg.
    """

    e_pion: np.ndarray          # [n_pion]
    e_synch: np.ndarray
    e_ic: np.ndarray
    pion_grid: np.ndarray       # [n_pion, nb] per-zone (plasma frame)
    synch_grid: np.ndarray
    ic_grid: np.ndarray         # (ISM frame)
    pion_shell: np.ndarray      # [n_pion, n_shells] ISM frame
    synch_shell: np.ndarray
    ic_shell: np.ndarray
    e_tot: np.ndarray           # merged grid [n_tot]
    tot_shell: np.ndarray       # [n_tot, n_shells]
    tot: np.ndarray             # [n_tot]
    # synchrotron self-Compton (None unless calculate-ssc): computed
    # off each zone's own synchrotron photon field
    ssc_grid: np.ndarray = None     # [n_ic, nb] ISM frame
    ssc_shell: np.ndarray = None    # [n_ic, n_shells]

    def synch_photon_rate(self) -> np.ndarray:
        """Per-zone synchrotron photon production rate d2N/(dE dt)
        [photons / (erg s)], from the stored dP/d(lnE) grid divided
        twice by the photon energy (the quantity synch_emission.jl:
        78-105 stashes for synchrotron-self-Compton cooling)."""
        return self.synch_grid / self.e_synch[:, None] ** 2


def doppler_shift_to_ism(grid: np.ndarray, e_gamma: np.ndarray,
                         beta_ef: np.ndarray, gamma_ef: np.ndarray
                         ) -> np.ndarray:
    """Shift per-zone plasma-frame spectra into the ISM frame
    (get_summed_emission.jl:91-200): isotropic emission split over
    N_COS_BINS angular slices, each Doppler-shifted by
    E' = E * gamma * sqrt((1 - b c_l)(1 - b c_{l+1})) (the minus sign
    because cos = -1 points at the observer), re-binned on the same log
    grid, with gamma^3 for beaming + time dilation.
    """
    n_g, nb = grid.shape
    log_e = np.log(e_gamma)
    dlog = log_e[1] - log_e[0]
    cosb = np.linspace(-1.0, 1.0, N_COS_BINS + 1)
    dimless = np.sqrt((1.0 - np.outer(beta_ef, cosb[:-1]))
                      * (1.0 - np.outer(beta_ef, cosb[1:])))  # [nb, nc]
    out = np.zeros_like(grid)
    frac = 1.0 / N_COS_BINS
    counts = grid / e_gamma[:, None]     # photon flux per lnE ~ counts
    for i in range(nb):
        if counts[:, i].max() <= 1e-90:
            continue
        g = gamma_ef[i]
        shift = np.log(g * dimless[i])             # [nc]
        # target bin for each (photon bin, angle)
        # +1e-9 guards the exact-on-edge case (shift = 0 must map a bin
        # onto itself)
        idx = np.floor((log_e[:, None] + shift[None, :] - log_e[0])
                       / dlog + 1.0e-9).astype(int)
        np.clip(idx, 0, n_g - 1, out=idx)
        e_new = e_gamma[:, None] * g * dimless[i][None, :]
        contrib = counts[:, i][:, None] * frac * g**3 * e_new
        np.add.at(out[:, i], idx.ravel(), contrib.ravel())
    return out


def sum_shells(grid: np.ndarray, n_shell_endpoints: np.ndarray
               ) -> np.ndarray:
    """Sum per-zone spectra into emission shells
    (get_summed_emission.jl:789-806)."""
    n_shells = len(n_shell_endpoints) - 1
    out = np.zeros((grid.shape[0], n_shells))
    for k in range(n_shells):
        a, b = n_shell_endpoints[k], n_shell_endpoints[k + 1]
        out[:, k] = grid[:, a:b].sum(axis=1)
    return out


def merge_total(pion_shell, synch_shell, ic_shell) -> tuple[np.ndarray,
                                                            np.ndarray]:
    """Merge the three processes onto the master photon grid
    (get_summed_emission.jl:249-310)."""
    n_tot = _n_photon(EG_MIN_MEV, EG_MAX_MEV)
    e_tot = 10.0 ** (math.log10(EG_MIN_MEV * MEV_ERG)
                     + np.arange(n_tot) / BINS_PER_DEC_PHOTON)
    n_shells = pion_shell.shape[1]
    tot = np.zeros((n_tot, n_shells))

    def off(emin):
        return int(round(math.log10(emin / EG_MIN_MEV)
                         * BINS_PER_DEC_PHOTON))

    for arr, emin in ((pion_shell, EG_PION_MIN_MEV),
                      (synch_shell, EG_SYNCH_MIN_MEV),
                      (ic_shell, EG_IC_MIN_MEV)):
        o = off(emin)
        n = min(arr.shape[0], n_tot - o)
        tot[o:o + n] += np.where(arr[:n] > 1e-90, arr[:n], 0.0)
    return e_tot, tot


@dataclass
class _Pass:
    """What both bodies of ``photon_calcs`` read: the photon grids, the
    particle bins and the geometry of one emission pass."""

    e_pion: np.ndarray
    e_synch: np.ndarray
    alpha_ic: np.ndarray
    dp: np.ndarray              # momentum bin widths
    p_edges: np.ndarray
    cos_bounds: np.ndarray
    flux_fac: float             # 1 / (4 pi d_L^2)
    dist_lum: float
    ends: np.ndarray            # shell endpoints (zone indices)
    aa_ion: list
    n0_ion: list
    surf: np.ndarray = None     # shell surface areas (SSC only)
    dlne: float = math.log(10.0) / BINS_PER_DEC_PHOTON

    def ssc_seed(self, emis, n):
        """Zone n's own synchrotron photons as an IC seed field
        (E / me c^2, density per bin): production rate per bin
        emis/E * dlnE [photons/s per shock-face area], escape time dx/c
        over the volume surf*dx -> density / (surf * c)."""
        n_ph = (np.maximum(emis, 0.0) / self.e_synch * self.dlne
                / (self.surf[n] * C_CGS))
        return self.e_synch / ME_C2, n_ph


def _grids_per_zone(setup, prof, ion_finals, ps: _Pass, grids):
    """The oracle: every zone through the NumPy kernels, one at a time."""
    cfg = setup.cfg
    pion_grid, synch_grid, ic_grid, ssc_grid = grids
    for i_ion, fi in enumerate(ion_finals):
        s = cfg.species[i_ion]
        for n in range(int(ps.ends[0]), int(ps.ends[-1])):
            counts = (fi.dndp_therm[:, n, 1] + fi.dndp_cr[:, n, 1]) * ps.dp
            if s.aa >= 1:
                if counts.max() <= 1e-90:
                    continue
                gb_loc = math.sqrt(max(prof.gamma_sf[n] ** 2 - 1.0, 1e-30))
                target = ps.n0_ion[0] * cfg.gamma0 * cfg.beta0 / gb_loc
                emis = pion_emission(counts, ps.p_edges, ps.e_pion, target,
                                     s.aa, s.mc, ps.aa_ion, ps.n0_ion)
                pion_grid[:, n] = (np.maximum(pion_grid[:, n], 0.0)
                                   + emis * ps.flux_fac)
                continue
            emis = None
            if counts.max() > 1e-90:
                emis = synch_emission(counts, ps.p_edges, prof.btot[n],
                                      ps.e_synch)
                synch_grid[:, n] += emis * ps.flux_fac
            if fi.d2n_ef is None:
                continue
            d2n_counts = fi.d2n_ef[:, :, n] * ps.dp[:, None]
            if d2n_counts.max() <= 1e-90:
                continue
            ic_args = (d2n_counts, ps.p_edges, ps.cos_bounds, ps.alpha_ic,
                       setup.redshift, cfg.jet_sph_frac, ps.dist_lum, s.mc)
            ic_grid[:, n] += ic_emission(*ic_args)
            if cfg.do_ssc and emis is not None:
                ssc_grid[:, n] += ic_emission(*ic_args,
                                              seed=ps.ssc_seed(emis, n))


def _grids_batched(setup, prof, ion_finals, ps: _Pass, grids, device):
    """Every zone at once on `device` (device.py): one matmul a process
    for pion decay and IC, a [zones, n_p, n_g] broadcast for
    synchrotron.  The SSC seeds differ per zone, so that optional pass
    keeps the per-zone NumPy kernel."""
    cfg = setup.cfg
    pion_grid, synch_grid, ic_grid, ssc_grid = grids
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64),
                                  device=device)
    host = lambda a: a.cpu().numpy()
    zs = slice(int(ps.ends[0]), int(ps.ends[-1]))
    gb_loc = np.sqrt(np.maximum(prof.gamma_sf[zs] ** 2 - 1.0, 1e-30))
    target_z = t(ps.n0_ion[0] * cfg.gamma0 * cfg.beta0 / gb_loc)
    p_edges, e_synch, alpha_ic = (t(ps.p_edges), t(ps.e_synch),
                                  t(ps.alpha_ic))
    for i_ion, fi in enumerate(ion_finals):
        s = cfg.species[i_ion]
        counts_z = t(((fi.dndp_therm[:, zs, 1] + fi.dndp_cr[:, zs, 1])
                      * ps.dp[:, None]).T)              # [nz, n_p]
        if s.aa >= 1:
            with span("emission.pion"):
                scaling = heavy_nuclei_scaling(s.aa, ps.aa_ion, ps.n0_ion)
                emis = host(dev.pion_grid_device(
                    counts_z, ps.p_edges, ps.e_pion, target_z, s.aa, s.mc,
                    scaling))
                pion_grid[:, zs] = (np.maximum(pion_grid[:, zs], 0.0)
                                    + emis * ps.flux_fac)
            continue
        with span("emission.synch"):
            emis = host(dev.synch_grid_device(counts_z, t(prof.btot[zs]),
                                              p_edges, e_synch))
            synch_grid[:, zs] += emis * ps.flux_fac
        if fi.d2n_ef is None:
            continue
        with span("emission.ic"):
            d2n_z = fi.d2n_ef[:, :, zs] * ps.dp[:, None, None]
            ne_z = dev.cone_cut_counts(d2n_z, ps.cos_bounds,
                                       cfg.jet_sph_frac)
            a1, n_ph = cmb_photon_field(setup.redshift)
            ic = host(dev.ic_grid_device(
                t(ne_z), p_edges, alpha_ic, (t(a1), t(n_ph)), s.mc,
                cfg.jet_sph_frac, ps.dist_lum))
            # a zone without electrons keeps the grid's floor, as the
            # per-zone body leaves it (it skips the zone)
            live = d2n_z.max(axis=(0, 1)) > 1e-90
            ic_grid[:, zs] += np.where(live[None, :], ic, 0.0)
            if not cfg.do_ssc:
                continue
            for k, n in enumerate(range(zs.start, zs.stop)):
                if emis[:, k].max() <= 1e-90:
                    continue
                d2n_counts = fi.d2n_ef[:, :, n] * ps.dp[:, None]
                if d2n_counts.max() <= 1e-90:
                    continue
                ssc_grid[:, n] += ic_emission(
                    d2n_counts, ps.p_edges, ps.cos_bounds, ps.alpha_ic,
                    setup.redshift, cfg.jet_sph_frac, ps.dist_lum, s.mc,
                    seed=ps.ssc_seed(emis[:, k], n))


def photon_calcs(setup, prof, ion_finals, i_iter: int = 0, *,
                 device) -> EmissionResult:
    """Full emission pass for one iteration (photon_calcs.jl:27-161).

    `device` is the torch device the batched functions of device.py run
    on (the transport engine's); ``None`` runs the per-zone NumPy loop
    on the host instead, the oracle.  `ion_finals` hold host arrays
    (engine/driver.py IonFinal: dndp_therm, dndp_cr, d2n_ef)."""
    cfg, bins = setup.cfg, setup.bins
    nb = setup.nb
    if cfg.jet_dist_mpc <= 0:
        raise ValueError("photon production requires jet-distance > 0")
    dist_lum = cfg.jet_dist_mpc * (1.0 + setup.redshift) * MPC_CM

    n_pion = _n_photon(EG_PION_MIN_MEV, EG_MAX_MEV)
    n_synch = _n_photon(EG_SYNCH_MIN_MEV, EG_SYNCH_MAX_MEV)
    n_ic = _n_photon(EG_IC_MIN_MEV, EG_MAX_MEV)
    e_pion = 10.0 ** (math.log10(EG_PION_MIN_MEV * MEV_ERG)
                      + np.arange(n_pion) / BINS_PER_DEC_PHOTON)
    e_synch = photon_energy_grid(EG_SYNCH_MIN_MEV, n_synch,
                                 BINS_PER_DEC_PHOTON)
    alpha_ic = ic_photon_energy_grid(EG_IC_MIN_MEV, n_ic,
                                     BINS_PER_DEC_PHOTON)
    ends = setup.n_shell_endpoints
    ps = _Pass(
        e_pion=e_pion, e_synch=e_synch, alpha_ic=alpha_ic,
        dp=np.diff(bins.mom_edges), p_edges=bins.mom_edges,
        cos_bounds=bins.cos_bounds(),
        flux_fac=1.0 / (4.0 * math.pi * dist_lum**2), dist_lum=dist_lum,
        ends=ends, aa_ion=[s.aa for s in cfg.species],
        n0_ion=[s.number_density for s in cfg.species])
    if cfg.do_ssc:
        ps.surf = shell_surface_areas(setup.x_grid_cm, setup.i_shock,
                                      cfg.gamma0, cfg.jet_rad_pc,
                                      cfg.jet_sph_frac)

    pion_grid = np.full((n_pion, nb), 1e-99)
    synch_grid = np.full((n_synch, nb), 1e-99)
    ic_grid = np.full((n_ic, nb), 1e-99)
    ssc_grid = np.full((n_ic, nb), 1e-99) if cfg.do_ssc else None
    grids = (pion_grid, synch_grid, ic_grid, ssc_grid)

    # the per-zone grids, then the plasma -> ISM Doppler shift of pion
    # and synchrotron
    if device is None:
        _grids_per_zone(setup, prof, ion_finals, ps, grids)
        shift = lambda g, e: doppler_shift_to_ism(g, e, prof.beta_ef,
                                                  prof.gamma_ef)
    else:
        device = torch.device(device)
        _grids_batched(setup, prof, ion_finals, ps, grids, device)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                      device=device)
        shift = lambda g, e: dev.doppler_shift_device(
            t(g), t(e), t(prof.beta_ef), t(prof.gamma_ef)).cpu().numpy()
    with span("emission.sum"):
        pion_shell = sum_shells(shift(pion_grid, e_pion), ends)
        synch_shell = sum_shells(shift(synch_grid, e_synch), ends)
        ic_shell = sum_shells(ic_grid, ends)
        ssc_shell = None
        if cfg.do_ssc:
            ssc_shell = sum_shells(ssc_grid, ends)
            # SSC shares the IC outgoing grid; fold it into the IC
            # channel of the master merge
            ic_shell = ic_shell + np.maximum(ssc_shell, 0.0)
        e_tot, tot_shell = merge_total(pion_shell, synch_shell, ic_shell)

    return EmissionResult(
        e_pion=e_pion, e_synch=e_synch, e_ic=alpha_ic * ME_C2,
        pion_grid=pion_grid, synch_grid=synch_grid, ic_grid=ic_grid,
        pion_shell=pion_shell, synch_shell=synch_shell,
        ic_shell=ic_shell, e_tot=e_tot, tot_shell=tot_shell,
        tot=tot_shell.sum(axis=1),
        ssc_grid=ssc_grid, ssc_shell=ssc_shell)
