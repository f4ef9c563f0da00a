"""Injection population: Maxwell-Boltzmann / delta-function sampling.

Mirrors set_inj_dist and friends (initializers.jl:1251-1514) and
init_pop including fast push (initializers.jl:977-1133).

The distribution construction is deterministic binning (no sampling):
particles sit at the geometric centers of momentum bins with weights
set by the M-B bin areas, exactly like the reference.  Randomness enters
only via the initial pitch cosine and gyro phase.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..utils.constants import C_CGS, KB_CGS
from ..utils.params import BETA_REL_FL, E_REL_PT, NUM_THERM_BINS
from ..utils.species import Species
from .fluxes import fast_push_fluxes


@dataclass
class InjectedPopulation:
    """Freshly injected particle population (host-side)."""

    weight: np.ndarray    # [N] fraction of far-upstream density per particle
    ptot_pf: np.ndarray   # [N] plasma-frame total momentum [g cm/s]
    pb_pf: np.ndarray     # [N] momentum component along B [g cm/s]
    x_cm: np.ndarray      # [N] position [cm]
    i_grid: np.ndarray    # [N] starting boundary index
    # analytic flux backfill for fast push (length nb each); zeros otherwise
    pxx_flux: np.ndarray
    pxz_flux: np.ndarray
    energy_flux: np.ndarray


def create_inj_momentum_range(m: float, temperature: float, nbins: int
                              ) -> np.ndarray:
    """Momentum range spanning the M-B curve (initializers.jl:1389-1415)."""
    e0 = m * C_CGS**2
    kt = KB_CGS * temperature
    kt_min, kt_max = 2.0e-3 * kt, 10.0 * kt
    if kt / e0 < E_REL_PT:
        p_min = math.sqrt(2.0 * m * kt_min)
        p_max = math.sqrt(2.0 * m * kt_max)
    else:
        p_min = math.sqrt((kt_min + e0) ** 2 - e0**2) / C_CGS
        p_max = math.sqrt((kt_max + e0) ** 2 - e0**2) / C_CGS
    return np.linspace(p_min, p_max, nbins + 1)


def _mb_energies(p_range: np.ndarray, m: float, kt: float) -> np.ndarray:
    """E/kT per momentum node (initializers.jl:1277-1284)."""
    e0 = m * C_CGS**2
    if kt / e0 < E_REL_PT:
        return p_range**2 / (2.0 * m * kt)
    return np.hypot(p_range * C_CGS, e0) / kt


def _mb_bin_areas(p_range: np.ndarray, e_range: np.ndarray) -> np.ndarray:
    """Per-bin trapezoid areas of p^2 exp(-E/kT)
    (initializers.jl:1343-1376), computed in log space to dodge huge
    exponents."""
    logf = 2.0 * np.log(p_range) - e_range
    f = np.exp(logf)
    return np.diff(p_range) * (f[:-1] + f[1:]) / 2.0


def set_inj_dist(inj_weight: bool, n_pts_inj: int, inp_distr: int,
                 t_or_e: float, m: float, n0: float
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(ptot, weight) of the injected distribution
    (initializers.jl:1251-1328).

    * inp_distr == 1: thermal M-B at temperature t_or_e [K]
    * inp_distr == 2: delta function at kinetic energy t_or_e [erg]
    * inj_weight True: equal-weight particles (counts per bin follow
      the M-B areas); False: equal particles per bin, weights follow
      the areas.
    """
    if inp_distr not in (1, 2):
        raise ValueError("only inp_distr 1 or 2 supported")

    if inp_distr == 2:
        # delta function (initializers.jl:1498-1514)
        e0 = m * C_CGS**2
        e_inj = t_or_e
        if e_inj / e0 < E_REL_PT:
            p = math.sqrt(2.0 * m * e_inj)
        else:
            p = math.sqrt(e_inj**2 - e0**2) / C_CGS
        ptot = np.full(n_pts_inj, p)
        weight = np.full(n_pts_inj, n0 / n_pts_inj)
        return ptot, weight

    p_range = create_inj_momentum_range(m, t_or_e, NUM_THERM_BINS)
    e_range = _mb_energies(p_range, m, KB_CGS * t_or_e)
    areas = _mb_bin_areas(p_range, e_range)
    area_tot = float(np.sum(areas))
    p_centers = np.sqrt(p_range[:-1] * p_range[1:])

    if inj_weight:
        # equal-weight particles (initializers.jl:1417-1453)
        counts = np.round(areas / (area_tot / n_pts_inj)).astype(int)
        n_tot = int(np.sum(counts))
        ptot = np.repeat(p_centers, counts)
        weight = np.full(n_tot, n0 / max(n_tot, 1))
        return ptot, weight

    # equal-weight bins (initializers.jl:1474-1496)
    n_per_bin = n_pts_inj // NUM_THERM_BINS
    if n_per_bin < 5:
        raise ValueError(
            f"too few particles per bin ({n_per_bin}); increase N_PTS_INJ")
    ptot = np.repeat(p_centers, n_per_bin)
    weight = np.repeat(areas / area_tot / n_per_bin * n0, n_per_bin)
    return ptot, weight


def init_pop(rng: np.random.Generator, species: Sequence[Species],
             i_ion: int, inp_distr: int, energy_inj: float,
             inj_weight: bool, n_pts_inj: int,
             x_grid_start: float, rg0: float, eta_mfp: float,
             do_fast_push: bool, x_fast_stop_rg: float,
             beta0: float, gamma0: float, u0: float,
             x_grid_rg: np.ndarray, ux_sk_grid: np.ndarray,
             gamma_sf_grid: np.ndarray) -> InjectedPopulation:
    """Build the injected population for one species
    (initializers.jl:977-1133)."""
    s = species[i_ion]
    nb = len(x_grid_rg)
    zeros_nb = np.zeros(nb)

    if not do_fast_push:
        t_or_e = s.temperature if inp_distr == 1 else energy_inj
        ptot, weight = set_inj_dist(inj_weight, n_pts_inj, inp_distr,
                                    t_or_e, s.mass, s.number_density)
        n = len(ptot)
        pb = ptot * 2.0 * (rng.random(n) - 0.5)
        x = np.full(n, x_grid_start - 10.0 * rg0 * eta_mfp)
        return InjectedPopulation(
            weight=weight, ptot_pf=ptot, pb_pf=pb, x_cm=x,
            i_grid=np.zeros(n, dtype=np.int32),
            pxx_flux=zeros_nb.copy(), pxz_flux=zeros_nb.copy(),
            energy_flux=zeros_nb.copy())

    # ---- fast push (initializers.jl:1020-1133) ----
    if inp_distr != 1:
        raise ValueError("fast push only works with a thermal input distr.")

    i_stop = int(np.searchsorted(x_grid_rg, x_fast_stop_rg, side="right")) - 1
    relativistic = beta0 >= BETA_REL_FL
    density_ratio = u0 / ux_sk_grid[i_stop]
    if relativistic:
        density_ratio *= gamma0 / gamma_sf_grid[i_stop]
    temp_ratio = density_ratio ** (5.0 / 3.0) / density_ratio
    if KB_CGS * s.temperature * temp_ratio > 4.0 * s.rest_energy * E_REL_PT:
        raise ValueError(
            "fast push: compressed thermal particles become mildly "
            "relativistic; move the fast-push stop upstream or disable it")

    if i_ion == 0:
        pxx, pxz, energy = fast_push_fluxes(
            species, i_stop, u0, gamma0, gamma_sf_grid, ux_sk_grid, nb)
    else:
        pxx, pxz, energy = zeros_nb.copy(), zeros_nb.copy(), zeros_nb.copy()

    ptot, weight = set_inj_dist(inj_weight, n_pts_inj, inp_distr,
                                s.temperature * temp_ratio, s.mass,
                                s.number_density)
    n = len(ptot)
    x = np.full(n, x_fast_stop_rg * rg0)
    i_grid = np.full(n, i_stop, dtype=np.int32)

    # Shock-frame-weighted pitch: v^2 uniform => v triangular, peaking at
    # the right vertex (Vladimirov 2009; initializers.jl:1089-1131).
    # Vectorized; draws the same PCG64 stream as a per-particle loop
    # (rng.random(n) == n successive rng.random() calls), EXCEPT that a
    # degenerate hi<=lo interval consumes no draw in the scalar
    # _triangular_right — thermal ptot>0 makes that impossible here, and
    # the assert keeps the contract honest if a config ever reaches it.
    u = ux_sk_grid[i_stop]
    beta_u = u / C_CGS
    if relativistic:
        g_pf = np.hypot(1.0, ptot / s.mc)
        b_pf = np.sqrt(1.0 - 1.0 / g_pf**2)
        lo = np.abs((beta_u - b_pf) / (1.0 - beta_u * b_pf))
        hi = np.abs((beta_u + b_pf) / (1.0 + beta_u * b_pf))
    else:
        vt_pf = ptot / s.mass
        lo, hi = np.abs(u - vt_pf), np.abs(u + vt_pf)
    assert np.all(hi > lo), "degenerate pitch interval in fast push"
    draw = lo + (hi - lo) * np.sqrt(rng.random(n))
    if relativistic:
        vx_pf = (draw - beta_u) / (1.0 - draw * beta_u) * C_CGS
        pb = g_pf * s.mass * vx_pf
    else:
        pb = s.mass * (draw - u)

    return InjectedPopulation(
        weight=weight, ptot_pf=ptot, pb_pf=pb, x_cm=x, i_grid=i_grid,
        pxx_flux=pxx, pxz_flux=pxz, energy_flux=energy)
