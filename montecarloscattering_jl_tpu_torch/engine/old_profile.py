"""Restart from a saved mc_grid.dat profile.

The reference designed this path but left it erroring
(read-old-profile reaches `error("Reading old profiles not yet
supported")`, MonteCarloScattering.jl:462) while keeping mc_grid.dat's
columns read-compatible (smoothers.jl:232-233).  This implements it
against our mc_grid.dat layout (engine/io.py, same 33 quantities):
skip `lines-to-skip`, average the last `profiles-to-average` iteration
blocks of `lines-per-profile` rows each, and rebuild the ShockProfile.
"""

from __future__ import annotations

import math

import numpy as np

from ..models.profile import ShockProfile
from ..utils.constants import C_CGS

# column indices in mc_grid.dat rows (after the i_iter, i leaders)
_COL_UX_NORM = 12
_COL_B = 16
_COL_THETA_DEG = 18
_COL_EPSB = 33


def read_old_profile(path: str, cfg, x_grid_cm: np.ndarray,
                     n_old_skip: int, n_old_profs: int,
                     n_old_per_prof: int) -> ShockProfile:
    """Rebuild a ShockProfile from a prior run's mc_grid.dat."""
    rows = []
    with open(path) as f:
        for k, line in enumerate(f):
            if line.startswith("#") or line.startswith("3333 333 "):
                continue   # header / plot-vals footer (io.plot_vals_footer)
            rows.append([float(v) for v in line.split()])
    rows = rows[n_old_skip:]
    if n_old_per_prof <= 0:
        n_old_per_prof = len(x_grid_cm) - 2
    blocks = len(rows) // n_old_per_prof
    if blocks < 1:
        raise ValueError(
            f"old profile {path!r}: {len(rows)} rows after skip do not "
            f"contain a full {n_old_per_prof}-row profile")
    use = min(max(n_old_profs, 1), blocks)
    arr = np.asarray(rows[(blocks - use) * n_old_per_prof:
                          blocks * n_old_per_prof])
    arr = arr.reshape(use, n_old_per_prof, -1)

    ux_norm = arr[:, :, _COL_UX_NORM].mean(axis=0)
    btot_in = arr[:, :, _COL_B].mean(axis=0)
    theta_in = np.radians(arr[:, :, _COL_THETA_DEG].mean(axis=0))
    epsb_in = arr[:, :, _COL_EPSB].mean(axis=0)

    nb = len(x_grid_cm)
    if n_old_per_prof != nb - 2:
        raise ValueError(
            f"old profile has {n_old_per_prof} zones but the grid has "
            f"{nb - 2}")

    ux = np.empty(nb)
    ux[1:nb - 1] = ux_norm * cfg.u0
    ux[0], ux[nb - 1] = ux[1], ux[nb - 2]
    btot = np.empty(nb)
    btot[1:nb - 1] = btot_in
    btot[0], btot[nb - 1] = btot[1], btot[nb - 2]
    theta = np.empty(nb)
    theta[1:nb - 1] = theta_in
    theta[0], theta[nb - 1] = theta[1], theta[nb - 2]
    eps_b = np.empty(nb)
    eps_b[1:nb - 1] = epsb_in
    eps_b[0], eps_b[nb - 1] = eps_b[1], eps_b[nb - 2]

    gamma_sf = 1.0 / np.sqrt(np.maximum(1.0 - (ux / C_CGS) ** 2, 1e-30))
    beta_ef = (cfg.u0 - ux) / (C_CGS - cfg.u0 * ux / C_CGS)
    gamma_ef = 1.0 / np.sqrt(np.maximum(1.0 - beta_ef**2, 1e-30))
    return ShockProfile(
        ux_sk=ux, uz_sk=np.zeros(nb), utot=ux.copy(), gamma_sf=gamma_sf,
        beta_ef=beta_ef, gamma_ef=gamma_ef, btot=btot, theta=theta,
        eps_b=eps_b, bmag2=float(btot[nb - 2]))
