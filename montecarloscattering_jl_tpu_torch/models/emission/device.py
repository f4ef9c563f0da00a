"""Emission on the run's device, batched over zones, in float64 torch.

Counterpart of the JAX package's models/emission/device.py.  The NumPy
modules (synchrotron.py / inverse_compton.py / pion.py) are the oracle
and the per-zone path of ``driver.photon_calcs``; these functions
compute the same spectra for every zone at once: for inverse Compton
and pion decay the (particle-bin x photon-bin) kernel does not depend on
the zone, so the whole grid is one matmul ``counts[zones, p] @ K[p,
gamma]``; synchrotron keeps the per-zone field in a [zones, n_p, n_g]
broadcast; the Doppler shift is one scatter-add over [zones, n_g, 180].

None of this is a hand-written kernel, because the JAX package computes
it outside any Pallas kernel too (jnp matmuls, a vmap, an interp and a
scatter-add).  Every tensor argument is float64 on one device and every
result is a float64 tensor on it: IEEE float64 holds the CGS magnitudes
of the pass (zone counts ~1e118, beam areas ~1e56 cm^2) as they are.

Reference parity anchors: synch_emission.jl:28-171,
inverse_compton.jl:191-383, pion_kafexhiu.jl:36-245 /
KATV2014.jl:22-296, get_summed_emission.jl:91-200.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...utils.constants import C_CGS, GEV_ERG, HBAR_CGS, ME_C2, ME_CGS, QE_CGS
from ...utils.params import E_REL_PT
from .pion import amax_and_egmax, f_func, sigma_pi
from .synchrotron import _E_MIN_SYNCH, _X_MAX, _X_MIN, _f_table

_MB_CM2 = 1.0e-27
N_COS_BINS = 180   # Doppler-shift angle resolution (get_summed:111)


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    """A host array as a float64 tensor on `ref`'s device."""
    return torch.as_tensor(np.asarray(a, np.float64), device=ref.device)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """Linear interpolation of the table (xp ascending, fp) at x, held
    at fp[0] below xp[0] and at fp[-1] above xp[-1]: jnp.interp, in its
    order of operations."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.numel() - 1)
    dx = xp[i] - xp[i - 1]
    f = torch.where(dx == 0, fp[i],
                    fp[i - 1] + (x - xp[i - 1]) / dx * (fp[i] - fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


# ---------------------------------------------------------------------------
# synchrotron
# ---------------------------------------------------------------------------

def synch_grid_device(counts_z: torch.Tensor, btot_z: torch.Tensor,
                      p_edges: torch.Tensor, e_gamma: torch.Tensor
                      ) -> torch.Tensor:
    """[n_g, nz] synchrotron dP/d(lnE) (synch_emission.jl:28-171):
    counts_z [nz, n_p] electron counts per momentum bin, btot_z [nz]."""
    lx, lf = (_like(a, counts_z) for a in _f_table())
    mc = ME_CGS * C_CGS
    p_ctr = torch.sqrt(p_edges[:-1] * p_edges[1:])
    gam = torch.hypot(p_ctr / mc, torch.ones_like(p_ctr))
    b = btot_z[:, None]
    p_fac = (math.sqrt(3.0) / (2.0 * math.pi)
             * QE_CGS**3 / (ME_CGS * C_CGS**2)) * b                # [nz, 1]
    omega_c = 3.0 * gam[None, :] ** 2 * QE_CGS * b / (2.0 * mc)   # [nz, n_p]
    keep = ((counts_z > 1.0e-60) & (p_ctr * C_CGS >= _E_MIN_SYNCH)[None, :]
            & (omega_c >= 1.0e-55))
    omega_g = e_gamma / HBAR_CGS
    x = omega_g[None, None, :] / omega_c.clamp(min=1e-300)[:, :, None]
    fx = torch.exp(interp(torch.log(x.clamp(min=_X_MIN)), lx, lf))
    fx = torch.where((x >= _X_MAX) | (x < _X_MIN), 0.0, fx)
    w = torch.where(keep, counts_z, 0.0)
    emis = (w[:, :, None] * omega_g[None, None, :] * p_fac[:, :, None]
            * fx).sum(dim=1)                                       # [nz, n_g]
    ok = (btot_z >= 1.0e-20) & keep.any(dim=1)
    return torch.where(ok[:, None], emis.clamp(min=1.0e-99), 1.0e-99).T


# ---------------------------------------------------------------------------
# inverse Compton: zone-independent kernel -> one matmul
# ---------------------------------------------------------------------------

def ic_grid_device(ne_z: torch.Tensor, p_edges: torch.Tensor,
                   alpha_out: torch.Tensor, seed_field, mc: float,
                   jet_sph_frac: float = 1.0, dist_lum: float = 1.0
                   ) -> torch.Tensor:
    """[n_ic, nz] observed IC spectrum (IC_emission_FCJ,
    inverse_compton.jl:191-311).

    ne_z [nz, n_p]: cone-cut electron counts per momentum bin per zone;
    seed_field = (a1 [n_seed], n_ph [n_seed]).  The seed field is the
    same in every zone, so the Jones Eq 9 kernel K[p, out] is computed
    once and every zone is one row of a single matmul."""
    a1, n_ph = seed_field
    p1 = torch.sqrt(p_edges[:-1] * p_edges[1:])
    gam = torch.where(p1 / mc < E_REL_PT, 1.0,
                      torch.hypot(p1 / mc, torch.ones_like(p1)))
    r0 = QE_CGS**2 / ME_C2

    g = gam[:, None, None]
    al1 = a1[None, :, None]
    al = alpha_out[None, None, :]
    # q <= 0 gives nan or inf below; the mask after it drops them
    q = al / (4.0 * al1 * g**2 * (1.0 - al / g))
    brack = (2.0 * q * torch.log(q) + (1.0 + 2.0 * q) * (1.0 - q)
             + 8.0 * (al1 * g * q)**2 * (1.0 - q)
             / (1.0 + 4.0 * al1 * g * q))
    norm = n_ph[None, :, None] * 2.0 * math.pi * r0**2 * C_CGS \
        / (al1 * g**2)
    kern = norm * brack
    kern = torch.where((al < g) & (q > 0) & (q <= 1.0)
                       & torch.isfinite(kern), kern, 0.0)
    k_po = kern.sum(dim=1)                        # [n_p, n_out]

    w = torch.where(ne_z > 1.0e-99, ne_z, 0.0)
    # the oracle drops each (zone, e-bin, seed, out) term below 1e-60
    # before it sums; here the floor meets the summed kernel (the terms
    # span decades, so it matters only in empty corners)
    d2n = w @ k_po                                # [nz, n_out]
    beam_area = 4.0 * math.pi * dist_lum**2 * max(jet_sph_frac, 1e-12)
    e_out = alpha_out * ME_C2
    emis = d2n / beam_area / ME_C2 * e_out[None, :] ** 2
    emis = torch.where(emis <= 1.0e-55, 1.0e-99, emis)
    any_e = (ne_z > 1.0e-99).any(dim=1)
    return torch.where(any_e[None, :], emis.T, 1.0e-99)


def cone_cut_counts(d2n_zones, cos_bounds, jet_sph_frac):
    """Apply the jet-opening-angle pitch cut (inverse_compton.jl:
    210-214) on the host: d2n_zones [n_mom, n_theta, nz] -> [nz, n_mom]."""
    jt_max = int(np.searchsorted(np.asarray(cos_bounds),
                                 2.0 * jet_sph_frac - 1.0))
    jt_max = max(jt_max, 1)
    return np.moveaxis(np.asarray(d2n_zones)[:, :jt_max, :].sum(axis=1),
                       -1, 0)


# ---------------------------------------------------------------------------
# pi0 decay: zone-independent kernel -> one matmul
# ---------------------------------------------------------------------------

def pion_grid_device(counts_z: torch.Tensor, p_edges, e_gamma,
                     target_z: torch.Tensor, aa: float, mc: float,
                     scaling: float, i_data: int = 1) -> torch.Tensor:
    """[n_g, nz] pion-decay dP/d(lnE) (pion_kafexhiu.jl:36-245).

    The Kafexhiu kernel dsigma/dlnE(Tp, Eg) depends only on the shared
    momentum grid: it is built once on the host in NumPy from `p_edges`
    and `e_gamma` (host arrays: table fits with heavy branch structure)
    and contracted with the counts by one matmul on their device, scaled
    per zone by the target density."""
    mass = mc / C_CGS
    e0_erg = mc * C_CGS
    p_edges = np.asarray(p_edges)
    e_gamma = np.asarray(e_gamma)
    p2 = p_edges[:-1] * p_edges[1:]
    gam = np.sqrt(1.0 + p2 / mc**2)
    tp = (gam - 1.0) * e0_erg / GEV_ERG / aa
    vel = np.sqrt(p2) / (gam * mass)

    sig = sigma_pi(tp, i_data)
    eg_max, amax = amax_and_egmax(tp, sig, i_data)
    eg_gev = e_gamma / GEV_ERG
    ff = f_func(tp, eg_gev, eg_max, i_data)
    kern = (amax[:, None] * ff * eg_gev[None, :] * _MB_CM2
            * vel[:, None] * e_gamma[None, :]
            * (tp >= 0.2797)[:, None])            # [n_p, n_g]

    w = torch.where(counts_z > 1.0e-99, counts_z, 0.0)
    emis = (w @ _like(kern, counts_z)) * target_z[:, None] * scaling
    return torch.where(emis < 1.0e-99, 1.0e-99, emis).T


# ---------------------------------------------------------------------------
# Doppler shift (plasma -> ISM), batched over zones
# ---------------------------------------------------------------------------

def doppler_shift_device(grid: torch.Tensor, e_gamma: torch.Tensor,
                         beta_ef: torch.Tensor, gamma_ef: torch.Tensor
                         ) -> torch.Tensor:
    """Batched form of driver.doppler_shift_to_ism
    (get_summed_emission.jl:91-200): grid [n_g, nz] -> [n_g, nz].  The
    re-binning is one ``index_add_`` into a flat [nz * n_g] buffer; on a
    CUDA device its atomics sum in an order that changes from run to
    run (float64: ~1e-15 relative)."""
    n_g, nb = grid.shape
    log_e = torch.log(e_gamma)
    dlog = log_e[1] - log_e[0]
    cosb = _like(np.linspace(-1.0, 1.0, N_COS_BINS + 1), grid)
    dimless = torch.sqrt((1.0 - torch.outer(beta_ef, cosb[:-1]))
                         * (1.0 - torch.outer(beta_ef, cosb[1:])))
    counts = grid / e_gamma[:, None]
    shift = torch.log(gamma_ef[:, None] * dimless)          # [nb, nc]
    # +1e-9: a shift of 0 must map a bin onto itself
    idx = torch.floor((log_e[None, :, None] + shift[:, None, :]
                       - log_e[0]) / dlog + 1.0e-9).long()
    idx = idx.clamp(0, n_g - 1)
    e_new = (e_gamma[None, :, None] * gamma_ef[:, None, None]
             * dimless[:, None, :])
    contrib = (counts.T[:, :, None] / N_COS_BINS
               * gamma_ef[:, None, None] ** 3 * e_new)      # [nb, ng, nc]
    active = counts.max(dim=0).values > 1e-90               # [nb]
    contrib = torch.where(active[:, None, None], contrib, 0.0)
    flat = idx + n_g * torch.arange(nb, device=grid.device)[:, None, None]
    out = torch.zeros(nb * n_g, dtype=grid.dtype, device=grid.device)
    out.index_add_(0, flat.reshape(-1), contrib.reshape(-1))
    return out.view(nb, n_g).T
