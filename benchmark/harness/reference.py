"""Plain reference of the per-species reductions of one iteration.

From a species' phase-space tallies (the PSD of cosmic-ray crossings and
the thermal one, [n_mom+1, n_theta+1, nb], in the shock frame) it works
out dN/dp [n_mom+1, nb, 3] in the shock, plasma and ISM frames,
normalized so that each zone integrates to its population
(the reference code's get_dNdp_cr and get_normalized_dNdp,
particle_counter.jl:29-306 and 730-778; set_grid_volumes!,
particle_counter.jl:1466-1524):

* shock frame: the PSD summed over the angle bins, over dp;
* plasma and ISM frames: each (p, cos) cell's corners are boosted by the
  zone's (or the far upstream's) Lorentz factor along x, and the cell's
  weight is spread over the momentum bins by the scalene triangle
  between the corners' smallest and largest log p, peaked at the mean of
  the two middle ones (i_approx = 2, particle_counter.jl:72);
* each zone's population is the upstream particle flux times the shell's
  area (a spherical cap where a jet radius is set) times the dwell time
  dx / u_x, and the zone's thermal plus CR area under dN/dp is scaled to
  it.

Plain torch and NumPy: the frames (the rebinning, the device's share of
the work) in the precision it is given (``dtype``) on any device, the
populations and the normalization in float64.  It imports nothing of the
port: the caller hands it arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

C_CGS = 2.99792458e10
PC_CM = 3.0856775814913673e18


def cos_bounds(theta_bounds, n_theta: int, lin_cos_bins: int) -> np.ndarray:
    """The pitch-cosine bounds of the angle bins: -cos(theta) in the
    log-theta region, the stored -cosine in the linear one."""
    tb = np.asarray(theta_bounds, np.float64)
    j = np.arange(n_theta + 2)
    return np.where(j > n_theta - lin_cos_bins, -tb, -np.cos(tb))


def corner_logp(gamma: float, e0: float, mom_edges, cos_b, dtype):
    """log10 |p| of every cell corner boosted by `gamma` along x."""
    beta = math.sqrt(max(1.0 - 1.0 / gamma ** 2, 0.0)) \
        if gamma >= 1.000001 else 0.0
    tiny = torch.finfo(dtype).tiny
    pt = mom_edges[:, None]
    px = pt * cos_b[None, :]
    etot = torch.sqrt((pt * C_CGS) ** 2 + e0 ** 2)
    px_t = gamma * (px - beta * etot / C_CGS)
    return torch.log10(torch.sqrt(torch.clamp(pt * pt + px_t * px_t
                                              - px * px, min=tiny)))


def spread(corners, edges):
    """[n_cells, n_bins] share of each cell in each momentum bin, by the
    scalene triangle over its corners' log p."""
    c = torch.stack([corners[:-1, :-1], corners[1:, :-1],
                     corners[:-1, 1:], corners[1:, 1:]], -1).reshape(-1, 4)
    lo, hi = c.min(-1).values[:, None], c.max(-1).values[:, None]
    peak = (c.sum(-1)[:, None] - lo - hi) / 2.0
    x = edges[None, :]
    width = hi - lo
    rise = (x - lo) ** 2 / torch.clamp((peak - lo) * width, min=1.0e-30)
    fall = 1.0 - (hi - x) ** 2 / torch.clamp((hi - peak) * width,
                                             min=1.0e-30)
    cdf = torch.where(x <= peak, rise, fall)
    cdf = torch.where(x <= lo, 0.0, torch.where(x >= hi, 1.0, cdf))
    cdf = torch.where(width <= 1.0e-12, (x >= lo).to(x.dtype), cdf)
    return cdf[:, 1:] - cdf[:, :-1]


def dndp_frames(psd, e0: float, gamma_sf, gamma0: float, mom_bounds_log,
                cos_b, dtype, device):
    """Un-normalized dN/dp [n_mom+1, nb, 3] of one PSD."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(device,
                                                                 dtype)
    p = t(psd)
    nb = p.shape[-1]
    edges_log = t(mom_bounds_log)
    mom_edges = 10.0 ** edges_log
    cb = t(cos_b)
    # the last bin reaches to +inf: overflow lands in the top bin
    edges = torch.cat([edges_log[:-1], edges_log.new_tensor([1.0e9])])
    dp = mom_edges[1:] - mom_edges[:-1]
    out = torch.empty(p.shape[0], nb, 3, dtype=dtype, device=device)
    out[:, :, 0] = p.sum(1)
    for z in range(nb):
        g = float(gamma_sf[z])
        frac = spread(corner_logp(g, e0, mom_edges, cb, dtype), edges)
        out[:, z, 1] = (p[:, :, z] / g).reshape(-1) @ frac
    frac = spread(corner_logp(gamma0, e0, mom_edges, cb, dtype), edges)
    out[:, :, 2] = ((p.permute(2, 0, 1).reshape(nb, -1) / gamma0)
                    @ frac).T
    return out / dp[:, None, None]


def zone_populations(x_grid_cm, i_shock: int, n0: float, beta0: float,
                     gamma0: float, jet_rad_pc: float, jet_sph_frac: float,
                     ux_sk) -> np.ndarray:
    """Each zone's population: upstream flux x shell area x dwell time,
    in float64 whatever the precision of the dN/dp (populations reach
    1e50 in CGS units, and the last zone's width is the grid's
    sentinel)."""
    x = np.asarray(x_grid_cm, np.float64)
    ux = np.asarray(ux_sk, np.float64)
    nb = len(x)
    dx = np.diff(x)
    area = np.ones(nb)
    if jet_rad_pc > 0:
        r_jet = jet_rad_pc * PC_CM
        r_lo = r_jet - x[i_shock]
        for i in range(i_shock - 1, 0, -1):
            r_hi = r_lo + dx[i] / gamma0
            area[i] = math.pi * (r_hi + r_lo) ** 2 * jet_sph_frac
            r_lo = r_hi
        r_hi = r_jet - x[i_shock]
        for i in range(i_shock, nb - 1):
            r_lo = r_hi - dx[i] / gamma0
            area[i] = math.pi * (r_hi + r_lo) ** 2 * jet_sph_frac
            r_hi = r_lo
    pop = np.zeros(nb)
    flux = gamma0 * n0 * beta0 * C_CGS
    pop[1:nb - 1] = flux * area[1:nb - 1] * (dx[1:nb - 1] / ux[1:nb - 1])
    return pop


def normalized(dn_cr, dn_th, mom_bounds_log, pop, n0: float, gamma0: float,
               ux_sk, gamma_sf):
    """(thermal, CR) dN/dp scaled so that each zone's area is its
    population; zones with CR crossings and no thermal ones take the
    compressed density over the local speed for the thermal area."""
    dn_cr = np.asarray(dn_cr, np.float64)
    dn_th = np.asarray(dn_th, np.float64)
    dp = np.diff(10.0 ** np.asarray(mom_bounds_log, np.float64))
    ux = np.asarray(ux_sk, np.float64)
    dens = gamma0 * ux[1] / (np.asarray(gamma_sf, np.float64) * ux)
    a_th = (dn_th * dp[:, None, None]).sum(0)
    a_cr = (dn_cr * dp[:, None, None]).sum(0)
    a = np.where((a_th == 0) & (a_cr > 0),
                 n0 * dens[:, None] / ux[:, None] + a_cr, a_th + a_cr)
    scale = np.zeros_like(a)
    np.divide(np.broadcast_to(pop[:, None], a.shape), a, out=scale,
              where=a > 0)
    return dn_th * scale[None], dn_cr * scale[None]


def species_dndp(psd, therm_psd, *, e0, n0, gamma0, beta0, gamma_sf,
                 ux_sk, x_grid_cm, i_shock, jet_rad_pc, jet_sph_frac,
                 mom_bounds_log, theta_bounds, n_theta, lin_cos_bins,
                 dtype=torch.float64, device="cpu"):
    """(thermal, CR) normalized dN/dp [n_mom+1, nb, 3] of one species in
    one iteration, as float64 NumPy arrays: the frames are worked out in
    `dtype` on `device`, the populations and the normalization in
    float64."""
    cb = cos_bounds(theta_bounds, n_theta, lin_cos_bins)
    kw = dict(e0=e0, gamma_sf=gamma_sf, gamma0=gamma0,
              mom_bounds_log=mom_bounds_log, cos_b=cb, dtype=dtype,
              device=device)
    host = lambda a: a.to(torch.float64 if dtype == torch.float64
                          else torch.float32).cpu().numpy()
    dn_cr = host(dndp_frames(psd, **kw))
    dn_th = host(dndp_frames(therm_psd, **kw))
    pop = zone_populations(x_grid_cm, i_shock, n0, beta0, gamma0,
                           jet_rad_pc, jet_sph_frac, ux_sk)
    return normalized(dn_cr, dn_th, mom_bounds_log, pop, n0, gamma0, ux_sk,
                      gamma_sf)
