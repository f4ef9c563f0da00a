"""Reduction layer: PSD -> spectra, zone populations, pressures.

Counterpart of the JAX package's ops/reduce.py on the slice's path:

* ``ion_reduce_device`` (``_ion_reduce_prog``, reduce.py:237-352): dN/dp
  in the shock, plasma and ISM frames by corner-transform rebinning, the
  cell weight spread by ``i_approx`` as ``_rebin_matrix`` spreads it
  (reduce.py:150-189; 2, the scalene triangle, is the reference's
  production choice, particle_counter.jl:72), and the center-point
  boosted d2N (thermo_calcs.jl:179-208).  It runs on the PSD's device in
  float64: the reference ran it in float32 only because f64 is emulated
  on a TPU.  On the CPU the rebinning is ``_dn_frames_plain``, a loop
  over the zones of a dense fraction matrix each and ``torch.matmul``;
  on a CUDA device it is one launch of ``rebin_dndp`` (csrc/rebin.cu)
  over every zone and both frames, which holds the plain version as its
  spec.  The bins' tables live on the device once per bins
  (``bin_tables``) and a call's boosts arrive by one pinned copy, so on
  a card the reduction enqueues without a host wait.
* the host helpers ``ion_finalize`` uses, in NumPy float64 as in the
  reference: ``zone_populations``, ``normalize_dndp``, ``thermo_calcs``
  and ``ef_zone_norm``.
* library reductions no path of the driver calls, as in the JAX
  package: ``dndp_cr`` (one PSD's dN/dp in three frames, the rebinning
  ``ion_reduce_device`` shares), ``dndp_2d_ef``, ``normalized_total_ef``
  and ``pitch_histograms``.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.constants import C_CGS, KB_CGS, PC_CM
from ..models.psd_bins import PsdBins, psd_bin_angle, psd_bin_momentum
from . import build
from .transforms import boost_x

F64 = torch.float64

# launches of the rebinning kernel (csrc/rebin.cu) since import: the
# driver counts them as RunResult.launches["rebin"]
LAUNCHES = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.library("rebin")
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.mcs_rebin_dndp.argtypes = [p] * 9 + [i] * 5 + [d, d, p]
        lib.mcs_rebin_dndp.restype = i
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# the bins' tables and a call's boosts on the reduction's device
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BinTables:
    """A ``PsdBins``' float64 tables on one device."""

    mom_edges: torch.Tensor     # [n_mom+2] [g cm/s]
    cos_bounds: torch.Tensor    # [n_theta+2]
    edges_log: torch.Tensor     # [n_mom+2] log10 lower edges
    mom_centers: torch.Tensor   # [n_mom+1]
    cos_centers: torch.Tensor   # [n_theta+1]
    dp: torch.Tensor            # [n_mom+1] bin widths


# (id(bins), device) -> (weak reference to bins, BinTables)
_TABLES: dict = {}


def on_device(rows, dev) -> list:
    """1-D float64 host arrays as tensors on `dev`: on a CUDA device by
    one non-blocking copy from pinned memory (no host wait), on the CPU
    the arrays' own memory."""
    rows = [np.asarray(r, np.float64) for r in rows]
    dev = torch.device(dev)
    if dev.type == "cpu":
        return [torch.as_tensor(r) for r in rows]
    host = torch.from_numpy(np.concatenate(rows)).pin_memory()
    flat = host.to(dev, non_blocking=True)
    return list(torch.split(flat, [len(r) for r in rows]))


def bin_tables(bins: PsdBins, dev) -> BinTables:
    """`bins`' tables on `dev`, copied there once for the bins' life."""
    dev = torch.device(dev)
    key = (id(bins), dev)
    hit = _TABLES.get(key)
    if hit is not None and hit[0]() is bins:
        return hit[1]
    for k in [k for k, (ref, _) in _TABLES.items() if ref() is None]:
        del _TABLES[k]
    mom_edges, cos_bounds, edges_log, p_cent, cos_cent = on_device(
        [bins.mom_edges, bins.cos_bounds(), bins.mom_bounds_log,
         bins.mom_centers, bins.cos_centers()], dev)
    tab = BinTables(mom_edges, cos_bounds, edges_log, p_cent, cos_cent,
                    torch.diff(mom_edges))
    _TABLES[key] = (weakref.ref(bins), tab)
    return tab


def boost_beta(gamma: float) -> float:
    """The speed of a frame boost of Lorentz factor `gamma` as the corner
    transform takes it: 0 below gamma 1.000001."""
    return (math.sqrt(max(1.0 - 1.0 / gamma ** 2, 0.0))
            if gamma >= 1.000001 else 0.0)


def frame_grids(gamma_sf_grid, gamma0: float) -> list:
    """[gammas, betas], each [nb+1]: the rebinning's frames, every zone's
    plasma frame and then the ISM's."""
    gam = [float(g) for g in np.asarray(gamma_sf_grid, np.float64)]
    gam.append(float(gamma0))
    return [np.array(gam), np.array([boost_beta(g) for g in gam])]


# ---------------------------------------------------------------------------
# corner-transform rebinning (CR dN/dp)
# ---------------------------------------------------------------------------

def corner_logp(gamma: float, e0: float, mom_edges: torch.Tensor,
                cos_bounds: torch.Tensor) -> torch.Tensor:
    """Transformed corner log10-momenta [n_mom+2, n_theta+2]
    (transform_psd_corners, transformers.jl:634-682)."""
    beta = boost_beta(gamma)
    pt = mom_edges[:, None]
    ct = cos_bounds[None, :]
    px = pt * ct
    etot = torch.hypot(pt * C_CGS, torch.full_like(pt, e0))
    px_t = gamma * (px - beta * etot / C_CGS)
    pt_t = torch.sqrt(torch.clamp(pt * pt + px_t * px_t - px * px,
                                  min=1.0e-300))
    return torch.log10(pt_t)


def _triangle_cdf(x, lo, peak, hi):
    """CDF of the triangular distribution on [lo, hi] peaked at `peak`,
    robust to degenerate (point-like) cells."""
    width = hi - lo
    tinyw = width <= 1.0e-12
    d1 = torch.clamp((peak - lo) * width, min=1.0e-30)
    d2 = torch.clamp((hi - peak) * width, min=1.0e-30)
    up = (x - lo) ** 2 / d1
    down = 1.0 - (hi - x) ** 2 / d2
    cdf = torch.where(x <= peak, up, down)
    cdf = torch.where(x <= lo, 0.0, torch.where(x >= hi, 1.0, cdf))
    return torch.where(tinyw, (x >= lo).to(x.dtype), cdf)


def _uniform_cdf(x, lo, hi):
    """CDF of a uniform distribution on [lo, hi] (i_approx = 0,
    uniform_cell_distribution!, transformers.jl:177-202)."""
    width = hi - lo
    tinyw = width <= 1.0e-12
    cdf = torch.clamp((x - lo) / torch.clamp(width, min=1.0e-30), 0.0, 1.0)
    return torch.where(tinyw, (x >= lo).to(x.dtype), cdf)


def _trapezoid_cdf(x, lo, b1, b2):
    """CDF of alpha + beta*u + gamma*v for (u, v) uniform on the unit
    square: a trapezoidal distribution on [lo, lo+b1+b2] with plateau
    [lo+m, lo+M], m = min(b1, b2), M = max(b1, b2); robust to
    degenerate spans."""
    m = torch.minimum(b1, b2)
    big = torch.maximum(b1, b2)
    tot = m + big
    tiny = tot <= 1.0e-12
    s = x - lo
    m_s = torch.clamp(m, min=1.0e-30)
    big_s = torch.clamp(big, min=1.0e-30)
    ramp_up = s * s / (2.0 * m_s * big_s)
    plateau = (2.0 * s - m) / (2.0 * big_s)
    ramp_dn = 1.0 - (tot - s) ** 2 / (2.0 * m_s * big_s)
    cdf = torch.where(s <= m, ramp_up, torch.where(s <= big, plateau,
                                                   ramp_dn))
    cdf = torch.where(s <= 0.0, 0.0, torch.where(s >= tot, 1.0, cdf))
    return torch.where(tiny, (s >= 0.0).to(x.dtype), cdf)


_EXACT_SUBDIV = 4   # i_approx = 3 bilinear subdivision per cell axis


def _exact_cdf(c00, c10, c01, c11, e):
    """i_approx = 3: the exact-overlap CDF of the transformed cell.  The
    cell's log-p surface is the bilinear interpolation of its four
    corners over the (u, v) unit square, cut into _EXACT_SUBDIV^2
    subcells; each subcell's restriction, linearized (the cross term
    dropped), gets the exact trapezoidal CDF.  The reference reserves
    the mode and errors on it (transformers.jl:132-134); this follows
    the JAX package's implementation of its intent.  c** are [n_cells, 1]
    corner columns, `e` is [1, n_edges]; returns [n_cells, n_edges]."""
    k = _EXACT_SUBDIV
    beta_full = c10 - c00
    gamma_full = c01 - c00
    delta = c11 - c10 - c01 + c00
    cdf = 0.0
    for r in range(k):
        for s in range(k):
            u0 = r / k
            v0 = s / k
            alpha = (c00 + beta_full * u0 + gamma_full * v0
                     + delta * u0 * v0)
            beta = (beta_full + delta * v0) / k
            gamma = (gamma_full + delta * u0) / k
            lo = (alpha + torch.clamp(beta, max=0.0)
                  + torch.clamp(gamma, max=0.0))
            cdf = cdf + _trapezoid_cdf(e, lo, beta.abs(), gamma.abs())
    return cdf / (k * k)


def rebin_matrix(corner_lp: torch.Tensor, edges_log: torch.Tensor,
                 i_approx: int = 2) -> torch.Tensor:
    """[n_cells, n_bins] fraction matrix from the cell corner log-p grid
    (get_transform_dN, transformers.jl:106-148): cell (i, j) owns
    corners (i..i+1, j..j+1), and its weight is spread by `i_approx` as
    the JAX package's ``_rebin_matrix`` spreads it:
      0  uniform on [p_lo, p_hi] (the corners' min and max)
      1  isosceles triangle peaked at the midpoint
      3  exact bilinear-cell overlap (``_exact_cdf``)
      any other value (2, the reference's production choice): scalene
         triangle peaked at the mean of the two middle corners."""
    c00, c10 = corner_lp[:-1, :-1], corner_lp[1:, :-1]
    c01, c11 = corner_lp[:-1, 1:], corner_lp[1:, 1:]
    # the last bin extends to +inf so overflow lands there, as the
    # reference clamps to the top bin (transformers.jl:68-92)
    e = torch.cat([edges_log[:-1], edges_log.new_tensor([1.0e9])])
    if i_approx == 3:
        cdf = _exact_cdf(c00.reshape(-1, 1), c10.reshape(-1, 1),
                         c01.reshape(-1, 1), c11.reshape(-1, 1), e[None, :])
        return cdf[:, 1:] - cdf[:, :-1]
    stack = torch.stack([c00, c10, c01, c11], dim=-1)
    lo = stack.min(dim=-1).values
    hi = stack.max(dim=-1).values
    if i_approx == 1:
        peak = (lo + hi) / 2.0
    else:
        peak = (stack.sum(dim=-1) - lo - hi) / 2.0
    lo, hi, peak = lo.reshape(-1, 1), hi.reshape(-1, 1), peak.reshape(-1, 1)
    if i_approx == 0:
        cdf = _uniform_cdf(e[None, :], lo, hi)
    else:
        cdf = _triangle_cdf(e[None, :], lo, peak, hi)
    return cdf[:, 1:] - cdf[:, :-1]


def d2n_boosted(total: torch.Tensor, gammas, betas, e0: float,
                bins: PsdBins) -> torch.Tensor:
    """Center-point boost of a d2N histogram [n_mom+1, n_theta+1, nb]
    into per-zone frames (thermo_calcs.jl:179-208): each cell's weight
    moves to the bin its boosted center lands in.  `gammas` and `betas`
    [nb] are arrays, or float64 tensors on the histogram's device."""
    dev = total.device
    nmp1, ntp1, nb = total.shape
    tab = bin_tables(bins, dev)
    p_cent, cos_cent = tab.mom_centers, tab.cos_centers
    if not isinstance(gammas, torch.Tensor):
        gammas, betas = on_device([gammas, betas], dev)
    g, b = gammas, betas
    pt = (p_cent[:, None] * torch.ones_like(cos_cent)[None, :])[None]
    px = (p_cent[:, None] * cos_cent[None, :])[None]
    pt_t, px_t = boost_x(pt, px, g[:, None, None], b[:, None, None], e0,
                         C_CGS)                        # [nb, nm+1, nt+1]
    ip = psd_bin_momentum(pt_t, bins.psd_mom_min, bins.bins_per_dec_mom,
                          bins.n_mom).long()
    jt = psd_bin_angle(px_t, pt_t, bins.cos_fine, bins.dcos,
                       bins.theta_min, bins.bins_per_dec_theta,
                       bins.n_theta).long()
    z = torch.arange(nb, device=dev)[:, None, None]
    flat = (z * nmp1 + ip) * ntp1 + jt
    out = torch.zeros(nb * nmp1 * ntp1, dtype=total.dtype, device=dev)
    out.index_put_((flat.reshape(-1),),
                   total.permute(2, 0, 1).reshape(-1), accumulate=True)
    return out.reshape(nb, nmp1, ntp1).permute(1, 2, 0)


def _dn_frames_plain(psds, bins: PsdBins, e0: float, gamma_sf_grid,
                     gamma0: float, i_approx: int) -> list:
    """``_dn_frames``' plain version, on any device: a loop over the
    zones, each building the zone's dense fraction matrix and
    multiplying the weights by it; the matrix, which depends only on
    the zone's boost, is shared by all the PSDs (``_ion_reduce_prog``,
    reduce.py:256-277)."""
    dev = psds[0].device
    nb = psds[0].shape[-1]
    tab = bin_tables(bins, dev)
    mom_edges, cos_bounds = tab.mom_edges, tab.cos_bounds
    gam = np.asarray(gamma_sf_grid, np.float64)
    zoned = [p.permute(2, 0, 1) for p in psds]     # [nb, nm+1, nt+1]
    dn_pf = [torch.empty(nb, psds[0].shape[0], dtype=F64, device=dev)
             for _ in psds]
    for z in range(nb):
        g = float(gam[z])
        m = rebin_matrix(corner_logp(g, e0, mom_edges, cos_bounds),
                         tab.edges_log, i_approx)
        for out, p in zip(dn_pf, zoned):
            out[z] = torch.matmul((p[z] / g).reshape(-1), m)
    m0 = rebin_matrix(corner_logp(gamma0, e0, mom_edges, cos_bounds),
                      tab.edges_log, i_approx)
    return [torch.stack([p.sum(dim=1), pf.T,
                         torch.matmul(pz.reshape(nb, -1) / gamma0, m0).T],
                        dim=-1) / tab.dp[:, None, None]
            for p, pf, pz in zip(psds, dn_pf, zoned)]


def _check_rebin(psds, tab: BinTables, gammas, betas) -> None:
    """Raise ValueError on what the rebinning kernel does not take: its
    dtype, shape and contiguity first, then its device."""
    n_mom, n_theta = tab.mom_edges.shape[0] - 2, tab.cos_bounds.shape[0] - 2
    if not 1 <= len(psds) <= 2:
        raise ValueError(f"psds: want one or two PSDs, got {len(psds)}")
    nb = psds[0].shape[-1] if psds[0].dim() == 3 else -1
    want = {"psd": (n_mom + 1, n_theta + 1, nb), "gammas": (nb + 1,),
            "betas": (nb + 1,)}
    named = [("psd", p) for p in psds] + [("gammas", gammas),
                                          ("betas", betas)]
    named += [(f, getattr(tab, f)) for f in ("mom_edges", "cos_bounds",
                                             "edges_log")]
    for name, a in named:
        shape = want.get(name, tuple(a.shape))
        if a.dtype != F64:
            raise ValueError(f"{name}: want dtype float64, got {a.dtype}")
        if tuple(a.shape) != shape or nb < 1:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: want a contiguous tensor")
    dev = psds[0].device
    for name, a in named:
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"{name}: the rebinning kernel runs on the "
                             f"PSD's CUDA device, got {a.device} (PSD on "
                             f"{dev})")


def rebin_dndp(psds, tab: BinTables, gammas, betas, e0: float,
               i_approx: int) -> torch.Tensor:
    """The un-normalized plasma-frame and ISM-frame dN/dp rows of each
    PSD of `psds` (one or two, float64 [n_mom+1, n_theta+1, nb] on a CUDA
    device), [n_psd, 2, nb, n_mom+1], by one launch of csrc/rebin.cu on
    the current stream.  `gammas` / `betas` [nb+1] are the frames'
    boosts (``frame_grids``) on the same device, `tab` the bins' tables
    there."""
    global LAUNCHES
    _check_rebin(psds, tab, gammas, betas)
    dev = psds[0].device
    n_mom, n_theta = tab.mom_edges.shape[0] - 2, tab.cos_bounds.shape[0] - 2
    nb = psds[0].shape[-1]
    out = torch.empty(len(psds), 2, nb, n_mom + 1, dtype=F64, device=dev)
    corners = torch.empty(2 * nb, (n_mom + 2) * (n_theta + 2), dtype=F64,
                          device=dev)
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())
    i = ctypes.c_int
    err = _lib().mcs_rebin_dndp(
        ptr(tab.mom_edges), ptr(tab.cos_bounds), ptr(tab.edges_log),
        ptr(gammas), ptr(betas), ptr(psds[0]), ptr(psds[-1]), ptr(corners),
        ptr(out), i(n_mom), i(n_theta), i(nb), i(len(psds)), i(i_approx),
        ctypes.c_double(e0), ctypes.c_double(C_CGS),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"rebin launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _dn_frames(psds, bins: PsdBins, e0: float, gamma_sf_grid,
               gamma0: float, i_approx: int, frames=None) -> list:
    """dN/dp [n_mom+1, nb, 3] in the (shock, plasma, ISM) frames of each
    float64 PSD of `psds` (one or two), un-normalized: on the CPU the
    plain version, on another device ``rebin_dndp``, whose frames
    `frames` ([gammas, betas] on the device) are made from the grids
    where not given."""
    dev = psds[0].device
    if dev.type == "cpu":
        return _dn_frames_plain(psds, bins, e0, gamma_sf_grid, gamma0,
                                i_approx)
    tab = bin_tables(bins, dev)
    if frames is None:
        frames = on_device(frame_grids(gamma_sf_grid, gamma0), dev)
    psds = [p.contiguous() for p in psds]
    rows = rebin_dndp(psds, tab, *frames, e0, i_approx)
    dp = tab.dp[:, None, None]
    return [torch.stack([p.sum(dim=1), r[0].T, r[1].T], dim=-1) / dp
            for p, r in zip(psds, rows)]


def dndp_cr(psd, bins: PsdBins, e0: float, gamma_sf_grid, gamma0: float,
            i_approx: int = 2) -> torch.Tensor:
    """dN/dp [n_mom+1, nb, 3] in the (shock, plasma, ISM) frames
    (get_dNdp_cr, particle_counter.jl:29-306; the JAX package's
    reduce.py:203), a float64 tensor on the PSD's device.  `psd` is
    [n_mom+1, n_theta+1, nb], a tensor or an array."""
    return _dn_frames([torch.as_tensor(psd).to(F64)], bins, e0,
                      gamma_sf_grid, gamma0, i_approx)[0]


# ---------------------------------------------------------------------------
# fused per-ion device reduction
# ---------------------------------------------------------------------------

def ion_reduce_device(psd, therm_psd, bins: PsdBins, e0: float,
                      gamma_sf_grid, ux_sk_grid, gamma0: float,
                      i_approx: int = 2, want_ef: bool = False,
                      fetch: bool = True):
    """(dn_cr, dn_th, d2n_tot, d2n_ef) as float64 NumPy arrays, or with
    `fetch` False as float64 tensors left on the PSD's device (the
    driver's overlapped reductions copy them asynchronously).

    dn_cr / dn_th are the un-normalized dN/dp [n_mom+1, nb, 3] (shock,
    plasma, ISM frames); d2n_tot is the plasma-frame center-point
    boosted CR+thermal d2N for thermo_calcs; d2n_ef (when want_ef) the
    ISM-frame d2N/dp of the raw CR+thermal total, which the caller
    multiplies by ``ef_zone_norm``.  `i_approx` selects the cell
    spreading of ``rebin_matrix``.  `psd` / `therm_psd` are
    [n_mom+1, n_theta+1, nb] tensors (any float dtype) on the device
    the reduction runs on."""
    psd = psd.to(F64)
    therm = therm_psd.to(F64)
    dev = psd.device
    nb = psd.shape[-1]
    # every boost of the call in one copy: the d2N's zones, the ISM
    # frame's (want_ef), and on a card the rebinning's frames
    gam = np.asarray(gamma_sf_grid, np.float64)
    rows = [gam, np.asarray(ux_sk_grid, np.float64) / C_CGS]
    if want_ef:
        beta0 = math.sqrt(1.0 - 1.0 / gamma0 ** 2)
        rows += [np.full(nb, gamma0), np.full(nb, beta0)]
    kernel = dev.type != "cpu"
    if kernel:
        rows += frame_grids(gam, gamma0)
    grids = on_device(rows, dev)
    dn_cr, dn_th = _dn_frames([psd, therm], bins, e0, gamma_sf_grid,
                              gamma0, i_approx,
                              frames=grids[-2:] if kernel else None)
    total = psd + therm
    d2n_tot = d2n_boosted(total, grids[0], grids[1], e0, bins)
    d2n_ef = None
    if want_ef:
        d2n_ef = d2n_boosted(total, grids[2], grids[3], e0,
                             bins) / bin_tables(bins, dev).dp[:, None, None]
    out = (dn_cr, dn_th, d2n_tot, d2n_ef)
    if not fetch:
        return out
    return tuple(None if a is None else a.cpu().numpy() for a in out)


# ---------------------------------------------------------------------------
# zone populations (set_grid_volumes!, particle_counter.jl:1466-1524)
# ---------------------------------------------------------------------------

def shell_surface_areas(x_grid_cm: np.ndarray, i_shock: int,
                        gamma0: float, jet_rad_pc: float,
                        jet_sph_frac: float) -> np.ndarray:
    """Spherical-cap shell surface area per zone [cm^2] from the jet
    geometry (set_grid_volumes!, particle_counter.jl:1476-1505); unit
    area when no jet radius is configured."""
    nb = len(x_grid_cm)
    dx = np.diff(x_grid_cm)
    surf = np.ones(nb)
    if jet_rad_pc > 0:
        jet_rad_cm = jet_rad_pc * PC_CM
        rad_min = jet_rad_cm - x_grid_cm[i_shock]
        for i in range(i_shock - 1, 0, -1):
            rad_max = rad_min + dx[i] / gamma0
            surf[i] = math.pi * (rad_max + rad_min) ** 2 * jet_sph_frac
            rad_min = rad_max
        rad_max = jet_rad_cm - x_grid_cm[i_shock]
        for i in range(i_shock, nb - 1):
            rad_min = rad_max - dx[i] / gamma0
            surf[i] = math.pi * (rad_max + rad_min) ** 2 * jet_sph_frac
            rad_max = rad_min
    return surf


def zone_populations(x_grid_cm: np.ndarray, i_shock: int, n0_ion: float,
                     beta0: float, gamma0: float, jet_rad_pc: float,
                     jet_sph_frac: float, ux_sk_grid: np.ndarray,
                     gamma_sf_grid: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(zone_pop, zone_vol) per boundary index (length nb): upstream
    particle flux x shell surface area x dwell time."""
    nb = len(x_grid_cm)
    dx = np.diff(x_grid_cm)
    surf = shell_surface_areas(x_grid_cm, i_shock, gamma0, jet_rad_pc,
                               jet_sph_frac)

    zone_pop = np.zeros(nb)
    zone_vol = np.zeros(nb)
    f_up = gamma0 * n0_ion * beta0 * C_CGS
    for i in range(1, nb - 1):
        dwell = dx[i] / ux_sk_grid[i]
        zone_pop[i] = f_up * surf[i] * dwell
        density_pf = gamma0 * ux_sk_grid[1] / (gamma_sf_grid[i]
                                               * ux_sk_grid[i])
        zone_vol[i] = zone_pop[i] / max(density_pf, 1e-300)
    return zone_pop, zone_vol


def normalize_dndp(dndp_cr_arr, dndp_therm_arr, mom_edges, zone_pop,
                   n0_ion: float, gamma0: float, ux_sk_grid,
                   gamma_sf_grid):
    """Normalize thermal + CR dN/dp so each zone integrates to its
    population (get_normalized_dNdp, particle_counter.jl:730-778).
    Arrays are [n_mom+1, nb, 3]; returns (therm, cr) as new arrays."""
    dp = np.diff(np.asarray(mom_edges))[:, None, None]
    area_therm = (np.asarray(dndp_therm_arr) * dp).sum(axis=0)   # [nb, 3]
    area_cr = (np.asarray(dndp_cr_arr) * dp).sum(axis=0)
    # fast-push zones with no thermal crossings approximate the thermal
    # area by the compressed density / local speed
    # (particle_counter.jl:756-758)
    density_pf = (gamma0 * np.asarray(ux_sk_grid)[1]
                  / (np.asarray(gamma_sf_grid) * np.asarray(ux_sk_grid)))
    area_tot = np.where((area_therm == 0) & (area_cr > 0),
                        (n0_ion * density_pf[:, None]
                         / np.asarray(ux_sk_grid)[:, None]) + area_cr,
                        area_therm + area_cr)
    ok = area_tot > 0
    norm = np.zeros_like(area_tot)
    np.divide(np.broadcast_to(np.asarray(zone_pop)[:, None],
                              area_tot.shape),
              area_tot, out=norm, where=ok)
    return (np.asarray(dndp_therm_arr) * norm[None, :, :],
            np.asarray(dndp_cr_arr) * norm[None, :, :])


# ---------------------------------------------------------------------------
# pressures (thermo_calcs.jl) and the ISM-frame normalization
# ---------------------------------------------------------------------------

def thermo_calcs(psd, therm_psd, bins: PsdBins, m_ion: float,
                 zone_pop, num_crossings, n0_ion: float, t0_ion: float,
                 zz_ion: float, beta0: float, gamma0: float,
                 ux_sk_grid, gamma_sf_grid, d2n):
    """Anisotropic pressure + kinetic-energy density per zone
    (thermo_calcs.jl:29-352) from ion_reduce_device's plasma-frame
    d2N `d2n`.  Returns (P_par, P_perp, energy_density) of length nb."""
    e0 = m_ion * C_CGS**2
    mc = m_ion * C_CGS
    nb = psd.shape[-1]
    gam = np.asarray(gamma_sf_grid)

    p_cent = bins.mom_centers
    cos_cent = bins.cos_centers()
    vel = p_cent * C_CGS / (mc * np.hypot(1.0, p_cent / mc))
    g_cent = np.hypot(1.0, p_cent / mc)

    p_par = np.zeros(nb)
    p_perp = np.zeros(nb)
    e_dens = np.zeros(nb)
    ncross = np.asarray(num_crossings)
    zpop = np.asarray(zone_pop)

    for i in range(1, nb - 1):
        density_loc = (gamma0 * beta0 * n0_ion
                       / max(math.sqrt(max(gam[i] ** 2 - 1.0, 1e-300)),
                             1e-300))
        has_parts = d2n[:, :, i].max() > 0
        if (not has_parts) and ncross[i] == 0:
            # case 1: untracked thermal plasma only — analytic adiabatic
            # pressure (thermo_calcs.jl:258-279)
            pres = density_loc ** (5.0 / 3.0) * KB_CGS * t0_ion
            p_par[i] = pres / 3.0
            p_perp[i] = 2.0 * pres / 3.0
            e_dens[i] = 1.5 * pres
            continue
        if ncross[i] == 0:
            # case 2: CRs only; thermal part analytic, scaled by the
            # untracked fraction (thermo_calcs.jl:281-306)
            pres = density_loc ** (5.0 / 3.0) * KB_CGS * t0_ion
            d2n_pop = d2n[:, :, i].sum()
            pres *= max(1.0 - d2n_pop / max(zpop[i], 1e-300), 0.0)
            p_par[i] = pres / 3.0
            p_perp[i] = 2.0 * pres / 3.0
            e_dens[i] = 1.5 * pres
        norm = density_loc / max(zpop[i], 1e-300)
        w = d2n[:, :, i] * norm
        pf = (p_cent * vel / 3.0)[:, None]
        mu2 = (cos_cent ** 2)[None, :]
        p_par[i] += float((w * pf * mu2).sum())
        p_perp[i] += float((w * pf * (1.0 - mu2)).sum())
        e_dens[i] += float((w * ((g_cent - 1.0) * e0)[:, None]).sum())

    return p_par, p_perp, e_dens


def ef_zone_norm(psd, therm_psd, zone_pop, num_crossings,
                 n0_ion: float) -> np.ndarray:
    """Per-zone population normalization factor [nb] for the ISM-frame
    d2N (particle_counter.jl:480-518), float64 on the host (zone
    populations are ~1e50 in CGS)."""
    total = np.asarray(psd, np.float64) + np.asarray(therm_psd, np.float64)
    density_tot = total.sum(axis=(0, 1))
    density_tot = np.where((np.asarray(num_crossings) == 0)
                           & (density_tot > 0),
                           density_tot + n0_ion, density_tot)
    norm = np.zeros_like(density_tot)
    np.divide(np.asarray(zone_pop), density_tot, out=norm,
              where=density_tot > 0)
    return norm


def normalized_total_ef(psd, therm_psd, zone_pop, num_crossings,
                        n0_ion: float) -> np.ndarray:
    """CR+thermal histogram normalized to zone populations
    (particle_counter.jl:480-518; the JAX package's reduce.py:607): the
    input to the ISM-frame boost, float64."""
    norm = ef_zone_norm(psd, therm_psd, zone_pop, num_crossings, n0_ion)
    total = np.asarray(psd, np.float64) + np.asarray(therm_psd, np.float64)
    return total * norm[None, None, :]


def dndp_2d_ef(psd, therm_psd, bins: PsdBins, m_ion: float, zone_pop,
               num_crossings, n0_ion: float, beta0: float,
               gamma0: float) -> np.ndarray:
    """ISM-frame d2N/(dp dcos) for the electron IC calculation
    (get_dNdp_2D, particle_counter.jl:343-613; the JAX package's
    reduce.py:569): the zone-normalized CR + thermal histogram, its cell
    centers boosted into the ISM frame, per dp, [n_mom+1, n_theta+1, nb]
    float64."""
    e0 = m_ion * C_CGS**2
    total = torch.from_numpy(normalized_total_ef(
        psd, therm_psd, zone_pop, num_crossings, n0_ion))
    nb = total.shape[-1]
    out = d2n_boosted(total, np.full(nb, gamma0), np.full(nb, beta0), e0,
                      bins).numpy()
    return out / np.diff(bins.mom_edges)[:, None, None]


def pitch_histograms(psd, bins: PsdBins, decades_per_group: int = 1
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Normalized pitch-cosine distributions per momentum group and zone
    (the reference's dormant track_pitch_angles, transformers.jl:319-401;
    the JAX package's reduce.py:542): the PSD summed over groups of
    ``decades_per_group`` momentum decades, divided by the cosine bin
    widths.  Returns (cos_centers [n_theta+1], hist [n_groups,
    n_theta+1, nb]), each nonempty (group, zone) column summing to 1."""
    dcos = np.abs(np.diff(bins.cos_bounds()))           # [n_theta+1]
    n_per_group = bins.bins_per_dec_mom * decades_per_group
    p = np.asarray(psd)
    n_groups = (p.shape[0] + n_per_group - 1) // n_per_group
    out = np.zeros((n_groups, bins.n_theta + 1, p.shape[-1]))
    for g in range(n_groups):
        out[g] = p[g * n_per_group:(g + 1) * n_per_group].sum(axis=0) \
            / dcos[:, None]
    tot = out.sum(axis=1, keepdims=True)
    out = np.divide(out, tot, out=np.zeros_like(out), where=tot > 0)
    return bins.cos_centers(), out
