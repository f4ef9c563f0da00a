"""Phase-space-distribution (PSD) bin construction and lookup.

Mirrors:
  * set_psd_mom_bins    (initializers.jl:216-237)
  * set_psd_angle_bins  (initializers.jl:265-285)
  * get_psd_bin_momentum / get_psd_bin_angle (get_psd_bins.jl:16-97)
  * psd_mom_min / psd_mom_max derivation (MonteCarloScattering.jl:276-338)
  * cos-center tables (particle_counter.jl:618-644, thermo_calcs.jl:53-70)

Construction is host-side NumPy (run once); the bin-index functions are
torch and run on the tensor's device (the transport kernel K1 and its
twin, ops/mega.py, bin with the same arithmetic).

Conventions:
  * Momentum bins are logarithmic, 1-based content bins 1..n_mom with
    bin 0 the underflow (p < psd_mom_min).  ``psd_mom_bounds`` holds
    log10(p/cgs) LOWER edges at indices 0..n_mom+1 with bounds[0] = -99
    sentinel (as in the reference).
  * Angle bins index the NEGATIVE shock-frame pitch cosine: the finest
    (log-theta) bins point upstream.  Bin 0 is theta < psd_theta_min.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.constants import C_CGS, KB_CGS, KEV_ERG, MP_C
from ..utils.params import PSD_MAX
from ..utils.species import Species


@dataclass(frozen=True)
class PsdBins:
    """Static PSD binning description shared by all kernels."""

    # momentum axis
    n_mom: int                      # content bins 1..n_mom (+ underflow 0)
    mom_bounds_log: np.ndarray      # [n_mom + 2] log10(p [g cm/s]) lower edges
    psd_mom_min: float              # [g cm/s]
    bins_per_dec_mom: int
    # angle axis
    n_theta: int                    # content bins 1..n_theta (+ bin 0)
    theta_bounds: np.ndarray        # [n_theta + 2] mixed theta/cos bounds
    bins_per_dec_theta: int
    lin_cos_bins: int
    cos_fine: float                 # lin-cos / log-theta split (in -cos units)
    dcos: float                     # linear cosine bin width
    theta_min: float                # [rad]

    @property
    def mom_centers(self) -> np.ndarray:
        """Geometric bin centers [g cm/s] for bins 0..n_mom (bin 0 uses
        its upper edge's decade; matches pt_center of thermo_calcs.jl:72-77)."""
        b = self.mom_bounds_log
        return 10.0 ** ((b[:-1] + b[1:]) / 2.0)

    @property
    def mom_edges(self) -> np.ndarray:
        """Linear-space bin edges [g cm/s] (10**bounds)."""
        return 10.0 ** self.mom_bounds_log

    def cos_centers(self) -> np.ndarray:
        """True pitch-cosine centers of the angle bins 0..n_theta
        (particle_counter.jl:618-644).  Includes the sign flip: bins
        index -cos(theta)."""
        tb = self.theta_bounds
        n = self.n_theta
        out = np.zeros(n + 1)
        for j in range(n + 1):
            if j > n - self.lin_cos_bins:
                cos_hi, cos_lo = tb[j], tb[j + 1]
            elif j == n - self.lin_cos_bins:
                cos_hi, cos_lo = math.cos(tb[j]), tb[j + 1]
            else:
                cos_hi, cos_lo = math.cos(tb[j]), math.cos(tb[j + 1])
            out[j] = -(cos_lo + cos_hi) / 2.0
        return out

    def cos_bounds(self) -> np.ndarray:
        """True pitch-cosine bounds ct[0..n_theta+1], decreasing from
        ~ -cos(theta_min) down to ... (get_dNdp_cr ct_bounds,
        particle_counter.jl:52-62)."""
        tb = self.theta_bounds
        n = self.n_theta
        out = np.full(n + 2, -2.0)
        for j in range(n + 2):
            if j > n - self.lin_cos_bins:
                out[j] = -tb[j]
            else:
                out[j] = -math.cos(tb[j])
        return out


def set_psd_mom_bins(psd_mom_min: float, psd_mom_max: float,
                     bins_per_dec: int) -> tuple[int, np.ndarray]:
    """Log momentum bin LOWER edges (initializers.jl:216-237).

    Returns (n_mom, bounds_log[n_mom+2]) with bounds_log[0] = -99.
    """
    n_mom = int(math.log10(psd_mom_max / psd_mom_min) * bins_per_dec) + 2
    log_p_min = math.log10(psd_mom_min)
    bounds = np.concatenate([
        [-99.0],
        log_p_min + np.arange(n_mom + 1) / bins_per_dec,
    ])
    assert len(bounds) == n_mom + 2
    return n_mom, bounds


def set_psd_angle_bins(bins_per_dec_theta: int, lin_cos_bins: int,
                       cos_fine: float, theta_min: float
                       ) -> tuple[float, np.ndarray, int]:
    """Hybrid lin-cos / log-theta angle bounds (initializers.jl:265-285).

    Returns (dcos, theta_bounds, n_theta).  theta_bounds[j] is the
    lower-theta edge of bin j: radians for the log region
    (j <= n_theta - lin_cos_bins), the p_cos = -pitch-cosine value for
    the linear region (descending with j), ending at -1.  The array is
    monotone in ANGLE, not in raw value; the reference's trailing
    `sort!` (initializers.jl:281) would scramble this mixed layout, so
    we keep the intended ordering instead.
    """
    theta_fine = math.acos(cos_fine)
    n_log = int(math.log10(theta_fine / theta_min) * bins_per_dec_theta)
    bounds = [1.0e-99]
    bounds.extend(theta_min * 10.0 ** (np.arange(n_log) / bins_per_dec_theta))
    dcos = (cos_fine + 1.0) / lin_cos_bins
    bounds.extend(cos_fine - dcos * np.arange(lin_cos_bins + 1))
    out = np.asarray(bounds)
    n_theta = len(out) - 2
    return dcos, out, n_theta


def build_psd_bins(cfg_species: list[Species], inp_distr: int,
                   energy_inj: float, emin_therm_fac: float,
                   emax: float, emax_per_aa: float, pmax: float,
                   gamma0: float, bins_per_dec_mom: int,
                   bins_per_dec_theta: int, lin_cos_bins: int,
                   log_theta_decs: int) -> PsdBins:
    """Full PSD bin setup (MonteCarloScattering.jl:276-338)."""
    cos_fine = 1.0 - 2.0 / (lin_cos_bins + 1)
    theta_fine = math.acos(cos_fine)
    theta_min = theta_fine / 10.0 ** log_theta_decs

    # minimum energy from the thermal floor or the delta-function energy
    if inp_distr == 1:
        # The reference converts T to energy with Unitful's Thermal()
        # equivalence E = k T (MonteCarloScattering.jl:284-285).
        t_min = min(s.temperature for s in cfg_species)
        emin = KB_CGS * t_min * emin_therm_fac
    elif inp_distr == 2:
        emin = energy_inj / 5.0
    else:
        raise ValueError(f"unknown input distribution {inp_distr}")

    # minimum momentum: lightest species (MonteCarloScattering.jl:297-306)
    m_min = min(s.mass for s in cfg_species)
    e0_min = m_min * C_CGS**2
    if emin < e0_min / 1000.0:
        psd_mom_min = math.sqrt(2.0 * m_min * emin)
    else:
        g = 1.0 + emin / e0_min
        psd_mom_min = m_min * C_CGS * math.sqrt(g * g - 1.0)

    # maximum momentum: heaviest species (MonteCarloScattering.jl:311-331)
    m_max = max(s.mass for s in cfg_species)
    e0_max = m_max * C_CGS**2
    if emax > 0:
        g = 1.0 + emax / e0_max
        psd_mom_max = m_max * C_CGS * math.sqrt(g * g - 1.0)
    elif emax_per_aa > 0:
        g = 1.0 + emax_per_aa / (MP_C * C_CGS)
        psd_mom_max = m_max * C_CGS * math.sqrt(g * g - 1.0)
    elif pmax > 0:
        psd_mom_max = pmax
    else:
        raise ValueError("maximum energy not set; cannot size PSD bins")
    psd_mom_max *= 2.0 * gamma0  # SF->PF Lorentz headroom

    n_mom, mom_bounds = set_psd_mom_bins(psd_mom_min, psd_mom_max,
                                         bins_per_dec_mom)
    dcos, theta_bounds, n_theta = set_psd_angle_bins(
        bins_per_dec_theta, lin_cos_bins, cos_fine, theta_min)

    if n_mom > PSD_MAX or n_theta > PSD_MAX:
        raise ValueError(
            f"PSD bins exceed PSD_MAX={PSD_MAX}: n_mom={n_mom}, "
            f"n_theta={n_theta}")

    return PsdBins(
        n_mom=n_mom, mom_bounds_log=mom_bounds, psd_mom_min=psd_mom_min,
        bins_per_dec_mom=bins_per_dec_mom,
        n_theta=n_theta, theta_bounds=theta_bounds,
        bins_per_dec_theta=bins_per_dec_theta, lin_cos_bins=lin_cos_bins,
        cos_fine=cos_fine, dcos=dcos, theta_min=theta_min,
    )


# ---------------------------------------------------------------------------
# torch bin lookups (the escape binning and the reductions)
# ---------------------------------------------------------------------------

def psd_bin_momentum(ptot: torch.Tensor, psd_mom_min: float,
                     bins_per_dec: int, n_mom: int) -> torch.Tensor:
    """Vectorized momentum bin index (get_psd_bins.jl:16-39), int32.

    Bin 0 for p < psd_mom_min; clamped at n_mom on overflow.
    """
    tiny = torch.finfo(ptot.dtype).tiny
    safe = torch.clamp(ptot, min=tiny)
    # log-space difference (a ratio overflows f32 over ~40 decades)
    logr = torch.log10(safe) - math.log10(psd_mom_min)
    b = torch.floor(logr * bins_per_dec).to(torch.int32) + 1
    b = torch.where(ptot < psd_mom_min, 0, b)
    return torch.clamp(b, 0, n_mom).to(torch.int32)


def psd_bin_angle(px: torch.Tensor, ptot: torch.Tensor, cos_fine: float,
                  dcos: float, theta_min: float, bins_per_dec_theta: int,
                  n_theta: int) -> torch.Tensor:
    """Vectorized angle bin index (get_psd_bins.jl:73-97), int32.

    Bins the NEGATIVE pitch cosine -px/ptot; log-theta spacing above
    cos_fine, linear cosine below.
    """
    tiny = torch.finfo(ptot.dtype).tiny
    safe_ptot = torch.clamp(ptot, min=tiny)
    p_cos = torch.clamp(-px / safe_ptot, -1.0, 1.0)

    lin_bin = n_theta - torch.floor((p_cos + 1.0) / dcos).to(torch.int32)

    theta = torch.acos(p_cos)
    safe_theta = torch.clamp(theta, min=tiny)
    log_bin = (torch.floor(
        (torch.log10(safe_theta) - math.log10(theta_min))
        * bins_per_dec_theta).to(torch.int32) + 1)
    log_bin = torch.where(theta < theta_min, 0, log_bin)

    b = torch.where(p_cos < cos_fine, lin_bin, log_bin)
    b = torch.where(ptot <= 0.0, 0, b)
    return torch.clamp(b, 0, n_theta).to(torch.int32)
