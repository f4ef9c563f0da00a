"""Rankine-Hugoniot jump conditions and escaping-flux predictions.

Re-derives the reference's shock jump solvers:
  * calc_downstream           (initializers.jl:43-50)
  * calc_rRH  nonrelativistic (initializers.jl:100-117, Ellison 1985 Eq 11)
  * calc_rRH  relativistic    (initializers.jl:143-195, Ellison & Reynolds 1991)
  * q_esc_calcs               (q_esc_calcs.jl:11-125)

Note on regime selection: the reference's calc_rRH flips the
relativistic test (initializers.jl:77 has `relativistic = (beta0 <
beta_rel_fl)`), which contradicts every other use of beta_rel_fl in the
code base and the R-H value 3.00884 quoted for the gamma0 = 5 baseline
(mc_in.toml:157).  We implement the intended test: relativistic when
beta0 >= BETA_REL_FL.
"""

from __future__ import annotations

import math
from typing import Sequence

from ..utils.constants import C_CGS, KB_CGS, MP_CGS
from ..utils.params import BETA_REL_FL
from ..utils.rootfind import bisect, newton
from ..utils.species import Species


def calc_downstream(bmag0: float, r_comp: float, beta0: float
                    ) -> tuple[float, float, float, float, float]:
    """Downstream state for a parallel test-particle shock with known
    compression ratio (initializers.jl:43-50).

    Returns (beta2, gamma2, bmag2, theta_B2_deg, theta_u2_deg).
    """
    beta2 = beta0 / r_comp
    gamma2 = 1.0 / math.sqrt(1.0 - beta2 * beta2)
    return beta2, gamma2, bmag0, 0.0, 0.0


def _thermo_upstream(species: Sequence[Species]) -> tuple[float, float]:
    """(P0 [erg/cm^3], rho0 [g/cm^3]) of the far-upstream gas."""
    p0 = sum(s.number_density * s.temperature for s in species) * KB_CGS
    rho0 = sum(s.number_density * s.mass for s in species)
    return p0, rho0


def calc_rRH(beta0: float, gamma0: float, species: Sequence[Species]
             ) -> tuple[float, float]:
    """Test-particle compression ratio and downstream adiabatic index
    (initializers.jl:73-90).  Returns (r_RH, Gamma2_RH)."""
    p0, rho0 = _thermo_upstream(species)
    if beta0 >= BETA_REL_FL:
        return _calc_rRH_relativistic(species, rho0, p0, beta0, gamma0)
    return _calc_rRH_nonrelativistic(p0, rho0, beta0)


def _calc_rRH_nonrelativistic(p0: float, rho0: float, beta0: float
                              ) -> tuple[float, float]:
    """Ellison (1985) Eq 11 with q_esc = 0 (initializers.jl:100-117)."""
    gamma_sph = 5.0 / 3.0
    cs = math.sqrt(gamma_sph * p0 / rho0)
    mach = beta0 * C_CGS / cs
    r_rh = 8.0 / (2.0 + 6.0 / mach**2)
    return r_rh, 5.0 / 3.0


def _calc_rRH_relativistic(species: Sequence[Species], rho0: float,
                           p0: float, beta0: float, gamma0: float
                           ) -> tuple[float, float]:
    """Ellison & Reynolds (1991) Newton solve for the downstream
    delta-function momentum (initializers.jl:143-195).

    The downstream population is taken as a delta function in momentum
    with p proportional to mass for heavier species; Newton's method
    finds the proton momentum p2 satisfying the R-H momentum-flux
    relation, and r_RH follows from the number-flux relation.
    """
    n0_p = species[0].number_density
    e0_ion = sum(s.number_density * s.mass for s in species) * C_CGS**2
    rel_e = e0_ion / n0_p  # rest-energy density per unit proton density

    gamma_sph = 5.0 / 3.0
    xi = gamma_sph / (gamma_sph - 1.0)
    w0 = rho0 * C_CGS**2 + xi * p0
    w0_per = w0 / n0_p  # upstream enthalpy per unit proton density

    upstream_mom_flux = gamma0**2 * w0 * beta0**2 + p0
    upstream_num_flux = gamma0 * n0_p * beta0

    # Per-proton downstream quantities for an isotropic delta-shell of
    # plasma-frame momentum p = gb * m c (heavier species carry p ~ m):
    #     P_per = rel_e * gb^2 / (3 g),  w_per = rel_e * (g + gb^2 / (3 g)).
    # Number + energy flux (RH1, RH3) combine to
    #     gamma_flow = gamma0 * w0_per / w_per,
    # and the momentum flux (RH2) residual closes the system:
    #     F(gb) = num_flux * (w_per * gf*bf + P_per / (gf*bf)) - F_px0.
    # F has the trivial upstream root at gb -> 0 and diverges to +inf as
    # gamma_flow -> 1+, so the shock root is bracketed by (eps, gb_max).
    def flow_gamma(gb: float) -> float:
        g = math.sqrt(1.0 + gb * gb)
        w_per = rel_e * (g + gb * gb / (3.0 * g))
        return gamma0 * w0_per / w_per

    def residual(gb: float) -> float:
        g = math.sqrt(1.0 + gb * gb)
        p_per = rel_e / 3.0 * gb * gb / g
        w_per = rel_e * (g + gb * gb / (3.0 * g))
        gf = flow_gamma(gb)
        gfbf = math.sqrt(max(gf * gf - 1.0, 1.0e-300))
        return (upstream_num_flux * (w_per * gfbf + p_per / gfbf)
                - upstream_mom_flux)

    # upper bracket: gamma_flow(gb_max) = 1 + tiny
    gb_max = bisect(lambda gb: flow_gamma(gb) - (1.0 + 1.0e-9),
                    1.0e-6, 1.0e6)
    # lower bracket: step away from the trivial root until residual < 0
    gb_lo = 1.0e-3 * gb_max
    while residual(gb_lo) > 0 and gb_lo < 0.5 * gb_max:
        gb_lo *= 2.0
    gb2 = bisect(residual, gb_lo, gb_max * (1.0 - 1.0e-12))

    g = math.sqrt(1.0 + gb2 * gb2)
    p_fac = rel_e / 3.0 * gb2 * gb2 / g
    e_fac = rel_e * (g - 1.0)
    gamma2_rh = 1.0 + p_fac / e_fac

    gamma_flow2 = flow_gamma(gb2)
    beta2 = math.sqrt(max(1.0 - 1.0 / gamma_flow2**2, 0.0))
    r_rh = beta0 / beta2
    return r_rh, gamma2_rh


# ---------------------------------------------------------------------------
# Escaping-flux predictions (q_esc_calcs.jl)
# ---------------------------------------------------------------------------

def q_esc_calcs(gamma_ad: float, r_comp: float, r_rh: float,
                u0: float, beta0: float, gamma0: float,
                species: Sequence[Species],
                gamma2: float, beta2: float, u2: float
                ) -> tuple[float, float]:
    """Expected escaping (momentum, energy) fluxes in units of the far
    upstream fluxes (q_esc_calcs.jl:11-36).

    Returns (q_esc_px, q_esc_energy).  Zero when r_comp == r_RH.
    """
    if r_comp == r_rh:
        return 0.0, 0.0
    gamma_fac = gamma_ad / (gamma_ad - 1.0)
    p0, rho0 = _thermo_upstream(species)
    if beta0 >= BETA_REL_FL:
        q_en, q_px = _q_esc_relativistic(
            p0, rho0, u0, beta0, gamma0, u2, beta2, gamma2, gamma_fac)
    else:
        q_en, q_px = _q_esc_nonrelativistic(
            p0, rho0, u0, beta0, gamma0, u2, beta2, gamma2, gamma_fac)
    return q_px, q_en


def _q_esc_nonrelativistic(p0, rho0, u0, beta0, gamma0, u2, beta2, gamma2,
                           gamma_fac) -> tuple[float, float]:
    """Ellison (1985) Eqs 8-10; zero escaping momentum flux assumed
    (q_esc_calcs.jl:47-68)."""
    f_px_fl = rho0 * u0**2 + p0
    f_en_fl = rho0 * u0**3 / 2.0 + 2.5 * p0 * u0
    rho2 = rho0 * gamma0 * beta0 / (gamma2 * beta2)
    p2 = f_px_fl - rho2 * u2**2
    q_en = f_en_fl - rho0 * u0 * u2**2 / 2.0 - p2 * u2 * gamma_fac
    return q_en / f_en_fl, 0.0


def _q_esc_relativistic(p0, rho0, u0, beta0, gamma0, u2, beta2, gamma2,
                        gamma_fac) -> tuple[float, float]:
    """Ellison+ (1991) relativistic R-H with closure
    Q_en = sqrt((1+beta0)/2) * c * Q_px (q_esc_calcs.jl:97-125)."""
    q_fac = C_CGS * math.sqrt((1.0 + beta0) / 2.0)
    f_px_fl = gamma0**2 * beta0**2 * (rho0 * C_CGS**2 + 2.5 * p0) + p0
    f_en_fl = gamma0**2 * u0 * (rho0 * C_CGS**2 + 2.5 * p0)
    term_aux = gamma2**2 * (q_fac * beta2**2 - u2)
    rho2 = rho0 * gamma0 * beta0 / (gamma2 * beta2)
    p2 = ((q_fac * f_px_fl - f_en_fl - term_aux * rho2 * C_CGS**2)
          / (q_fac + gamma_fac * term_aux))
    q_px = f_px_fl - (gamma2 * beta2)**2 * (rho2 * C_CGS**2 + gamma_fac * p2) - p2
    q_en = q_px * q_fac
    return (q_en / (f_en_fl - gamma0 * u0 * rho0 * C_CGS**2),
            q_px / f_px_fl)
