"""Pitch-angle scattering on torch tensors, at either momentum dtype.

Counterpart of the JAX package's ops/scattering.py ``scattering``
(scattering.jl:29-101): a random small-angle deflection on the unit
sphere whose largest angle is set by the mean free path lambda =
eta * r_g, with the electron constant-MFP regime below ``pe_crit``.
Callers pass ``cos_max``: one of the two precomputed values, or the
custom f(r_g) law's per-lane one (ops/step.py).  Also ``radiation_loss``, the electrons'
synchrotron + inverse-Compton loss of one step.

The uniforms arrive as float32 (the XLA engine's stream, rng.py), and
the scattering phase is formed in float32 before it meets the momenta,
as the reference forms it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


_PI32 = float(torch.tensor(math.pi, dtype=torch.float32))


class ScatterResult(NamedTuple):
    gyro_period: torch.Tensor   # [s]
    pb: torch.Tensor
    pperp: torch.Tensor
    phi: torch.Tensor


def scattering(u1, u2, pb, pperp, ptot, gamma_pf, gyro_denom,
               is_electron: bool, pe_crit, gamma_e_crit, mc,
               cos_max, phi=None, phase_adjust: bool = False
               ) -> ScatterResult:
    """One scattering event per lane.  `gyro_denom` is 1/(|z| q B);
    `mc`, `pe_crit`, `gamma_e_crit` are scalars or 0-dim tensors of the
    momentum dtype; `cos_max` broadcasts against the lanes.  With
    `phase_adjust` the gyro phase `phi` takes the Ellison+ (1990)
    adjustment (get_sine_adjustment, scattering.jl:93-101), observable
    only in an oblique field; otherwise `phi` comes back as given."""
    period = gyro_period(ptot, gamma_pf, gyro_denom, is_electron, pe_crit,
                         gamma_e_crit, mc)

    # the guard in the momentum dtype: 1e-300 is 0 in float32, as the
    # reference's weakly typed constant is
    safe_ptot = torch.clamp(ptot, min=1.0e-300)
    cos_old = pb / safe_ptot
    sin_old = pperp / safe_ptot

    cos_dt = 1.0 - u1 * (1.0 - cos_max)
    sin_dt = torch.sqrt(torch.clamp(1.0 - cos_dt * cos_dt, min=0.0))
    # the float32 phase u2 * 2pi - pi, rounded once as the reference's
    # fused multiply-add rounds it: the product of two float32 values is
    # exact in float64
    phi_scat = ((u2.double() * 2.0) * _PI32 - _PI32).to(u2.dtype)

    cos_new = torch.clamp(cos_old * cos_dt
                          + sin_old * sin_dt * torch.cos(phi_scat),
                          -1.0, 1.0)
    sin_new = torch.sqrt(torch.clamp(1.0 - cos_new * cos_new, min=0.0))
    if phase_adjust:
        # the float32 sine of the float32 phase, as the reference forms it
        sin_dphi = torch.where(
            sin_new > 0.0,
            torch.sin(phi_scat) * sin_dt / torch.clamp(sin_new, min=1.0e-300),
            0.0)
        limit = 1.0 - 1.0e-15
        phi = phi + torch.asin(torch.clamp(sin_dphi, -limit, limit))
    return ScatterResult(period, ptot * cos_new, ptot * sin_new, phi)


def gyro_period(ptot, gamma_pf, gyro_denom, is_electron: bool, pe_crit,
                gamma_e_crit, mc):
    """The gyro period [s], with the electrons' constant-MFP Lorentz
    factor below ``pe_crit`` (scattering.jl:39-45)."""
    if is_electron:
        g_eff = torch.where(ptot < pe_crit, gamma_e_crit, gamma_pf)
    else:
        g_eff = gamma_pf
    return 2.0 * math.pi * g_eff * mc * gyro_denom


def radiation_loss(b_sq, p, dt, rad_loss_fac):
    """Synchrotron + inverse-Compton momentum loss over one step
    (particle_loop.jl:578-592; ops/scattering.py:92-100 of the JAX
    package): d(ln p) = rad_loss_fac * B_eff^2 * p * dt, integrated
    implicitly where the explicit step would overshoot.  `rad_loss_fac`
    is constants.RAD_LOSS_FAC (a Python float or a 0-dim tensor of the
    momentum dtype)."""
    dlnp = rad_loss_fac * b_sq * p * dt
    return torch.where(dlnp > 1.0e-2, p / (1.0 + dlnp), p * (1.0 - dlnp))
