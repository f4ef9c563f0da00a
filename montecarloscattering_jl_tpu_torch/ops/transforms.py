"""Lorentz frame transforms for particle momenta, on torch tensors.

Counterpart of the JAX package's ops/transforms.py: ``transform_p_ps``
(plasma -> shock frame, transformers.jl:440-476), used by the exit
bookkeeping; its parallel-field forms ``transform_p_ps_parallel`` and
``transform_p_psp_parallel``, used by the XLA engine's step; and
``boost_x`` (the center-point rebinning boost, thermo_calcs.jl:144-158),
used by the reductions.  Elementwise, no control flow; every argument
broadcasts.  The oblique plasma -> shock -> plasma transform is not
ported (ROADMAP.md item 2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ShockFrameMomentum(NamedTuple):
    ptot_sk: torch.Tensor
    px_sk: torch.Tensor
    py_sk: torch.Tensor
    pz_sk: torch.Tensor
    gamma_sk: torch.Tensor


def plasma_xyz(pb, pperp, phi, b_cos, b_sin):
    """Plasma-frame xyz components from (pb, pperp, phi)
    (transformers.jl:447-459)."""
    phi_p = phi + math.pi / 2.0
    p_p_cos = pperp * torch.cos(phi_p)
    px = pb * b_cos - p_p_cos * b_sin
    py = pperp * torch.sin(phi_p)
    pz = pb * b_sin + p_p_cos * b_cos
    return px, py, pz


def transform_p_ps(pb, pperp, gamma_pf, phi, ux, uz, utot, gamma_sf,
                   b_cos, b_sin, m, c: float) -> ShockFrameMomentum:
    """Plasma -> shock frame (transform_p_PS, transformers.jl:440-476);
    `m` is the particle mass [g], `ux` the local bulk flow [cm/s] and
    `gamma_sf` its Lorentz factor."""
    px, py, pz = plasma_xyz(pb, pperp, phi, b_cos, b_sin)
    dpx = (gamma_sf - 1.0) * px + gamma_sf * gamma_pf * m * ux
    px_sk = px + dpx
    ptot_sk = torch.sqrt(px_sk * px_sk + py * py + pz * pz)
    gamma_sk = torch.hypot(ptot_sk / (m * c), torch.ones_like(ptot_sk))
    return ShockFrameMomentum(ptot_sk, px_sk, py, pz, gamma_sk)


def hyp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.hypot's formula: max * sqrt(1 + (min/max)^2), 0 at 0."""
    a = a.abs()
    b = b.abs()
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    zero = hi == 0
    r = lo / torch.where(zero, torch.ones_like(hi), hi)
    return torch.where(zero, hi, hi * torch.sqrt(1.0 + r * r))


def transform_p_ps_parallel(pb, pperp, gamma_pf, ux, gamma_sf, m,
                            c: float):
    """Plasma -> shock frame for a parallel shock (theta_B = 0,
    transforms.py:127-139 of the JAX package): pb is p_x and pperp is
    boost-invariant.  Returns (ptot_sk, px_sk, gamma_sk)."""
    px_sk = gamma_sf * (pb + gamma_pf * m * ux)
    ptot_sk = hyp(px_sk, pperp)
    gamma_sk = hyp(ptot_sk / (m * c), torch.ones_like(ptot_sk))
    return ptot_sk, px_sk, gamma_sk


def transform_p_psp_parallel(pb, pperp, gamma_pf, ux_old, gamma_sf_old,
                             ux, gamma_sf, m, c: float):
    """Old plasma -> shock -> new plasma frame for a parallel shock
    (transforms.py:142-155): only the parallel component boosts.
    Returns (pb_new, gamma_pf_new); pperp is unchanged."""
    px_sk = gamma_sf_old * (pb + gamma_pf * m * ux_old)
    ptot_sk = hyp(px_sk, pperp)
    gamma_sk = hyp(ptot_sk / (m * c), torch.ones_like(ptot_sk))
    pb_new = gamma_sf * (px_sk - gamma_sk * m * ux)
    ptot_new = hyp(pb_new, pperp)
    gamma_new = hyp(ptot_new / (m * c), torch.ones_like(ptot_new))
    return pb_new, gamma_new


def boost_x(ptot, px, gamma_rel, beta_rel, e0, c: float):
    """Boost a momentum (ptot, px) along -x by (gamma_rel, beta_rel)
    (thermo_calcs.jl:144-158, particle_counter.jl:563-575), with the
    reference's guard against |px'| > ptot'.  Returns (ptot', px')."""
    etot = torch.hypot(ptot * c, torch.full_like(ptot, e0))
    px_t = gamma_rel * (px - beta_rel * etot / c)
    pt_t = torch.sqrt(torch.clamp(ptot * ptot - px * px + px_t * px_t,
                                  min=0.0))
    px_t = torch.where(px_t.abs() > pt_t, torch.sign(px_t) * pt_t, px_t)
    return pt_t, px_t
