"""Lorentz frame transforms for particle momenta, on torch tensors.

Counterpart of the JAX package's ops/transforms.py: ``transform_p_ps``
(plasma -> shock frame, transformers.jl:440-476), used by the exit
bookkeeping and the oblique step; ``transform_p_psp`` (old plasma ->
shock -> new plasma frame on a zone change, transformers.jl:523-607),
the oblique step's frame re-transform; their parallel-field forms
``transform_p_ps_parallel`` and ``transform_p_psp_parallel``, used by
the XLA engine's step at theta_B = 0; and ``boost_x`` (the center-point
rebinning boost, thermo_calcs.jl:144-158), used by the reductions.
Elementwise, no control flow; every argument broadcasts.
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


class PlasmaMomentum(NamedTuple):
    ptot_pf: torch.Tensor
    pb_pf: torch.Tensor
    pperp_pf: torch.Tensor
    gamma_pf: torch.Tensor
    phi: torch.Tensor


def _to_parallel_perp(px, pz, ptot, b_cos, b_sin, floor=1.0e-6):
    """Split a momentum into its components parallel and perpendicular
    to B, guarding the cancellation ptot < |pb| as the reference clamps
    it (transformers.jl:562-568)."""
    pb = px * b_cos + pz * b_sin
    bad = ptot < pb.abs()
    pperp_bad = floor * ptot
    pb_bad = torch.sign(pb) * torch.sqrt(torch.clamp(
        ptot * ptot - pperp_bad * pperp_bad, min=0.0))
    pb = torch.where(bad, pb_bad, pb)
    pperp = torch.where(bad, pperp_bad,
                        torch.sqrt(torch.clamp(ptot * ptot - pb * pb,
                                               min=0.0)))
    return pb, pperp


def transform_p_psp(pb, pperp, gamma_pf, phi, ux_old, uz_old, utot_old,
                    gamma_sf_old, b_cos_old, b_sin_old, ux, uz, utot,
                    gamma_sf, b_cos, b_sin, m, c: float) -> PlasmaMomentum:
    """Old plasma -> shock -> new plasma frame on a zone change
    (transform_p_PSP, transformers.jl:523-607), boosting along the flow
    (ux, uz) of each frame."""
    px, py, pz = plasma_xyz(pb, pperp, phi, b_cos_old, b_sin_old)

    # old plasma -> shock
    ut2 = torch.clamp(utot_old * utot_old, min=1.0e-300)
    gm1 = gamma_sf_old - 1.0
    px_sk = ((gm1 * (ux_old * ux_old) / ut2 + 1.0) * px
             + gm1 * (ux_old * uz_old / ut2) * pz
             + gamma_sf_old * gamma_pf * m * ux_old)
    pz_sk = (gm1 * (ux_old * uz_old / ut2) * px
             + (gm1 * (uz_old * uz_old) / ut2 + 1.0) * pz
             + gamma_sf_old * gamma_pf * m * uz_old)
    py_sk = py
    ptot_sk = torch.sqrt(px_sk * px_sk + py_sk * py_sk + pz_sk * pz_sk)
    gamma_sk = hyp(ptot_sk / (m * c), torch.ones_like(ptot_sk))

    # shock -> new plasma
    ut2n = torch.clamp(utot * utot, min=1.0e-300)
    gm1n = gamma_sf - 1.0
    px_pf = ((gm1n * (ux * ux) / ut2n + 1.0) * px_sk
             + gm1n * (ux * uz / ut2n) * pz_sk
             - gamma_sf * gamma_sk * m * ux)
    pz_pf = (gm1n * (ux * uz / ut2n) * px_sk
             + (gm1n * (uz * uz) / ut2n + 1.0) * pz_sk
             - gamma_sf * gamma_sk * m * uz)
    py_pf = py_sk
    ptot_pf = torch.sqrt(px_pf * px_pf + py_pf * py_pf + pz_pf * pz_pf)

    pb_pf, pperp_pf = _to_parallel_perp(px_pf, pz_pf, ptot_pf, b_cos, b_sin)
    gamma_pf_new = hyp(ptot_pf / (m * c), torch.ones_like(ptot_pf))
    phi_p = torch.atan2(py_pf, -px_pf * b_sin + pz_pf * b_cos)
    return PlasmaMomentum(ptot_pf, pb_pf, pperp_pf, gamma_pf_new,
                          phi_p - math.pi / 2.0)


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
