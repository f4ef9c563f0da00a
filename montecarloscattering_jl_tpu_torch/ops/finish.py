"""Exit bookkeeping for finished lanes.

Counterpart of the JAX package's ops/finish.py (particle_finish!,
particle_finish.jl:46-107): after a segment drains, every FINISHED lane
is transformed to the shock frame once and scatter-added into the
escape PSDs and flux accumulators by its exit reason; SAVED lanes go on
to the next pcut.  Scatter-adds are ``index_put_(accumulate=True)`` in
float64.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..utils.constants import C_CGS
from ..utils.params import E_REL_PT, PF_SPIKE_AWAY
from ..models.psd_bins import psd_bin_angle, psd_bin_momentum
from .state import (FINISHED, R_DOWNSTREAM, R_UPSTREAM_PMAX,
                    ParticleState, SegmentGrids, SegmentScalars,
                    StepStatic)
from .transforms import transform_p_ps


@dataclass
class EscapeTallies:
    esc_psd_up: torch.Tensor      # [n_mom+1, n_theta+1] upstream/pmax
    esc_psd_dw: torch.Tensor      # [n_mom+1, n_theta+1] downstream
    esc_flux: torch.Tensor        # escaped weight (reason 2)
    px_esc_feb: torch.Tensor
    energy_esc_feb: torch.Tensor
    esc_energy_eff: torch.Tensor  # [n_mom+1]
    esc_num_eff: torch.Tensor     # [n_mom+1]

    @staticmethod
    def zeros(n_mom: int, n_theta: int, device) -> "EscapeTallies":
        z = lambda *s: torch.zeros(s, dtype=torch.float64, device=device)
        return EscapeTallies(
            esc_psd_up=z(n_mom + 1, n_theta + 1),
            esc_psd_dw=z(n_mom + 1, n_theta + 1),
            esc_flux=z(), px_esc_feb=z(), energy_esc_feb=z(),
            esc_energy_eff=z(n_mom + 1), esc_num_eff=z(n_mom + 1))

    def to_numpy(self) -> "EscapeTallies":
        return EscapeTallies(**{
            f.name: getattr(self, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(self)})


def finish_particles(state: ParticleState, acc: EscapeTallies,
                     grids: SegmentGrids, sc: SegmentScalars,
                     ss: StepStatic, m: torch.Tensor | None = None,
                     live: torch.Tensor | None = None) -> EscapeTallies:
    """Accumulate exit tallies for all FINISHED lanes of a segment into
    `acc` (in place; returned for chaining).  `m`: the species' mass as
    a 0-dim tensor of the momentum dtype on the state's device, where
    the caller has it there already (else made from ``sc.m``, a
    host-to-device copy).  `live`: a 0-dim tensor on the device, 0 for a
    segment the pcut ladder queued after its chain died, whose lanes all
    have zero weight (engine/run.py): they add zeros, and their cells
    are spread over the histogram, because the accumulating
    ``index_put_`` on a CUDA device walks a run of one cell one entry
    at a time (a live segment's cells, and so its sums, stay as they
    are)."""
    c = C_CGS
    if m is None:
        m = torch.tensor(sc.m, dtype=state.pb.dtype, device=state.device)
    e0 = m * c * c

    fin = (state.status == FINISHED) & (state.weight > 0.0)
    w = torch.where(fin, state.weight, 0.0)

    ig = state.igrid.long()
    ptot = torch.hypot(state.pb, state.pperp)
    sk = transform_p_ps(
        state.pb, state.pperp,
        torch.hypot(ptot / (m * c), torch.ones_like(ptot)),
        state.phi, grids.ux[ig], grids.uz[ig], grids.utot[ig],
        grids.gamma_sf[ig], grids.b_cos[ig], grids.b_sin[ig], m, c)

    ip = psd_bin_momentum(sk.ptot_sk, ss.psd_mom_min, ss.bins_per_dec_mom,
                          ss.n_mom).long()
    jt = psd_bin_angle(sk.px_sk, sk.ptot_sk, ss.cos_fine, ss.dcos,
                       ss.theta_min, ss.bins_per_dec_theta,
                       ss.n_theta).long()
    if live is not None:
        lane = torch.arange(ip.shape[0], device=ip.device)
        ip = torch.where(live > 0, ip, lane % (ss.n_mom + 1))
        jt = torch.where(live > 0, jt,
                         lane // (ss.n_mom + 1) % (ss.n_theta + 1))

    # 1/|v_x| weighting with the spike clamp (particle_finish.jl:74-78)
    spike = sk.ptot_sk > (PF_SPIKE_AWAY * sk.px_sk).abs()
    wf = torch.where(
        spike,
        sk.gamma_sk * m * PF_SPIKE_AWAY
        / torch.clamp(sk.ptot_sk, min=1.0e-300),
        sk.gamma_sk * m / torch.clamp(sk.px_sk.abs(), min=1.0e-300))

    rel = (sk.gamma_sk - 1.0) >= E_REL_PT
    e_kin = torch.where(rel, (sk.gamma_sk - 1.0) * e0,
                        sk.ptot_sk * sk.ptot_sk / (2.0 * m))

    is_dw = fin & (state.reason == R_DOWNSTREAM)
    is_up = fin & (state.reason == R_UPSTREAM_PMAX)

    wwf = (w * wf).double()
    we = (w * e_kin).double()
    wd = w.double()
    zero = torch.zeros((), dtype=torch.float64, device=state.device)

    acc.esc_psd_dw.index_put_((ip, jt), torch.where(is_dw, wwf, zero),
                              accumulate=True)
    acc.esc_psd_up.index_put_((ip, jt), torch.where(is_up, wwf, zero),
                              accumulate=True)
    acc.esc_flux += torch.where(is_up, wd, zero).sum()
    acc.px_esc_feb += torch.where(is_up, sk.px_sk.abs().double() * wd,
                                  zero).sum()
    acc.energy_esc_feb += torch.where(is_up, we, zero).sum()
    acc.esc_energy_eff.index_put_((ip,), torch.where(is_up, we, zero),
                                  accumulate=True)
    acc.esc_num_eff.index_put_((ip,), torch.where(is_up, wd, zero),
                               accumulate=True)
    return acc
