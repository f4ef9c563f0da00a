"""The XLA engine's transport step and drain, in plain PyTorch.

Counterpart of the JAX package's ops/step.py: ``helix_step`` (step.py:
198-684, with ``_downstream_logic``, :902-1003, and ``_retro_step``,
:1006-1091) advances every lane of a ParticleState by one helix step as
masked lane-parallel updates, and ``run_segment`` (:724-785) repeats it
until no lane is ACTIVE, on a window of the lanes that halves as they
end (the live-lane compaction ladder, :724-850).  This is the engine of
every config K1 does not run (engine/run.py): float64 momenta -- the
CLI's default -- x_spec detectors and oblique fields.  The JAX package
left this step to XLA; on a CUDA card a segment runs it as K5
(ops/helix.py, csrc/helix_step.cu), one persistent launch a segment,
and ``helix_step`` / ``_block`` here are K5's plain version: its spec,
the CPU path, and the oblique step on the card (not in K5; its PSD
deposit launches K2, ops/hist.py, once a step).

Branches: the parallel-field step (theta_B = 0, the only geometry the
config admits) and the oblique one (``StepStatic.parallel`` False: the
general frame transforms, the gyro-phase adjustment of the scattering
and the gyro excursion of the movement, step.py:256-265, 284-290, 351,
420-425, 452-460, 484-496 and 1023-1041), with every static flag of the
reference: the x_spec
detector spectra (:612-637), the custom eps_B far-field decay (:228-235,
:937-940), the no-scatter escape (:277-281), radiative losses
(:309-322), the custom f(r_g) mean-free-path law's per-lane cos_max
(:333-345), tcut firing with the coupled tallies (:370-387), the no-DSA
reflection (:434-435), the ion -> electron energy transfer (:568-600),
and the PRP return, analytic (:965-982) or by the retro walk (:956-963
and ``_retro_step``).

What differs from the JAX engine, on purpose:

* Tallies are deposited every step, straight into the difference
  arrays -- (cell, lo, hi, w) to K2, the flux channels, detector
  spectra, pool and tcut tallies by one float64 ``index_add_`` -- with
  no chunked record buffer and no flush.  Sums run in another order.
* The zone gather is an index gather and the zone lookup a
  ``searchsorted``; the JAX step's one-hot contraction and
  compare-and-sum give the same values exactly.
* The compaction ladder halves the window only at the block loop's host
  check every SYNC_EVERY steps, not at every step; a lane that is not
  ACTIVE does not step, so the lanes come out the same either way.
* On a CUDA device a segment of the parallel-field step is one K5
  drain (no host check, no ladder); a block of the oblique step
  replays a CUDA graph of the plain step, captured once per window
  size and set of tensors (``GraphCache``).

Arithmetic follows the reference in the momentum dtype of the state:
float32 uniforms and the float32 scattering and return phases, float64
positions, PRP and acceleration time.  Scalars that divide or are
divided by a tensor are 0-dim tensors on the device (torch turns
``t / python_scalar`` into a reciprocal multiply on CUDA).
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..models.psd_bins import psd_bin_angle, psd_bin_momentum
from ..utils.constants import C_CGS, RAD_LOSS_FAC
from ..utils.params import ALL_FLUX_SPIKE_AWAY, E_REL_PT, MAX_HELIX_STEPS
from . import helix, hist, rng
from .mega import floor_mod
from .scattering import gyro_period, radiation_loss, scattering
from .state import (ACTIVE, C_RAD, C_RECV, C_RETRO, FINISHED, FL_DW, FL_INJ,
                    FL_JRET, FL_RETRO, R_AGE, R_DOWNSTREAM, R_RADIATED,
                    R_UPSTREAM_PMAX, SAVED, X_DTYPE, ParticleState,
                    SegmentGrids, SegmentScalars, StepStatic, Tallies,
                    upload)
from .transforms import (hyp, transform_p_ps, transform_p_ps_parallel,
                         transform_p_psp, transform_p_psp_parallel)

SYNC_EVERY = 64    # steps between the block loop's checks for ACTIVE lanes

# uniform slots (step.py:66-74); the retro walk's large-angle scatter
# reuses the scattering slots (retro lanes do not scatter)
_U_SCAT1, _U_SCAT2, _U_PRET, _U_RET_MU, _U_RET_PHI = 0, 1, 2, 3, 4
_U_RETRO_PHI, _U_RETRO_MU = 0, 1
_U_REFL_INJ = (5, 6)
_U_REFL_PHI = (7, 3)
_N_REFLECT_TRIES = 2
_XN_RETRO = 10.0   # steps per gyro period of the retro walk

# the tallies one index_add_ of a step deposits into, in buffer order
_DEPOSIT_TARGETS = ("flux_diff", "spectra_sf", "spectra_pf", "pool_diff",
                    "weight_coupled", "spectra_coupled", "counts")


@dataclass
class StepTables:
    """Device inputs of one segment for ``helix_step``."""

    x_grid: torch.Tensor      # [nb] f64 boundaries
    ux: torch.Tensor          # [nb] zone fields, momentum dtype
    gamma_sf: torch.Tensor
    gamma_ef: torch.Tensor
    btot: torch.Tensor
    uz: torch.Tensor          # the oblique step's: flow z, |u|, field angle
    utot: torch.Tensor
    b_cos: torch.Tensor
    b_sin: torch.Tensor
    x_spec: torch.Tensor      # [n_xspec] f64 detector positions
    tcuts: torch.Tensor       # [n_tcut_slots] f64, padded with +inf
    eps_target: torch.Tensor  # [nb] momentum dtype
    recv_prefix: torch.Tensor  # [nb+1] f64
    k: dict                   # 0-dim tensors (momentum dtype or f64)
    ss: StepStatic
    reflect: bool             # inj_frac < 1 or no-DSA: the shock reflects
    age_cut: bool             # age_max > 0
    feb_dw_on: bool           # feb_dw > 0

    def static(self) -> tuple:
        """What a captured step bakes in besides the tensors' addresses."""
        return (self.ss, self.reflect, self.age_cut, self.feb_dw_on)

    def tensors(self) -> list:
        return ([getattr(self, f) for f in self._TENSORS]
                + [self.k[n] for n in sorted(self.k)])

    _TENSORS = ("x_grid", "ux", "gamma_sf", "gamma_ef", "btot", "uz",
                "utot", "b_cos", "b_sin", "x_spec", "tcuts", "eps_target",
                "recv_prefix")

    def clone(self) -> "StepTables":
        """These tables in tensors of their own (a table built on the
        CPU may share memory with the host arrays it came from)."""
        return dataclasses.replace(
            self, k={n: v.clone() for n, v in self.k.items()},
            **{f: getattr(self, f).clone() for f in self._TENSORS})

    def load(self, other: "StepTables") -> "StepTables":
        """Copy `other`'s values into these tensors, in place (a captured
        step reads them at their addresses); returns self."""
        if other.static() != self.static():
            raise ValueError("tables of another static configuration")
        for a, b in zip(self.tensors(), other.tensors()):
            a.copy_(b)
        return self


# the scalars of StepTables.k that come from the host, in the momentum
# dtype (_P_NAMES) and in float64 (_D_NAMES): their float64 values are
# copied to the device and rounded there, as torch.tensor rounds them
_P_NAMES = ("m", "abs_charge", "bmag2", "pcut", "pcut_prev", "pmax", "u2",
            "g0u0", "pe_crit", "gamma_e_crit", "inj_frac", "b_cmbz", "one",
            "three", "ten", "c", "two_pi", "spike", "tiny", "tiny30",
            "cmax_coarse", "cmax_fine", "xn_coarse", "xn_fine", "eta",
            "twelve_pi", "frg_rg0", "frg_am1")
_D_NAMES = ("feb_up", "feb_dw", "x_stop", "age_max")


def _host_scalars(sc: SegmentScalars, ss: StepStatic) -> list:
    """The _P_NAMES then _D_NAMES values of one segment, as floats."""
    p = dict(
        m=sc.m, abs_charge=sc.abs_charge, bmag2=sc.bmag2, pcut=sc.pcut,
        pcut_prev=sc.pcut_prev, pmax=sc.pmax_cutoff, u2=sc.u2,
        g0u0=sc.gamma0_u0, pe_crit=sc.pe_crit,
        gamma_e_crit=sc.gamma_e_crit, inj_frac=sc.inj_frac,
        b_cmbz=sc.b_cmbz, one=1.0, three=3.0, ten=_XN_RETRO, c=C_CGS,
        two_pi=2.0 * math.pi, spike=ALL_FLUX_SPIKE_AWAY, tiny=1.0e-300,
        tiny30=1.0e-30,
        cmax_coarse=math.cos(math.sqrt(
            12.0 * math.pi / (ss.xn_per_coarse * ss.eta_mfp))),
        cmax_fine=math.cos(math.sqrt(
            12.0 * math.pi / (ss.xn_per_fine * ss.eta_mfp))),
        xn_coarse=ss.xn_per_coarse, xn_fine=ss.xn_per_fine,
        eta=ss.eta_mfp, twelve_pi=12.0 * math.pi, frg_rg0=ss.frg_rg0_cm,
        frg_am1=ss.frg_alpha - 1.0)
    d = dict(feb_up=sc.feb_up, feb_dw=sc.feb_dw, x_stop=sc.x_grid_stop,
             age_max=sc.age_max)
    return [float(p[n]) for n in _P_NAMES] + [float(d[n]) for n in _D_NAMES]


def step_tables(grids: SegmentGrids, sc: SegmentScalars, ss: StepStatic,
                device) -> StepTables:
    """The segment's grids on `device` and its scalars as 0-dim tensors
    in the grids' momentum dtype (positions and times in float64)."""
    return ladder_tables(grids, [sc], ss, device)(0)[0]


def ladder_tables(grids: SegmentGrids, scs: list, ss: StepStatic, device,
                  packed: bool = False):
    """``step_tables`` of every segment of a species' ladder (`scs`, one
    SegmentScalars a segment) with one host-to-device copy for all of
    them: each scalar of a segment is an element of one [n_seg] vector.
    Returns ``table(i)``: segment i's StepTables and, with `packed`, its
    K5 packing (helix.Packed, its scalar vector a row of one [n_seg,
    len(helix.KV_NAMES)] table, whose statics ride the same copy), else
    None; each made when asked (a chain that dies early uses few)."""
    dev = torch.device(device)
    pdt = grids.ux.dtype
    nb = ss.nb
    f = lambda a: a[:nb].to(dev, pdt).contiguous()
    ux, gsf, gef, btot = (f(grids.ux), f(grids.gamma_sf),
                          f(grids.gamma_ef), f(grids.btot))
    bcos, bsin = f(grids.b_cos), f(grids.b_sin)
    tabs = dict(
        x_grid=grids.x_grid[:nb].to(dev, X_DTYPE).contiguous(),
        ux=ux, gamma_sf=gsf, gamma_ef=gef, btot=btot, uz=f(grids.uz),
        utot=f(grids.utot), b_cos=bcos, b_sin=bsin,
        x_spec=grids.x_spec[:ss.n_xspec].to(dev, X_DTYPE).contiguous(),
        tcuts=grids.tcuts.to(dev, X_DTYPE).contiguous(),
        eps_target=f(grids.eps_target),
        recv_prefix=grids.recv_prefix[:nb + 1].to(
            dev, X_DTYPE).contiguous())
    sc0 = scs[0]
    flags = dict(reflect=sc0.inj_frac < 1.0 or ss.dont_dsa,
                 age_cut=sc0.age_max > 0, feb_dw_on=sc0.feb_dw > 0.0)
    host = [np.array([_host_scalars(sc, ss) for sc in scs])]
    if packed:
        word = helix.flag_word_of(ss, **flags)
        host += list(helix.pack_statics(ss, pdt, tabs["tcuts"].shape[0],
                                        word))
    up = upload(host, dev)
    raw = up[0]
    n_p = len(_P_NAMES)
    v = {n: raw[:, j].to(pdt) for j, n in enumerate(_P_NAMES)}
    v.update({n: raw[:, n_p + j] for j, n in enumerate(_D_NAMES)})
    v["mc"] = v["m"] * C_CGS
    v["e0"] = v["mc"] * C_CGS
    v["two_m"] = 2.0 * v["m"]
    v["qb2"] = v["abs_charge"] * v.pop("bmag2")
    # the downstream-most zone, where the retro walk runs
    zone = dict(ux_dw=ux[nb - 2], gsf_dw=gsf[nb - 2], gef_dw=gef[nb - 2],
                b_dw=btot[nb - 2], bcos_dw=bcos[nb - 2],
                bsin_dw=bsin[nb - 2])
    kv = helix.kv_rows({**v, **zone}, up[1], len(scs)) if packed else None

    def table(i):
        tb = StepTables(k={**{n: a[i] for n, a in v.items()}, **zone},
                        ss=ss, **tabs, **flags)
        if not packed:
            return tb, None
        return tb, helix.Packed(
            tb=tb, kv=kv[i], ki=up[2], word=word,
            instance=helix.instance_of(pdt == torch.float64, word),
            p_dtype=pdt)
    return table


def _zone(x_grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Index of the last boundary <= x (-1 below the grid): the JAX
    step's sum(x >= x_grid) - 1, exactly."""
    return torch.searchsorted(x_grid, x.contiguous(), right=True) - 1


def _custom_eps_b_decay(x: torch.Tensor, k: dict, pdt) -> torch.Tensor:
    """sqrt(x_stop / max(x, x_stop)) in the momentum dtype: the
    Blandford-McKee field decay beyond the grid end
    (particle_loop.jl:206-209)."""
    return torch.sqrt(k["x_stop"] / torch.maximum(x, k["x_stop"])).to(pdt)


def helix_step(st: ParticleState, tl: Tallies, tb: StepTables,
               u: torch.Tensor, max_helix: int) -> None:
    """Advance every ACTIVE lane of `st` by one helix (or retro) step, in
    place, and deposit its tallies into `tl` in place.  `u` [8, B] holds
    the lanes' float32 uniforms of this step (rng.lane_uniforms_xla at
    the lanes' step counts)."""
    ss, k = tb.ss, tb.k
    m, mc, e0, u2 = k["m"], k["mc"], k["e0"], k["u2"]
    one, tiny = k["one"], k["tiny"]
    c = C_CGS
    eta3 = ss.eta_mfp / 3.0
    nb, nz = ss.nb, ss.nb + 1
    pdt = st.pb.dtype
    f64 = X_DTYPE
    deps = {}       # tally name -> [(flat index, value, on)]

    def dep(name, idx, val, on):
        deps.setdefault(name, []).append((idx.reshape(-1).long(),
                                          val.reshape(-1).to(f64),
                                          on.reshape(-1)))

    status, reason, flags = st.status, st.reason, st.flags
    weight, x_old = st.weight, st.x
    act = status == ACTIVE
    retro_old = (flags & FL_RETRO) != 0
    dw_old = (flags & FL_DW) != 0
    inj_old = (flags & FL_INJ) != 0
    norm = act & ~retro_old
    do_b3 = norm & ((flags & FL_JRET) == 0)

    # ---- zone fields (an exact index gather) -----------------------------
    ig = st.igrid.long()
    ux, gsf = tb.ux[ig], tb.gamma_sf[ig]
    gef, bmag = tb.gamma_ef[ig], tb.btot[ig]
    if not ss.parallel:
        uz, utot = tb.uz[ig], tb.utot[ig]
        bcos, bsin = tb.b_cos[ig], tb.b_sin[ig]
    if ss.use_custom_eps_b:
        # Blandford-McKee decay beyond the grid end
        bmag = torch.where(x_old > k["x_stop"],
                           k["b_dw"] * _custom_eps_b_decay(x_old, k, pdt),
                           bmag)
    gyro_denom = torch.div(one, k["abs_charge"] * bmag)

    pb, pperp, phi = st.pb, st.pperp, st.phi
    ptot = hyp(pb, pperp)
    gamma_pf = hyp(ptot / mc, one)

    # ---- Code Block 3: frame re-transform, escapes, scattering ----------
    changed = do_b3 & (ux != st.ux_prev)
    beta_old = st.ux_prev / k["c"]
    gsf_old = torch.div(one, torch.sqrt(torch.maximum(
        1.0 - beta_old * beta_old, k["tiny30"])))
    if ss.parallel:
        pb_tr, _ = transform_p_psp_parallel(pb, pperp, gamma_pf, st.ux_prev,
                                            gsf_old, ux, gsf, m, c)
        pb = torch.where(changed, pb_tr, pb)
    else:
        # the previous zone's frame: flow ux_prev along x, field along x
        tr = transform_p_psp(
            pb, pperp, gamma_pf, phi, st.ux_prev, torch.zeros_like(uz),
            st.ux_prev.abs(), gsf_old, torch.ones_like(bcos),
            torch.zeros_like(bsin), ux, uz, utot, gsf, bcos, bsin, m, c)
        pb = torch.where(changed, tr.pb_pf, pb)
        pperp = torch.where(changed, tr.pperp_pf, pperp)
        phi = torch.where(changed, tr.phi, phi)
    ptot = hyp(pb, pperp)
    gamma_pf = hyp(ptot / mc, one)
    ux_prev = torch.where(do_b3, ux, st.ux_prev)

    if ss.dont_scatter:
        # downstream escape with scattering off (particle_loop.jl:252-259)
        esc_ns = do_b3 & (x_old > 10.0 * (pperp * c * gyro_denom))
        status = torch.where(esc_ns, FINISHED, status)
        reason = torch.where(esc_ns, R_DOWNSTREAM, reason)
        do_b3 = do_b3 & ~esc_ns

    if ss.parallel:
        ptot_sk0, _, _ = transform_p_ps_parallel(pb, pperp, gamma_pf, ux,
                                                 gsf, m, c)
    else:
        ptot_sk0 = transform_p_ps(pb, pperp, gamma_pf, phi, ux, uz, utot,
                                  gsf, bcos, bsin, m, c).ptot_sk
    esc_pmax = do_b3 & (ptot > k["pmax"]) & (ptot_sk0 > k["pmax"])
    esc_feb = do_b3 & ~esc_pmax & inj_old & (x_old < k["feb_up"])
    esc_up = esc_pmax | esc_feb
    status = torch.where(esc_up, FINISHED, status)
    reason = torch.where(esc_up, R_UPSTREAM_PMAX, reason)
    do_b3 = do_b3 & ~esc_up
    if tb.age_cut:
        esc_age = do_b3 & (st.acctime > k["age_max"])
        status = torch.where(esc_age, FINISHED, status)
        reason = torch.where(esc_age, R_AGE, reason)
        do_b3 = do_b3 & ~esc_age

    if ss.do_rad_losses and ss.is_electron:
        # synchrotron + inverse-Compton losses (particle_loop.jl:301-334)
        b_cmb = k["b_cmbz"] * gef
        p_lost = radiation_loss(bmag * bmag + b_cmb * b_cmb, ptot,
                                st.t_step, RAD_LOSS_FAC)
        dead = do_b3 & (p_lost <= 0.0)
        scale = torch.where(do_b3, p_lost / torch.maximum(ptot, tiny), one)
        pb = pb * scale
        pperp = pperp * scale
        ptot = hyp(pb, pperp)
        gamma_in, gamma_pf = gamma_pf, hyp(ptot / mc, one)
        dep("counts", torch.full_like(status, C_RAD),
            (gamma_in - gamma_pf) * e0 * weight, do_b3)
        status = torch.where(dead, FINISHED, status)
        reason = torch.where(dead, R_RADIATED, reason)
        do_b3 = do_b3 & ~dead

    if ss.dont_scatter:
        period = gyro_period(ptot, gamma_pf, gyro_denom, ss.is_electron,
                             k["pe_crit"], k["gamma_e_crit"], mc)
    else:
        cos_max = torch.where(st.xn_per == k["xn_coarse"],
                              k["cmax_coarse"], k["cmax_fine"])
        if ss.frg_rg0_cm > 0.0:
            # custom MFP law lambda = eta*r_g*(r_g/r_ref)^(alpha-1): only
            # the f(r_g) factor enters cos_max (scattering.jl:46-60)
            p_scat = (torch.where(ptot < k["pe_crit"], k["pe_crit"], ptot)
                      if ss.is_electron else ptot)
            f_frg = torch.pow(p_scat * c * gyro_denom / k["frg_rg0"],
                              k["frg_am1"])
            cos_max = torch.cos(torch.sqrt(
                k["twelve_pi"] / (st.xn_per * k["eta"]
                                  * torch.maximum(f_frg, k["tiny30"]))))
        res = scattering(u[_U_SCAT1], u[_U_SCAT2], pb, pperp, ptot,
                         gamma_pf, gyro_denom, ss.is_electron,
                         k["pe_crit"], k["gamma_e_crit"], mc, cos_max,
                         phi=phi, phase_adjust=not ss.parallel)
        pb = torch.where(do_b3, res.pb, pb)
        pperp = torch.where(do_b3, res.pperp, pperp)
        phi = torch.where(do_b3, res.phi, phi)
        period = res.gyro_period

    # acceleration time, tcuts and pcut save-out, downstream lanes only
    adding = do_b3 & dw_old
    acct = st.acctime + torch.where(adding, (st.t_step * gef).to(f64), 0.0)
    tcut = st.tcut
    n_slots = tb.tcuts.shape[0]
    if ss.do_tcuts:
        # tcut_track! (cuts.jl:149-162): the weight crossing each tcut,
        # and its plasma-frame momentum spectrum
        slot = tcut.clamp(0, n_slots - 1).long()
        fire = adding & (tcut < n_slots) & (acct >= tb.tcuts[slot])
        ip_pf = psd_bin_momentum(ptot, ss.psd_mom_min, ss.bins_per_dec_mom,
                                 ss.n_mom).long()
        dep("weight_coupled", slot, weight, fire)
        dep("spectra_coupled", ip_pf * n_slots + slot, weight, fire)
        tcut = torch.where(fire, tcut + 1, tcut)
    save = adding & (ptot > k["pcut"])
    status = torch.where(save, SAVED, status)
    prp_x = torch.where(save & (x_old >= st.prp_x), x_old * 1.1, st.prp_x)

    r_g_tot = ptot * c * gyro_denom
    xn_per = torch.where(norm & (status == ACTIVE),
                         torch.where(x_old > r_g_tot, k["xn_coarse"],
                                     k["xn_fine"]), st.xn_per)

    # ---- Code Block 2: movement -------------------------------------------
    moving = (status == ACTIVE) & ~retro_old
    t_step = period / xn_per
    m_gpf = gamma_pf * m
    dphi = torch.div(k["two_pi"], xn_per)

    if not ss.parallel:
        # the gyro excursion across the oblique field
        phi_old = phi
        r_g_perp = pperp * c * gyro_denom

    def move(pb_m, phi_m):
        phi_try = floor_mod(phi_m + dphi, k["two_pi"])
        if ss.parallel:
            dx = gsf * (pb_m * t_step / m_gpf + ux * t_step)
        else:
            dx = gsf * (pb_m * t_step / m_gpf * bcos
                        - r_g_perp * bsin
                        * (torch.cos(phi_try) - torch.cos(phi_old))
                        + ux * t_step)
        return phi_try, x_old + dx.to(f64)

    pb_m, phi_m = pb, phi
    if tb.reflect:
        # reflection at the shock when DSA is off or the injection test
        # fails (no_DSA_loop, particle_loop.jl:510-571)
        done = ~moving
        x_new, phi_fin = x_old, phi
        for kk in range(_N_REFLECT_TRIES):
            phi_try, x_try = move(pb_m, phi_m)
            cross_up = (x_try <= 0.0) & (x_old > 0.0) & ~inj_old
            fail = (cross_up if ss.dont_dsa else
                    cross_up & (u[_U_REFL_INJ[kk]].to(pdt) > k["inj_frac"]))
            refl = ~done & fail
            accept = ~done & ~refl
            x_new = torch.where(accept, x_try, x_new)
            phi_fin = torch.where(accept, phi_try, phi_fin)
            done = done | accept
            neg = pb_m < 0.0
            pb_m = torch.where(refl & neg, -pb_m, pb_m)
            phi_m = torch.where(refl & ~neg,
                                (u[_U_REFL_PHI[kk]] * 2.0 * math.pi).to(pdt),
                                phi_m)
        phi_try, x_try = move(pb_m, phi_m)
        x_new = torch.where(done, x_new, x_try)
        phi_fin = torch.where(done, phi_fin, phi_try)
    else:
        # every move is accepted at the first try
        phi_fin, x_try = move(pb_m, phi_m)
        x_new = torch.where(moving, x_try, x_old)
    pb = torch.where(moving, pb_m, pb)
    phi = torch.where(moving, phi_fin, phi)

    first_dw = moving & (x_old < 0.0) & (x_new >= 0.0)
    downstream = dw_old | first_dw
    l_diff0 = (eta3 * r_g_tot * ptot / (m * gamma_pf * u2)).to(f64)
    prp_x = torch.where(first_dw, torch.maximum(prp_x, l_diff0), prp_x)
    inj = inj_old | (moving & downstream & (x_new < 0.0))

    # ---- tallies and the new zone (all_flux.jl:45-259) --------------------
    ig_new = _zone(tb.x_grid, x_new).clamp(0, nb - 2)
    ig_new = torch.where(moving, ig_new, ig)

    if ss.parallel:
        pt_sk, px_sk, g_sk = transform_p_ps_parallel(pb, pperp, gamma_pf,
                                                     ux, gsf, m, c)
        pz_sk = -pperp * torch.sin(phi)
    else:
        pt_sk, px_sk, _, pz_sk, g_sk = transform_p_ps(
            pb, pperp, gamma_pf, phi, ux, uz, utot, gsf, bcos, bsin, m, c)
    spike = pt_sk > px_sk.abs() * ALL_FLUX_SPIKE_AWAY
    px_safe = torch.where(px_sk == 0.0, tiny, px_sk)
    abs_inv_vx = torch.where(spike, torch.div(k["spike"], ux).abs(),
                             (g_sk * m / px_safe).abs())
    rel = (g_sk - 1.0) > E_REL_PT
    e_add = torch.where(rel, (g_sk - 1.0) * e0 * weight,
                        torch.div(pt_sk * pt_sk, k["two_m"]) * weight)

    moved_down = x_new > x_old
    lo = torch.where(moved_down, ig + 1, ig_new + 1)
    hi = torch.where(moved_down, ig_new, ig)
    lo = torch.where(~moved_down & inj,
                     torch.clamp(lo, min=ss.i_grid_feb + 1), lo)
    crossed = moving & (hi >= lo)
    lo_c = lo.clamp(0, nb - 1)
    hi_c = hi.clamp(0, nb - 1)

    g0u0 = k["g0u0"]
    sign = torch.where(moved_down, one, -one)
    on = crossed.to(pdt)
    vals = torch.stack([sign * px_sk * weight * g0u0 * on,
                        pz_sk.abs() * weight * g0u0 * on,
                        sign * e_add * g0u0 * on,
                        (crossed & ~inj).to(pdt)])
    ch = (torch.arange(4, device=vals.device) * nz)[:, None]
    on4 = crossed.expand(4, -1)
    dep("flux_diff", ch + lo_c, vals, on4)
    dep("flux_diff", ch + hi_c + 1, -vals, on4)

    ip_sk = psd_bin_momentum(pt_sk, ss.psd_mom_min, ss.bins_per_dec_mom,
                             ss.n_mom)
    jt_sk = psd_bin_angle(px_sk, pt_sk, ss.cos_fine, ss.dcos, ss.theta_min,
                          ss.bins_per_dec_theta, ss.n_theta)
    # K2 reads the step's own tensors (int64 zones, weights in the
    # momentum dtype, which it rounds to float32): no casts here
    psd_w = weight * abs_inv_vx * on
    cell = (ip_sk * 2 + (~inj).to(torch.int32)) * (ss.n_theta + 1) + jt_sk
    hist.psd_scatter(tl.psd_diff, cell, lo_c, hi_c, psd_w)

    if ss.do_energy_transfer:
        # ion -> electron energy transfer on upstream pre-injection zone
        # crossings (particle_loop.jl:652-723): ions donate into the pool
        # by the eps_target schedule, electrons take the pooled energy of
        # the crossed range
        hi_t = torch.clamp(hi_c, max=ss.i_shock)
        xfer = (crossed & ~inj & (x_old <= 0.0) & (hi_t >= lo_c)
                & (status == ACTIVE))
        gamma_now = hyp(hyp(pb, pperp) / mc, one)
        if not ss.is_electron:
            eps_stop = tb.eps_target[hi_t.clamp(0, nb - 1)]
            eps_start = tb.eps_target[ig]
            g_f = 1.0 + (gamma_now - 1.0) * (1.0 - eps_stop) \
                / torch.maximum(1.0 - eps_start, k["tiny30"])
            donate = xfer & (eps_stop > 0.0)
            g_f = torch.where(donate, torch.clamp(g_f, min=1.0), gamma_now)
            n_range = (hi_t - lo_c + 1).to(pdt)
            inc = (gamma_now - g_f) * e0 * weight / torch.clamp(n_range,
                                                                min=1.0)
            dep("pool_diff", lo_c.clamp(0, nb), inc, donate)
            dep("pool_diff", (hi_t + 1).clamp(0, nb), -inc, donate)
        else:
            gain = (tb.recv_prefix[(hi_t + 1).clamp(0, nb)]
                    - tb.recv_prefix[lo_c.clamp(0, nb)]).to(pdt) \
                * ss.electron_weight_fac
            takes = xfer & (gain > 0.0)
            g_f = torch.where(takes, gamma_now + gain / e0, gamma_now)
            dep("counts", torch.full_like(lo_c, C_RECV),
                (g_f - gamma_now) * e0 * weight, takes)
        scale = torch.sqrt(torch.clamp(g_f * g_f - 1.0, min=0.0)) \
            / torch.maximum(torch.sqrt(torch.clamp(
                gamma_now * gamma_now - 1.0, min=0.0)), k["tiny30"])
        scale = torch.where(xfer & (g_f != gamma_now), scale, one)
        pb = pb * scale
        pperp = pperp * scale

    # escaping flux at the upstream FEB (all_flux.jl:153-159)
    esc_cross = (moving & inj & (x_new < k["feb_up"])
                 & (x_old >= k["feb_up"]))
    px_up = torch.where(esc_cross, px_sk * weight * g0u0, 0.0).to(f64).sum()
    en_up = torch.where(esc_cross, e_add * g0u0, 0.0).to(f64).sum()

    # x_spec detector spectra (calculate_x_spec_spectra!,
    # all_flux.jl:164-190)
    if ss.n_xspec > 0:
        ip_pf = psd_bin_momentum(ptot, ss.psd_mom_min, ss.bins_per_dec_mom,
                                 ss.n_mom)
        pt_o_px_sk = torch.where(spike, k["spike"], pt_sk / px_safe)
        pt_o_px_pf = torch.minimum(
            (ptot / torch.where(pb == 0.0, tiny, pb)).abs(), k["spike"])
        f_weight = (pb / px_safe).abs() * g_sk / gamma_pf
        xs = tb.x_spec[:, None]
        hit = moving & (((x_old < xs) & (x_new >= xs))
                        | ((x_new <= xs) & (x_old > xs)))      # [nx, B]
        det = torch.arange(ss.n_xspec, device=hit.device)[:, None]
        nx = tl.spectra_sf.shape[1]
        dep("spectra_sf", ip_sk.long() * nx + det,
            (weight * pt_o_px_sk).expand_as(hit), hit)
        dep("spectra_pf", ip_pf.long() * nx + det,
            (weight * pt_o_px_pf * f_weight).expand_as(hit), hit)

    # ---- downstream escape / return (particle_loop.jl:453-495) -----------
    if ss.is_electron:
        v_fac = torch.where(
            ptot < k["pe_crit"],
            (k["pe_crit"] * c * gyro_denom) * k["pe_crit"]
            / (m * k["gamma_e_crit"] * u2),
            (ptot * c * gyro_denom) * ptot / (m * gamma_pf * u2))
    else:
        v_fac = (ptot * c * gyro_denom) * ptot / (m * gamma_pf * u2)
    l_diff = (eta3 * v_fac).to(f64)
    if tb.feb_dw_on:
        esc_feb_dw = moving & (x_new > k["feb_dw"])
    else:
        esc_feb_dw = torch.zeros_like(moving)
    esc_far = (moving & ~esc_feb_dw & (x_new > 1.1 * prp_x)
               & (x_new > 6.91 * l_diff))
    do_ret = moving & ~esc_feb_dw & ~esc_far
    past_end = do_ret & (x_new >= k["x_stop"])
    just_end = past_end & (x_old < k["x_stop"])
    # PRP three diffusion lengths on, in the downstream field
    # (prob_return.jl:59-85)
    r_g2 = ptot * c
    if ss.use_custom_eps_b:
        r_g2 = r_g2 * _custom_eps_b_decay(x_new, k, pdt)
    r_g2 = torch.div(r_g2, k["qb2"])
    l_diff2 = (eta3 * r_g2 * ptot / (m * gamma_pf * u2)).to(f64)
    prp_x = torch.where(just_end, x_new + 3.0 * l_diff2, prp_x)

    crossed_prp = past_end & ~just_end & (x_old < prp_x) & (x_new >= prp_x)
    vt = ptot / m_gpf
    q_ret = (vt - u2) / (vt + u2)
    no_ret = crossed_prp & ((vt < u2) | (u[_U_PRET] > q_ret * q_ret))
    status = torch.where(no_ret, FINISHED, status)
    reason = torch.where(no_ret, R_DOWNSTREAM, reason)
    returns = crossed_prp & ~no_ret
    phi = torch.where(returns, (u[_U_RET_PHI] * 2.0 * math.pi).to(pdt), phi)
    x_new = torch.where(returns, prp_x, x_new)
    if ss.do_retro:
        # enter the explicit backward walk at the PRP
        # (retro_time, prob_return.jl:249-252)
        retro = retro_old | returns
        just_ret = torch.zeros_like(returns)
        dep("counts", torch.full_like(lo_c, C_RETRO), torch.ones_like(weight),
            returns)
    else:
        # the analytic return: back on the plane with a flux-weighted
        # inward pitch, P(mu) ~ |v mu - u2| (step.py:965-982)
        vmu = u2 - (u2 + vt) * torch.sqrt(u[_U_RET_MU])
        mu = torch.clamp(vmu / torch.maximum(vt, tiny), -1.0, 1.0)
        pb_ret = ptot * mu
        pperp_ret = torch.sqrt(torch.clamp(ptot * ptot - pb_ret * pb_ret,
                                           min=0.0))
        pb = torch.where(returns, pb_ret, pb)
        pperp = torch.where(returns, pperp_ret, pperp)
        retro = retro_old
        just_ret = returns

    if ss.is_electron:
        # electron PRP shrink heuristics (prob_return.jl:142-164)
        idle = past_end & ~just_end & ~crossed_prp
        check = idle & (ptot < k["pcut_prev"]) & (st.nsteps % 1000 == 0)
        l_d = (eta3 * (ptot * c * gyro_denom) * ptot
               / (m * gamma_pf * u2)).to(f64)
        ratio = torch.div(k["pcut_prev"], torch.maximum(ptot, tiny))
        r2 = ratio * ratio
        shrink = torch.where(
            x_new > 2.0e3 * l_d, 0.8 * x_new,
            torch.minimum(prp_x, k["x_stop"] + l_d * (ratio * (r2 * r2))))
        prp_x = torch.where(check, shrink, prp_x)

    esc = esc_feb_dw | esc_far
    status = torch.where(esc, FINISHED, status)
    reason = torch.where(esc, R_DOWNSTREAM, reason)

    # downstream-escape pressure / KE sums (particle_loop.jl:477-495)
    esc_dw = moving & (status == FINISHED) & (reason == R_DOWNSTREAM)
    vel = ptot / m
    vel = torch.where((gamma_pf - 1.0) >= E_REL_PT, vel / gamma_pf, vel)
    p_dw = torch.where(esc_dw, torch.div(ptot, k["three"]) * vel * weight,
                       0.0).to(f64).sum()
    ke_dw = torch.where(esc_dw, (gamma_pf - 1.0) * e0 * weight,
                        0.0).to(f64).sum()
    tl.esc.add_(torch.stack([-px_up, en_up, p_dw, ke_dw]))

    if ss.do_retro:
        (status, reason, x_new, pb, pperp, phi, acct, tcut, retro,
         just_ret) = _retro_step(act & retro_old, st, tb, u, dep, status,
                                 reason, x_new, prp_x, pb, pperp, phi,
                                 acct, tcut, retro, just_ret)
    _deposit(tl, deps)

    # helix cap (particle_loop.jl:162-165)
    nsteps = st.nsteps + act.to(torch.int32)
    capped = (status == ACTIVE) & (nsteps >= max_helix)
    status = torch.where(capped, FINISHED, status)
    reason = torch.where(capped, R_DOWNSTREAM, reason)

    st.pb.copy_(pb)
    st.pperp.copy_(pperp)
    st.phi.copy_(phi)
    st.x.copy_(x_new)
    st.igrid.copy_(ig_new)
    st.ux_prev.copy_(ux_prev)
    st.xn_per.copy_(xn_per)
    st.prp_x.copy_(prp_x)
    st.acctime.copy_(acct)
    st.tcut.copy_(tcut)
    st.status.copy_(status)
    st.reason.copy_(reason)
    st.nsteps.copy_(nsteps)
    st.t_step.copy_(torch.where(moving, t_step, st.t_step))
    st.flags.copy_(downstream.to(torch.int32) * FL_DW
                   | inj.to(torch.int32) * FL_INJ
                   | retro.to(torch.int32) * FL_RETRO
                   | just_ret.to(torch.int32) * FL_JRET)


def _retro_step(in_retro, st, tb, u, dep, status, reason, x_new, prp_x,
                pb, pperp, phi, acct, tcut, retro, just_ret):
    """One step of the backward 'retrodictive' walk of the lanes in retro
    mode at the step's start (retro_time, prob_return.jl:217-344;
    ``_retro_step``, step.py:1006-1091): the reversed downstream flow of
    the last zone, large-angle scattering, radiative losses and tcut
    tracking, until the lane is back at its PRP."""
    ss, k = tb.ss, tb.k
    m = k["m"]
    c = C_CGS
    pdt = pb.dtype
    x = st.x

    b2 = k["b_dw"]
    if ss.use_custom_eps_b:
        b2 = b2 * _custom_eps_b_decay(x, k, pdt)
    gden = torch.div(k["one"], k["abs_charge"] * b2)
    ptot = hyp(pb, pperp)
    gamma_pf = hyp(ptot / (m * c), k["one"])
    t_fac = k["two_pi"] * m * c * gden / k["ten"]
    t_step = t_fac * gamma_pf
    if ss.parallel:
        dx = k["gsf_dw"] * (pb * t_fac / m + (-k["ux_dw"]) * t_step)
    else:
        phi_new = floor_mod(phi + k["two_pi"] / k["ten"], k["two_pi"])
        dx = k["gsf_dw"] * (pb * t_fac / m * k["bcos_dw"]
                            - pperp * c * gden * k["bsin_dw"]
                            * (torch.cos(phi_new) - torch.cos(phi))
                            + (-k["ux_dw"]) * t_step)
    x_try = x + dx.to(X_DTYPE)
    acct_new = acct + (t_step * k["gef_dw"]).to(X_DTYPE)

    # tcut tracking continues during the replay (prob_return.jl:297-304)
    if ss.do_tcuts:
        n_slots = tb.tcuts.shape[0]
        slot = tcut.clamp(0, n_slots - 1).long()
        fire = in_retro & (tcut < n_slots) & (acct_new >= tb.tcuts[slot])
        ip_pf = psd_bin_momentum(ptot, ss.psd_mom_min, ss.bins_per_dec_mom,
                                 ss.n_mom).long()
        dep("weight_coupled", slot, st.weight, fire)
        dep("spectra_coupled", ip_pf * n_slots + slot, st.weight, fire)
        tcut = torch.where(fire, tcut + 1, tcut)

    # large-angle scattering: full randomization (prob_return.jl:306-311)
    phi_las = (2.0 * math.pi * u[_U_RETRO_PHI]).to(pdt)
    mu_las = 2.0 * u[_U_RETRO_MU] - 1.0
    p_new = ptot
    if ss.do_rad_losses and ss.is_electron:
        b_cmb = k["b_cmbz"] * k["gef_dw"]
        p_new = radiation_loss(b2 * b2 + b_cmb * b_cmb, ptot, t_step,
                               RAD_LOSS_FAC)
        dep("counts", torch.full_like(tcut, C_RAD),
            (gamma_pf - hyp(p_new / (m * c), k["one"])) * k["e0"]
            * st.weight, in_retro)
    dead = in_retro & (p_new <= 0.0)
    pb_new = (p_new * mu_las).to(pdt)
    pperp_new = torch.sqrt(torch.clamp(p_new * p_new - pb_new * pb_new,
                                       min=0.0))
    returned = in_retro & ~dead & (x_try < prp_x)

    x_new = torch.where(in_retro, torch.where(returned, prp_x, x_try), x_new)
    pb = torch.where(in_retro, pb_new, pb)
    pperp = torch.where(in_retro, pperp_new, pperp)
    phi = torch.where(in_retro, phi_las, phi)
    acct = torch.where(in_retro, acct_new, acct)
    status = torch.where(dead, FINISHED, status)
    reason = torch.where(dead, R_RADIATED, reason)
    retro = retro & ~(returned | dead)
    just_ret = just_ret | returned
    return (status, reason, x_new, pb, pperp, phi, acct, tcut, retro,
            just_ret)


def _deposit(tl: Tallies, deps: dict) -> None:
    """One float64 index_add_ of the step's entries into a scratch buffer
    laid out [the tallies of _DEPOSIT_TARGETS that the step feeds | one
    slot per entry], then each tally's part into it.  An entry that is
    off (its lane crossed or fired nothing) goes to its own slot: it adds
    nothing to a tally, and on a CUDA device it does not queue on the
    atomics of the few slots the lanes share."""
    names = [n for n in _DEPOSIT_TARGETS if n in deps]
    offs, n_real = [], 0
    for n in names:
        offs.append(n_real)
        n_real += getattr(tl, n).numel()
    idx = torch.cat([i + o for n, o in zip(names, offs)
                     for i, _, _ in deps[n]])
    val = torch.cat([v for n in names for _, v, _ in deps[n]])
    on = torch.cat([a for n in names for _, _, a in deps[n]])
    own = n_real + torch.arange(idx.shape[0], device=idx.device)
    buf = torch.zeros(n_real + idx.shape[0], dtype=torch.float64,
                      device=idx.device)
    buf.index_add_(0, torch.where(on, idx, own), torch.where(on, val, 0.0))
    for n, o in zip(names, offs):
        t = getattr(tl, n)
        t.view(-1).add_(buf[o:o + t.numel()])


def _block(st: ParticleState, tl: Tallies, tb: StepTables, n: int,
           max_helix: int) -> None:
    """`n` helix steps, the uniforms of the block drawn at once: a lane
    ACTIVE at step s of the block has made exactly s steps in it.  K5's
    plain version; on a CUDA device it counts in helix.PLAIN_CALLS."""
    if st.weight.device.type == "cuda":
        helix.PLAIN_CALLS += 1
    ctr = st.nsteps[None] + torch.arange(n, dtype=torch.int32,
                                         device=st.weight.device)[:, None]
    u_blk = rng.lane_uniforms_xla(st.key0, st.key1, ctr)
    for s in range(n):
        helix_step(st, tl, tb, u_blk[:, s], max_helix)


def window_sizes(b: int, compact_levels: int) -> list:
    """The compaction ladder's windows (step.py:771-778): the batch,
    then halves while the half is at least 512 lanes and a multiple of
    128, at most `compact_levels` times."""
    sizes = [b]
    for _ in range(max(compact_levels, 0)):
        nxt = sizes[-1] // 2
        if nxt < 512 or nxt % 128 != 0:
            break
        sizes.append(nxt)
    return sizes


def _tensors(obj) -> list:
    return [getattr(obj, f.name) for f in fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)]


class _BlockGraph:
    """One S-step block of the plain step captured as a CUDA graph and
    replayed: the plain-torch step is some 300 small kernels, and
    launching them one by one from the host takes several times their
    device time.  A replay runs the captured kernels on the same tensors
    (the state and tallies are updated in place).  Capture only records,
    so the K2 launches and the plain block counted while capturing are
    taken back, and every replay adds what it runs."""

    def __init__(self, st, tl, tb, n, max_helix, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        before = hist.LAUNCHES, helix.PLAIN_CALLS
        with torch.cuda.graph(self.graph, pool=pool):
            _block(st, tl, tb, n, max_helix)
        self.k2_launches = hist.LAUNCHES - before[0]
        hist.LAUNCHES, helix.PLAIN_CALLS = before

    def replay(self) -> None:
        self.graph.replay()
        hist.LAUNCHES += self.k2_launches
        helix.PLAIN_CALLS += 1


class GraphCache:
    """The drain's blocks on a CUDA device.  The plain step's captured
    blocks (the oblique step's), kept across segments: one graph per
    window size, step configuration and set of tensors (their addresses,
    shapes and dtypes are part of the key, so a graph replays only on
    the tensors it was captured on).  The graphs share one memory pool;
    they never run at once and keep no output of their own.  Counts the
    captures and their seconds; with `timing` set (on a cache, or on
    the class for every cache), CUDA events around every block (a K5
    window launch or a graph replay) and every K5 drain give the device
    time a step at each window size (``step_ms``) and the device time of
    each segment (``segment_ms``), read after the work has finished."""

    timing = False

    def __init__(self):
        self.graphs = {}
        self.pool = None
        self.captures = 0
        self.capture_s = 0.0
        self._events = []     # (window size, steps, start, end)
        self._segments = []   # (lanes, steps, [(start, end), ...])

    def key(self, st, tl, tb, n, max_helix) -> tuple:
        return (n, max_helix, tb.static(), tuple(
            (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
            for t in _tensors(st) + _tensors(tl) + tb.tensors()))

    def capture(self, key, st, tl, tb, n, max_helix) -> _BlockGraph:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        g = self.graphs[key] = _BlockGraph(st, tl, tb, n, max_helix,
                                           self.pool)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return g

    def _events_pair(self) -> list:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        return ev

    def run(self, size: int, n: int, block) -> None:
        """block() (one block of `n` steps on a window of `size` lanes),
        between two CUDA events when timing."""
        if not self.timing:
            block()
            return
        ev = self._events_pair()
        block()
        ev[1].record()
        self._events.append((size, n, ev[0], ev[1]))

    def drain(self, d, size: int, max_helix: int, sync_every: int,
              wait: bool = True):
        """One K5 drain `d` (helix.HelixDrain) of a segment of `size`
        lanes, between two CUDA events when timing; returns its steps,
        or with `wait` False its header on the device, unread (the
        timing reads its steps with the events)."""
        ev = self._events_pair() if self.timing else None
        d.enqueue(max_helix, sync_every)
        if ev is not None:
            ev[1].record()
        if not wait:
            head = d.header()
            if ev is not None:
                self._segments.append((size, head[helix.WS_TAKEN],
                                       [tuple(ev)]))
            return head
        taken = d.finish()
        if ev is not None:
            self._segments.append((size, taken, [tuple(ev)]))
        return taken

    def mark(self) -> int:
        """Where the next segment's blocks start (``end_segment``)."""
        return len(self._events)

    def end_segment(self, size: int, steps: int, first: int) -> None:
        """The blocks timed since ``mark`` returned `first` as one segment
        of `size` lanes and `steps` steps."""
        if self.timing:
            self._segments.append((size, steps, [
                (a, b) for _, _, a, b in self._events[first:]]))

    def step_ms(self) -> dict:
        """Window size -> (replayed steps, mean device ms a step)."""
        acc = {}
        for size, n, a, b in self._events:
            steps, ms = acc.get(size, (0, 0.0))
            acc[size] = (steps + n, ms + a.elapsed_time(b))
        return {size: (steps, ms / steps) for size, (steps, ms)
                in sorted(acc.items(), reverse=True)}

    def segment_ms(self) -> list:
        """Each timed segment: its lanes, its steps, its device ms (a
        drain's launch, or the sum of the block loop's timed blocks) and
        the launches or blocks timed (a first eager block is not)."""
        return [dict(lanes=size, steps=int(steps), blocks=len(evs),
                     ms=sum(a.elapsed_time(b) for a, b in evs))
                for size, steps, evs in self._segments]


def _window(st: ParticleState, size: int) -> ParticleState:
    """The first `size` lanes of `st`, as views of its storage."""
    return ParticleState(**{f.name: getattr(st, f.name)[:size]
                            for f in fields(st)})


def _permute(st: ParticleState, order: torch.Tensor) -> None:
    """Reorder the lanes of `st` by `order`, in place."""
    for f in fields(st):
        a = getattr(st, f.name)
        a.copy_(a.index_select(0, order))


def run_segment(st: ParticleState, tl: Tallies, tb: StepTables,
                sync_every: int = SYNC_EVERY,
                max_helix: int | None = None, compact_levels: int = 0,
                graphs: GraphCache | None = None, plain: bool = False,
                blocks: bool = False, packed=None, wait: bool = True):
    """Step every lane until none is ACTIVE (one pcut segment), in place;
    returns the number of helix steps the block loop takes:
    `sync_every` times the blocks it runs.

    The block loop checks for ACTIVE lanes on the host every
    `sync_every` steps.  The extra steps are exact no-ops: a lane that
    is not ACTIVE does not step (its count and state stay; the step
    clears its FL_JRET bit), and every tally is gated on a moving lane,
    so the result does not depend on `sync_every`.

    `compact_levels` > 0 turns on the live-lane compaction ladder of the
    block loop (step.py:724-850): the blocks run on a window of the
    lanes (window_sizes), and at a host check that finds no more ACTIVE
    lanes than the next window holds, a stable partition moves the
    ACTIVE lanes to the front and the blocks go on with the smaller
    window.  A lane's uniforms are keyed by its own key and step count,
    so every lane ends bit-identical to `compact_levels=0`, back in its
    own slot; only the summation order of the shared tallies changes.

    On a CUDA device the parallel-field step is one K5 drain a segment
    (ops/helix.py HelixDrain): the card's threads claim lanes from a
    device cursor, the host reads one integer when the segment is over
    and none inside it, and no lane moves, so `compact_levels` is moot
    there; the lanes and the returned steps are the block loop's at
    `compact_levels=0` (helix.drain_plain states the rule).  A drain
    that does not build or launch raises: there is no fallback.
    `packed` is the drain's helix.Packed when the caller made it (the
    ladder packs a species' segments at once), and `wait` False leaves
    the drain unread: run_segment then returns its header (int32 words,
    helix.WS_*) on the device, and the caller reads its steps and
    pushes (``helix.header_pushes``) when it next waits.
    `blocks` asks for the block loop of K5 windows instead (one K5
    launch a block, a host read each: helix.HOST_READS), for
    comparisons.  The oblique branches are not in K5: the oblique step's
    blocks replay CUDA graphs of the plain step from `graphs` (a fresh
    cache when None).  A window whose graph is not cached captures it at
    once when the cache holds a graph already; the first window of an
    empty cache runs its first block eagerly (which warms the step's
    kernels up) and captures the next.  `graphs` also times the drains
    and blocks (GraphCache.timing).  On the CPU every block is the plain
    ``_block``.  `plain` asks for the plain step's graphs on a CUDA
    device in place of K5, the reference that chip_smoke.py and the
    tests hold K5 to."""
    if max_helix is None:
        max_helix = MAX_HELIX_STEPS
    cuda = st.weight.device.type == "cuda"
    k5 = cuda and tb.ss.parallel and not plain
    if cuda and graphs is None:
        graphs = GraphCache()
    b = st.weight.shape[0]
    if k5 and packed is None:
        packed = helix.pack(tb)
    if k5 and not blocks:
        return graphs.drain(helix.HelixDrain(st, tl, packed), b,
                            max_helix, sync_every, wait=wait)
    launches = {}           # window size -> K5 on that window
    sizes = window_sizes(b, compact_levels)
    level, win = 0, st
    orig = None
    taken = blocks_run = 0
    first = graphs.mark() if cuda else 0
    for _ in range(max_helix // sync_every + 2):
        n_act = int((win.status == ACTIVE).sum())
        if k5:
            helix.HOST_READS += 1
        if n_act == 0:
            break
        if level + 1 < len(sizes) and n_act <= sizes[level + 1]:
            # the ACTIVE lanes to the front of this window, stably, with
            # each lane's original slot
            if orig is None:
                orig = torch.arange(b, device=st.weight.device)
            order = torch.argsort((win.status != ACTIVE).to(torch.int8),
                                  stable=True)
            _permute(win, order)
            o = orig[:sizes[level]]
            o.copy_(o.index_select(0, order))
            while level + 1 < len(sizes) and n_act <= sizes[level + 1]:
                level += 1
            win, blocks_run = _window(st, sizes[level]), 0
        size = sizes[level]
        if k5:
            kl = launches.get(size)
            if kl is None:
                kl = launches[size] = helix.HelixLaunch(win, tl, packed)
            graphs.run(size, sync_every,
                       lambda: kl.enqueue(sync_every, max_helix))
        elif cuda:
            key = graphs.key(win, tl, tb, sync_every, max_helix)
            g = graphs.graphs.get(key)
            if g is None and (blocks_run > 0 or graphs.graphs):
                g = graphs.capture(key, win, tl, tb, sync_every, max_helix)
            if g is not None:
                graphs.run(size, sync_every, g.replay)
            else:
                _block(win, tl, tb, sync_every, max_helix)
        else:
            _block(win, tl, tb, sync_every, max_helix)
        taken += sync_every
        blocks_run += 1
    if orig is not None:
        # every lane back in its original slot
        inv = torch.empty_like(orig)
        inv[orig] = torch.arange(b, device=orig.device)
        _permute(st, inv)
    if cuda:
        graphs.end_segment(b, taken, first)
    return taken
