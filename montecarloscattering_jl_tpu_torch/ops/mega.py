"""The transport kernel K1: helix steps in a persistent launch, one lane
a thread at a time.

Replaces montecarloscattering_jl_tpu/ops/pallas_step.py::_mega_kernel /
_mega_body (the Pallas megakernel) on an NVIDIA Hopper card.  This
module holds:

* ``step_twin``: the plain PyTorch version of one launch, a direct
  reading of ``_mega_body.step`` (pallas_step.py:318-1034).  It is the
  spec of K1, the CPU path, and what ``chip_smoke.py`` holds K1 against
  on the card.
* ``launch``: the wrapper.  A state on the CPU takes the twin; a state
  on a CUDA device launches K1 (csrc/mega_step.cu) or raises.
  ``K1Launch`` is its prepared form: the tensors validated and the
  kernel's arguments built once, each ``enqueue`` one foreign call that
  waits for nothing.
* ``drain``: the drive.  On the CPU a host loop of twin launches until
  no lane is ACTIVE or the helix-cap bound on launches is reached
  (pallas_step.py:1650).  On a CUDA device one K1 launch with the helix
  cap as its step count: the kernel's threads claim lanes from a device
  cursor until every lane has ended, so the host waits for nothing
  (where launches begin and end cannot change a lane's trajectory).
* ``mega_tables`` / ``ladder_tables``: a segment's tables, or those of
  every segment of a species in one host-to-device copy.
* ``drive_ladder_async``: the pcut ladder's scheduler (the JAX
  package's, pallas_step.py:2057-2127), which engine/run.py's fused
  ladders run on: segments queued without a host wait, the chain read
  every MCS_HYBRID_SYNC_EVERY segments.
* ``check_supported``: the static-flag gate of this kernel.
* ``instance_of``: K1 is compiled once per flag word of ``INSTANCES``
  (the flags as compile-time constants) and once with the flags read at
  run time, which serves every other word.

Every static flag of the megakernel's cfg runs: no-scatter, no-DSA,
radiative losses, the retro walk, tcuts, the energy transfer, custom
eps_B and the custom f(r_g) mean-free-path law, as bits of the packed
int vector (FLAG_*), with the tcut times, eps_target and the received-energy
prefix as tables read by index (no bf16 splits or one-hot gathers).

Arithmetic follows the megakernel: momenta, fields and segment scalars
in float32, with one change of contract taken from the XLA engine:
positions, PRP and acceleration time are float64 (no double-single
words), and zone lookups compare float64 positions with float64
boundaries.  Tallies go straight into the full difference arrays
(f32 PSD, f64 flux and sums): no band, window, stochastic rounding or
drop counting.  Because the RNG counter is the lane's step count, where
launches begin and end cannot change any lane's trajectory, and lanes
keep their order (no partition, no unsort).

``hyp`` is jnp.hypot's formula, written out so the JAX reference, the
twin and K1 round alike; every constant that divides or is divided by a
tensor is a 0-dim tensor on the state's device, because torch turns
``t / python_scalar`` into a reciprocal multiply on CUDA and
``python_scalar / t`` into one everywhere.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.constants import C_CGS, RAD_LOSS_FAC
from ..utils.params import (
    ALL_FLUX_SPIKE_AWAY, E_REL_PT, MAX_HELIX_STEPS)
from ..utils.tracing import span
from . import build, rng
from .scattering import radiation_loss
from .transforms import hyp
from .state import (ACTIVE, C_RAD, C_RECV, C_RETRO, FINISHED, FL_DW, FL_INJ,
                    FL_JRET, FL_RETRO, N_COUNTS, R_AGE, R_DOWNSTREAM,
                    R_RADIATED, R_UPSTREAM_PMAX, SAVED,
                    ParticleState, SegmentGrids, SegmentScalars,
                    StepStatic, Tallies, upload)

STEPS = 256            # helix steps per launch (pallas_step.py:91)
ZMAX = 128             # zone-table capacity: nb + 1 <= ZMAX

# kernel launches and twin calls since the last reset (plain counters:
# chip_smoke.py zeroes them around the main path and reads them back)
LAUNCHES = 0
TWIN_CALLS = 0
# times `launch` made the host wait for a K1 launch's ACTIVE count
# (`drain` on a CUDA device makes none)
HOST_WAITS = 0

# f32 scalar vector `sf` (the kernel reads the same indices)
(SF_M, SF_MC, SF_E0, SF_INV_Q, SF_PCUT, SF_PCUT_PREV, SF_PMAX, SF_U2,
 SF_BMAG2, SF_G0U0, SF_PE_CRIT, SF_GAMMA_E_CRIT, SF_INJ_FRAC, SF_C,
 SF_ETA3, SF_XN_COARSE, SF_XN_FINE, SF_CMAX_COARSE, SF_CMAX_FINE,
 SF_TWO_PI, SF_PI, SF_PSD_MOM_MIN, SF_LOG_PMIN, SF_THETA_MIN,
 SF_LOG_TMIN, SF_COS_FINE, SF_DCOS, SF_INV_LN10, SF_SPIKE, SF_THREE,
 SF_ONE, SF_TINY30, SF_TINY37, SF_E_REL, SF_B_CMBZ, SF_EWF, SF_RAD,
 SF_B_DW, SF_GSF_DW, SF_GEF_DW, SF_UX_DW, SF_TEN, SF_FRG_RG0, SF_FRG_AM1,
 SF_ETA, SF_TWELVE_PI) = range(46)
N_SF = 46
# f64 scalar vector `sd`
SD_FEB_UP, SD_FEB_DW, SD_X_STOP, SD_AGE_MAX = range(4)
N_SD = 4
# int vector `si`
(SI_NB, SI_I_GRID_FEB, SI_N_MOM, SI_N_THETA, SI_BPD_MOM, SI_BPD_THETA,
 SI_IS_ELECTRON, SI_I_SHOCK, SI_N_TCUT, SI_FLAGS) = range(10)
N_SI = 10
# bits of si[SI_FLAGS]: the static flags of the megakernel's cfg
(FLAG_DONT_SCATTER, FLAG_DONT_DSA, FLAG_RAD_LOSSES, FLAG_RETRO, FLAG_TCUTS,
 FLAG_ENERGY_TRANSFER, FLAG_CUSTOM_EPS_B, FLAG_CUSTOM_FRG) = (
     1, 2, 4, 8, 16, 32, 64, 128)
_FLAG_NAMES = (("dont_scatter", FLAG_DONT_SCATTER),
               ("dont_dsa", FLAG_DONT_DSA),
               ("do_rad_losses", FLAG_RAD_LOSSES), ("do_retro", FLAG_RETRO),
               ("do_tcuts", FLAG_TCUTS),
               ("do_energy_transfer", FLAG_ENERGY_TRANSFER),
               ("use_custom_eps_b", FLAG_CUSTOM_EPS_B))

# K1's instances (csrc/mega_step.cu kInstances, the same words in the
# same order): the flag bits, CT_ELECTRON for an electron species;
# CT_RUNTIME is the instance that reads both at run time.  A proton's
# word never carries FLAG_RAD_LOSSES: the loss acts on electrons only.
CT_ELECTRON, CT_RUNTIME = 256, -1
CT_SCIENCE = (FLAG_RETRO | FLAG_TCUTS | FLAG_ENERGY_TRANSFER
              | FLAG_CUSTOM_EPS_B)
INSTANCES = (0,
             CT_ELECTRON | FLAG_RAD_LOSSES,
             CT_SCIENCE,
             CT_ELECTRON | FLAG_RAD_LOSSES | CT_SCIENCE,
             FLAG_CUSTOM_FRG,
             CT_SCIENCE | FLAG_CUSTOM_FRG,
             CT_ELECTRON | FLAG_RAD_LOSSES | CT_SCIENCE | FLAG_CUSTOM_FRG,
             CT_RUNTIME)

_N_REFLECT_TRIES = 2
_U_BLOCK = 64          # steps of uniforms the twin draws at once


def flag_word(flags: int, is_electron: bool) -> int:
    """The word K1's instances are keyed by."""
    if is_electron:
        return flags | CT_ELECTRON
    return flags & ~FLAG_RAD_LOSSES


def instance_of(flags: int, is_electron: bool) -> int:
    """Index into INSTANCES of the K1 instance that runs these flags:
    the one compiled for exactly this word, else the run-time one."""
    word = flag_word(flags, is_electron)
    if word in INSTANCES:
        return INSTANCES.index(word)
    return INSTANCES.index(CT_RUNTIME)


def check_supported(ss: StepStatic) -> None:
    """Raise NotImplementedError for a config K1 does not run: one the
    megakernel itself rejects (megakernel_supported,
    pallas_step.py:1206-1239: oblique fields, x_spec detectors, more
    zones than the table holds; float64 momenta are the engine
    selection's business, engine/run.py)."""
    if not ss.parallel or ss.n_xspec != 0:
        raise NotImplementedError(
            "oblique fields and x_spec detectors run on the XLA engine "
            "(ops/step.py), not K1")
    if ss.nb + 1 > ZMAX:
        raise NotImplementedError(
            f"nb + 1 = {ss.nb + 1} exceeds the {ZMAX}-zone table")


@dataclass
class MegaTables:
    """Device inputs of one segment: zone and energy-transfer tables,
    tcut times and packed scalars."""

    xg: torch.Tensor     # [nb] f64 boundaries
    zf: torch.Tensor     # [4, nb] f32: ux, gamma_sf, gamma_ef, btot
    sf: torch.Tensor     # [N_SF] f32
    sd: torch.Tensor     # [N_SD] f64
    si: torch.Tensor     # [N_SI] int32
    tc: torch.Tensor     # [n_tcut_slots] f64 tcut times, +inf padded
    et: torch.Tensor     # [nb] f32 eps_target
    rp: torch.Tensor     # [nb+1] f64 recv_prefix
    nb: int
    i_grid_feb: int
    n_mom: int
    n_theta: int
    bins_per_dec_mom: int
    bins_per_dec_theta: int
    is_electron: bool
    i_shock: int
    flags: int           # FLAG_* bits

    def on(self, flag: int) -> bool:
        return bool(self.flags & flag)


def _scalar_rows(sc: SegmentScalars, ss: StepStatic,
                 dw: tuple) -> tuple[np.ndarray, np.ndarray]:
    """One segment's `sf` (float32) and `sd` (float64) vectors, packed the
    way the megakernel's _mega_scf/_scvec do (pallas_step.py:1300-1369):
    derived scalars are computed in float32 from float32 operands.  `dw`:
    btot, gamma_sf, gamma_ef and ux of the downstream-most zone."""
    f = np.float32
    m = f(sc.m)
    c = f(C_CGS)
    eta = f(ss.eta_mfp)
    sf = np.zeros(N_SF, np.float32)
    sf[SF_M] = m
    sf[SF_MC] = m * c
    sf[SF_E0] = m * f(C_CGS ** 2)
    sf[SF_INV_Q] = f(1.0) / f(sc.abs_charge)
    sf[SF_PCUT] = sc.pcut
    sf[SF_PCUT_PREV] = sc.pcut_prev
    sf[SF_PMAX] = sc.pmax_cutoff
    sf[SF_U2] = sc.u2
    sf[SF_BMAG2] = sc.bmag2
    sf[SF_G0U0] = sc.gamma0_u0
    sf[SF_PE_CRIT] = sc.pe_crit
    sf[SF_GAMMA_E_CRIT] = sc.gamma_e_crit
    sf[SF_INJ_FRAC] = sc.inj_frac
    sf[SF_C] = c
    sf[SF_ETA3] = eta / f(3.0)
    sf[SF_XN_COARSE] = ss.xn_per_coarse
    sf[SF_XN_FINE] = ss.xn_per_fine
    sf[SF_CMAX_COARSE] = np.cos(np.sqrt(
        12.0 * np.pi / (ss.xn_per_coarse * ss.eta_mfp)))
    sf[SF_CMAX_FINE] = np.cos(np.sqrt(
        12.0 * np.pi / (ss.xn_per_fine * ss.eta_mfp)))
    sf[SF_TWO_PI] = 2.0 * np.pi
    sf[SF_PI] = np.pi
    sf[SF_PSD_MOM_MIN] = ss.psd_mom_min
    sf[SF_LOG_PMIN] = np.log10(ss.psd_mom_min)
    sf[SF_THETA_MIN] = ss.theta_min
    sf[SF_LOG_TMIN] = np.log10(ss.theta_min)
    sf[SF_COS_FINE] = ss.cos_fine
    sf[SF_DCOS] = ss.dcos
    sf[SF_INV_LN10] = 1.0 / np.log(10.0)
    sf[SF_SPIKE] = ALL_FLUX_SPIKE_AWAY
    sf[SF_THREE] = 3.0
    sf[SF_ONE] = 1.0
    sf[SF_TINY30] = 1e-30
    sf[SF_TINY37] = 1e-37
    sf[SF_E_REL] = E_REL_PT
    sf[SF_B_CMBZ] = sc.b_cmbz
    sf[SF_EWF] = ss.electron_weight_fac
    sf[SF_RAD] = RAD_LOSS_FAC
    sf[SF_B_DW], sf[SF_GSF_DW], sf[SF_GEF_DW], sf[SF_UX_DW] = dw
    sf[SF_TEN] = 10.0
    sf[SF_FRG_RG0] = ss.frg_rg0_cm
    sf[SF_FRG_AM1] = ss.frg_alpha - 1.0
    sf[SF_ETA] = eta
    sf[SF_TWELVE_PI] = 12.0 * np.pi
    sd = np.array([sc.feb_up, sc.feb_dw, sc.x_grid_stop,
                   sc.age_max if sc.age_max > 0 else 3.0e38], np.float64)
    return sf, sd


def _flags(ss: StepStatic) -> int:
    flags = 0
    for name, bit in _FLAG_NAMES:
        if getattr(ss, name):
            flags |= bit
    if ss.frg_rg0_cm > 0.0:
        flags |= FLAG_CUSTOM_FRG
    return flags


def _int_vector(ss: StepStatic, n_tc: int) -> np.ndarray:
    return np.array([ss.nb, ss.i_grid_feb, ss.n_mom, ss.n_theta,
                     ss.bins_per_dec_mom, ss.bins_per_dec_theta,
                     int(ss.is_electron), ss.i_shock, n_tc, _flags(ss)],
                    np.int32)


def _zone_tables(grids: SegmentGrids, ss: StepStatic, dev) -> dict:
    """The tables a species' segments share, MegaTables' fields but the
    scalar vectors."""
    nb = ss.nb
    zf = torch.stack([grids.ux[:nb], grids.gamma_sf[:nb],
                      grids.gamma_ef[:nb], grids.btot[:nb]]).to(
                          dev, torch.float32).contiguous()
    return dict(
        xg=grids.x_grid[:nb].to(dev, torch.float64).contiguous(), zf=zf,
        tc=grids.tcuts.to(dev, torch.float64).contiguous(),
        et=grids.eps_target[:nb].to(dev, torch.float32).contiguous(),
        rp=grids.recv_prefix[:nb + 1].to(dev, torch.float64).contiguous(),
        nb=nb, i_grid_feb=ss.i_grid_feb,
        n_mom=ss.n_mom, n_theta=ss.n_theta,
        bins_per_dec_mom=ss.bins_per_dec_mom,
        bins_per_dec_theta=ss.bins_per_dec_theta,
        is_electron=bool(ss.is_electron), i_shock=ss.i_shock,
        flags=_flags(ss))


def mega_tables(grids: SegmentGrids, sc: SegmentScalars, ss: StepStatic,
                device) -> MegaTables:
    """Pack the segment's grids and scalars the way the megakernel's
    _mega_scf/_scvec/_mega_prep do (pallas_step.py:1300-1369): derived
    scalars are computed in float32 from float32 operands.  The tcut
    times and the received-energy prefix stay float64, as the XLA
    engine keeps them; eps_target is float32."""
    nb = ss.nb
    dw = tuple(float(a[nb - 2]) for a in (grids.btot, grids.gamma_sf,
                                          grids.gamma_ef, grids.ux))
    return ladder_tables(grids, [sc], ss, device, dw)(0)


def ladder_tables(grids: SegmentGrids, scs: list, ss: StepStatic, device,
                  dw: tuple):
    """``mega_tables`` of every segment of a species' ladder (`scs`, one
    SegmentScalars a segment), with one host-to-device copy for all of
    them: each segment's `sf` and `sd` are a row of one [n_seg, N] table.
    `dw` is the downstream-most zone's btot, gamma_sf, gamma_ef and ux
    (host values: the grids' are on the device).  Returns ``table(i)``,
    segment i's MegaTables, made when asked (a chain that dies early
    uses few of them)."""
    dev = torch.device(device)
    rows = [_scalar_rows(sc, ss, dw) for sc in scs]
    sf, sd, si = upload([np.stack([r[0] for r in rows]),
                         np.stack([r[1] for r in rows]),
                         _int_vector(ss, grids.tcuts.shape[0])], dev)
    shared = _zone_tables(grids, ss, dev)
    return lambda i: MegaTables(sf=sf[i], sd=sd[i], si=si, **shared)


def floor_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.mod for floats: fmod, moved into b's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _zone(xg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Index of the last boundary <= x (int64), -1 below the grid."""
    return torch.searchsorted(xg, x.contiguous(), right=True) - 1


def _mom_bin(p, tb: MegaTables, k):
    """The megakernel's momentum bin (get_psd_bins.jl:16-39) in f32."""
    lp = torch.log(torch.maximum(p, k(SF_TINY37))) * k(SF_INV_LN10) \
        - k(SF_LOG_PMIN)
    ipb = torch.floor(lp * float(tb.bins_per_dec_mom)).to(torch.int32) + 1
    ipb = torch.where(p < k(SF_PSD_MOM_MIN), 0, ipb)
    return ipb.clamp(0, tb.n_mom)


def step_twin(st: ParticleState, tb: MegaTables, tl: Tallies,
              n_steps: int, max_helix: int) -> int:
    """Advance every ACTIVE lane of `st` by up to `n_steps` helix steps,
    in place, depositing tallies into `tl` in place.  Returns the number
    of lanes still ACTIVE.  The plain PyTorch version of K1."""
    global TWIN_CALLS
    TWIN_CALLS += 1
    k = lambda i: tb.sf[i]                # 0-dim f32 device tensors
    m, mc, e0, inv_q = k(SF_M), k(SF_MC), k(SF_E0), k(SF_INV_Q)
    pcut, pcut_prev, pmax_cutoff = k(SF_PCUT), k(SF_PCUT_PREV), k(SF_PMAX)
    u2, bmag2, g0u0 = k(SF_U2), k(SF_BMAG2), k(SF_G0U0)
    pe_crit, gamma_e_crit = k(SF_PE_CRIT), k(SF_GAMMA_E_CRIT)
    inj_frac, c, eta3 = k(SF_INJ_FRAC), k(SF_C), k(SF_ETA3)
    xn_coarse, xn_fine = k(SF_XN_COARSE), k(SF_XN_FINE)
    cmax_coarse, cmax_fine = k(SF_CMAX_COARSE), k(SF_CMAX_FINE)
    two_pi, pi = k(SF_TWO_PI), k(SF_PI)
    theta_min, log_tmin = k(SF_THETA_MIN), k(SF_LOG_TMIN)
    cos_fine, dcos, inv_ln10 = k(SF_COS_FINE), k(SF_DCOS), k(SF_INV_LN10)
    spike_away, three, one = k(SF_SPIKE), k(SF_THREE), k(SF_ONE)
    tiny30, tiny37, e_rel = k(SF_TINY30), k(SF_TINY37), k(SF_E_REL)
    b_cmbz, ewf, rad = k(SF_B_CMBZ), k(SF_EWF), k(SF_RAD)
    b_dw, gsf_dw, gef_dw = k(SF_B_DW), k(SF_GSF_DW), k(SF_GEF_DW)
    ux_dw, ten = k(SF_UX_DW), k(SF_TEN)
    frg_rg0, frg_am1 = k(SF_FRG_RG0), k(SF_FRG_AM1)
    eta, twelve_pi = k(SF_ETA), k(SF_TWELVE_PI)
    feb_up, feb_dw = tb.sd[SD_FEB_UP], tb.sd[SD_FEB_DW]
    x_stop, age_max = tb.sd[SD_X_STOP], tb.sd[SD_AGE_MAX]
    nb, nz = tb.nb, tb.nb + 1
    is_el = tb.is_electron
    dont_scatter, dont_dsa = tb.on(FLAG_DONT_SCATTER), tb.on(FLAG_DONT_DSA)
    rad_on = tb.on(FLAG_RAD_LOSSES) and is_el
    do_retro, do_tcuts = tb.on(FLAG_RETRO), tb.on(FLAG_TCUTS)
    xfer_on, eps_b = tb.on(FLAG_ENERGY_TRANSFER), tb.on(FLAG_CUSTOM_EPS_B)
    frg_on = tb.on(FLAG_CUSTOM_FRG)
    n_tc = tb.tc.shape[0]
    xg = tb.xg
    zux, zgsf, zgef, zb = tb.zf[0], tb.zf[1], tb.zf[2], tb.zf[3]
    psd_flat = tl.psd_diff.view(-1)
    flux_flat = tl.flux_diff.view(-1)
    i32, f64 = torch.int32, torch.float64
    inf = torch.tensor(float("inf"), dtype=f64, device=st.x.device)

    def decay(x):
        """sqrt(x_stop / max(x, x_stop)), the ratio in f64, the root in
        f32 (the custom eps_B field beyond the grid end)."""
        return torch.sqrt((x_stop / torch.maximum(x, x_stop)).float())

    def tcut_time(idx):
        return torch.where(idx < n_tc, tb.tc[idx.clamp(0, n_tc - 1).long()],
                           inf)

    w_lane = st.weight
    pb, pperp, phi = st.pb, st.pperp, st.phi
    uxp, xnp, tstep = st.ux_prev, st.xn_per, st.t_step
    prp, x, acct = st.prp_x, st.x, st.acctime
    status, reason, nsteps, flags = st.status, st.reason, st.nsteps, st.flags
    tcut = st.tcut

    # the reflection at the shock can only fire with inj_frac < 1 or
    # with DSA off
    reflect = float(inj_frac) < 1.0 or dont_dsa
    nsteps0 = nsteps.clone()
    for s in range(n_steps):
        act = status == ACTIVE
        if not bool(act.any()):
            break
        if s % _U_BLOCK == 0:
            # a lane ACTIVE at step s has made exactly s steps in this
            # launch, so its counters are nsteps0 + s: draw a block of
            # steps' uniforms at once (the same numbers, fewer ops)
            ctr = (nsteps0[None] + torch.arange(
                min(_U_BLOCK, n_steps - s), device=nsteps0.device,
                dtype=torch.int32)[:, None] + s)
            u_blk = torch.stack(rng.uniforms(st.key0, st.key1, ctr))
        u = u_blk[:, s % _U_BLOCK]
        retro = (flags & FL_RETRO) != 0
        jret = (flags & FL_JRET) != 0
        dwf = (flags & FL_DW) != 0
        injf = (flags & FL_INJ) != 0
        norm = act & ~retro
        do_b3 = norm & ~jret

        # ---- zone fields from position ---------------------------------
        ig = _zone(xg, x)
        igc = ig.clamp(min=0)
        ux, gsf, gef, bmag = zux[igc], zgsf[igc], zgef[igc], zb[igc]
        if eps_b:
            bmag = torch.where(x > x_stop, b_dw * decay(x), bmag)
        gden = inv_q / bmag

        ptot = hyp(pb, pperp)
        gamma_pf = hyp(ptot / mc, one)

        # ---- Code Block 3 ----------------------------------------------
        changed = do_b3 & (ux != uxp)
        beta_old = uxp / c
        gsf_old = torch.div(one, torch.sqrt(torch.maximum(
            1.0 - beta_old * beta_old, tiny30)))
        px_sk_t = gsf_old * (pb + gamma_pf * m * uxp)
        pt_sk_t = hyp(px_sk_t, pperp)
        g_sk_t = hyp(pt_sk_t / mc, one)
        pb_tr = gsf * (px_sk_t - g_sk_t * m * ux)
        pb = torch.where(changed, pb_tr, pb)
        ptot = hyp(pb, pperp)
        gamma_pf = hyp(ptot / mc, one)
        uxp = torch.where(do_b3, ux, uxp)

        if dont_scatter:
            # downstream escape with scattering off
            esc_ns = do_b3 & (x > 10.0 * (pperp * c * gden))
            status = torch.where(esc_ns, FINISHED, status)
            reason = torch.where(esc_ns, R_DOWNSTREAM, reason)
            do_b3 = do_b3 & ~esc_ns

        # pmax escape (both frames)
        px_sk0 = gsf * (pb + gamma_pf * m * ux)
        pt_sk0 = hyp(px_sk0, pperp)
        esc_pmax = do_b3 & (ptot > pmax_cutoff) & (pt_sk0 > pmax_cutoff)
        status = torch.where(esc_pmax, FINISHED, status)
        reason = torch.where(esc_pmax, R_UPSTREAM_PMAX, reason)
        do_b3 = do_b3 & ~esc_pmax

        # upstream FEB escape
        esc_feb = do_b3 & injf & (x < feb_up)
        status = torch.where(esc_feb, FINISHED, status)
        reason = torch.where(esc_feb, R_UPSTREAM_PMAX, reason)
        do_b3 = do_b3 & ~esc_feb

        # age escape
        esc_age = do_b3 & (acct > age_max)
        status = torch.where(esc_age, FINISHED, status)
        reason = torch.where(esc_age, R_AGE, reason)
        do_b3 = do_b3 & ~esc_age

        if rad_on:
            # synchrotron + inverse-Compton losses
            b_cmb = b_cmbz * gef
            bsq = bmag * bmag + b_cmb * b_cmb
            p_lost = radiation_loss(bsq, ptot, tstep, rad)
            dead = do_b3 & (p_lost <= 0.0)
            scale = torch.where(do_b3, p_lost / torch.maximum(ptot, tiny30),
                                one)
            pb = pb * scale
            pperp = pperp * scale
            ptot = hyp(pb, pperp)
            gamma_in, gamma_pf = gamma_pf, hyp(ptot / mc, one)
            tl.counts[C_RAD] += torch.where(
                do_b3, (gamma_in - gamma_pf) * e0 * w_lane, 0.0).to(f64).sum()
            status = torch.where(dead, FINISHED, status)
            reason = torch.where(dead, R_RADIATED, reason)
            do_b3 = do_b3 & ~dead

        if not dont_scatter:
            # pitch-angle scattering (parallel: no phase adjustment)
            cos_max = torch.where(xnp == xn_coarse, cmax_coarse, cmax_fine)
            if frg_on:
                # custom MFP law lambda = eta*r_g*(r_g/r_ref)^(alpha-1);
                # the power as exp(log(.)*(alpha-1)), as the megakernel
                p_scat = (torch.where(ptot < pe_crit, pe_crit, ptot)
                          if is_el else ptot)
                lg = torch.log(torch.maximum(p_scat * c * gden / frg_rg0,
                                             tiny30))
                f_frg = torch.exp(lg * frg_am1)
                cos_max = torch.cos(torch.sqrt(
                    twelve_pi / (xnp * eta) / torch.maximum(f_frg, tiny30)))
            safe_pt = torch.maximum(ptot, tiny30)
            cos_old = pb / safe_pt
            sin_old = pperp / safe_pt
            cos_dt = 1.0 - u[0] * (1.0 - cos_max)
            sin_dt = torch.sqrt(torch.clamp(1.0 - cos_dt * cos_dt, min=0.0))
            phi_sc = u[1] * two_pi - pi
            cos_new = torch.clamp(cos_old * cos_dt
                                  + sin_old * sin_dt * torch.cos(phi_sc),
                                  -1.0, 1.0)
            sin_new = torch.sqrt(torch.clamp(1.0 - cos_new * cos_new,
                                             min=0.0))
            pb = torch.where(do_b3, ptot * cos_new, pb)
            pperp = torch.where(do_b3, ptot * sin_new, pperp)

        # gyro period / t_step
        if is_el:
            g_eff = torch.where(ptot < pe_crit, gamma_e_crit, gamma_pf)
        else:
            g_eff = gamma_pf
        gyro_period = two_pi * g_eff * mc * gden

        # acctime (downstream only), tcuts, pcut save-out
        adding = do_b3 & dwf
        acct = acct + torch.where(adding, tstep * gef, 0.0).to(f64)
        fire = torch.zeros_like(adding)
        fire_slot = torch.zeros_like(tcut)
        if do_tcuts:
            fire = adding & (acct >= tcut_time(tcut))
            fire_slot = tcut.clamp(0, n_tc - 1)
            tcut = torch.where(fire, tcut + 1, tcut)
        save = adding & (ptot > pcut)
        status = torch.where(save, SAVED, status)
        prp = torch.where(save & (x >= prp), x * 1.1, prp)
        do_b3 = do_b3 & ~save

        r_g_tot = ptot * c * gden
        xnp = torch.where(norm & (status == ACTIVE),
                          torch.where(x > r_g_tot, xn_coarse, xn_fine),
                          xnp)

        # ---- movement ---------------------------------------------------
        moving = (status == ACTIVE) & ~retro
        tstep = torch.where(moving, gyro_period / xnp, tstep)

        x_old = x
        done = ~moving
        pb_m = pb
        phi_m = phi
        dx_acc = torch.zeros_like(pb)
        phi_fin = phi
        u_inj = (u[5], u[6])
        u_phi = (u[7], u[3])
        # without reflection every try is accepted at once: the loop's
        # first pass and the fallback below compute the same move
        for kk in range(_N_REFLECT_TRIES if reflect else 0):
            phi_try = floor_mod(phi_m + torch.div(two_pi, xnp), two_pi)
            dx = gsf * (pb_m * tstep / (gamma_pf * m) + ux * tstep)
            x_try = x_old + dx.to(f64)
            cross_up = (x_try <= 0.0) & (x_old > 0.0) & ~injf
            if not dont_dsa:
                cross_up = cross_up & (inj_frac < 1.0) & (u_inj[kk]
                                                          > inj_frac)
            refl = ~done & cross_up
            accept = ~done & ~refl
            dx_acc = torch.where(accept, dx, dx_acc)
            phi_fin = torch.where(accept, phi_try, phi_fin)
            done = done | accept
            neg = pb_m < 0.0
            pb_m = torch.where(refl & neg, -pb_m, pb_m)
            phi_m = torch.where(refl & ~neg, u_phi[kk] * two_pi, phi_m)
        phi_try = floor_mod(phi_m + torch.div(two_pi, xnp), two_pi)
        dx = gsf * (pb_m * tstep / (gamma_pf * m) + ux * tstep)
        dx_acc = torch.where(done, dx_acc, dx)
        phi_fin = torch.where(done, phi_fin, phi_try)
        pb = torch.where(moving, pb_m, pb)
        phi = torch.where(moving, phi_fin, phi)
        x = x + torch.where(moving, dx_acc, 0.0).to(f64)

        first_dw = moving & (x_old < 0.0) & (x >= 0.0)
        dwf = dwf | first_dw
        l_diff0 = eta3 * r_g_tot * ptot / (m * gamma_pf * u2)
        prp = torch.where(first_dw, torch.maximum(prp, l_diff0), prp)
        injf = injf | (moving & dwf & (x < 0.0))

        # ---- tallies (all_flux) -----------------------------------------
        ig_new = _zone(xg, x).clamp(0, nb - 2)
        ig_new = torch.where(moving, ig_new, ig)

        px_sk = gsf * (pb + gamma_pf * m * ux)
        pt_sk = hyp(px_sk, pperp)
        g_sk = hyp(pt_sk / mc, one)
        pz_sk = -pperp * torch.sin(phi)
        spike = pt_sk > px_sk.abs() * spike_away
        inv_vx = torch.where(
            spike, torch.div(spike_away, ux).abs(),
            (g_sk * m / torch.where(px_sk == 0.0, tiny30, px_sk)).abs())
        rel = (g_sk - 1.0) > e_rel
        e_add = torch.where(rel, (g_sk - 1.0) * e0 * w_lane,
                            pt_sk * pt_sk / (2.0 * m) * w_lane)

        moved_down = x > x_old
        lo_z = torch.where(moved_down, ig + 1, ig_new + 1)
        hi_z = torch.where(moved_down, ig_new, ig)
        lo_z = torch.where(~moved_down & injf,
                           torch.clamp(lo_z, min=tb.i_grid_feb + 1), lo_z)
        crossed = moving & (hi_z >= lo_z)
        lo_c = lo_z.clamp(0, nb - 1)
        hi_c = hi_z.clamp(0, nb - 1)
        if bool(crossed.any()):      # deposit only when some lane crossed
            sign = torch.where(moved_down, 1.0, -1.0).to(torch.float32)
            on = crossed.to(torch.float32)
            v_pxx = sign * px_sk * w_lane * g0u0 * on
            v_pxz = pz_sk.abs() * w_lane * g0u0 * on
            v_en = sign * e_add * g0u0 * on
            v_n = (crossed & ~injf).to(torch.float32)

            # psd bins (get_psd_bins.jl:16-39, 73-97)
            ipb = _mom_bin(pt_sk, tb, k)
            p_cos = torch.clamp(-px_sk / torch.maximum(pt_sk, tiny37),
                                -1.0, 1.0)
            jlin = tb.n_theta - torch.floor((p_cos + 1.0) / dcos).to(i32)
            theta = torch.acos(p_cos)
            lt = (torch.log(torch.maximum(theta, tiny37)) * inv_ln10
                  - log_tmin)
            jlog = (torch.floor(lt * float(tb.bins_per_dec_theta)).to(i32)
                    + 1)
            jlog = torch.where(theta < theta_min, 0, jlog)
            jt = torch.where(p_cos < cos_fine, jlin, jlog)
            jt = torch.where(pt_sk <= 0.0, 0, jt)
            jt = jt.clamp(0, tb.n_theta)
            kind = (~injf).to(i32)
            cell = ((ipb * 2 + kind) * (tb.n_theta + 1) + jt).long()
            psd_w = torch.where(crossed, w_lane * inv_vx * on, 0.0)

            base = cell * nz
            psd_flat.index_put_(
                (torch.cat([base + lo_c, base + hi_c + 1]),),
                torch.cat([psd_w, -psd_w]), accumulate=True)
            vals = torch.stack([v_pxx, v_pxz, v_en, v_n]).to(f64)
            vals = torch.where(crossed, vals, 0.0)
            ch = (torch.arange(4, device=x.device) * nz)[:, None]
            flux_flat.index_put_(
                (torch.cat([(ch + lo_c).reshape(-1),
                            (ch + hi_c + 1).reshape(-1)]),),
                torch.cat([vals.reshape(-1), -vals.reshape(-1)]),
                accumulate=True)

        # escaping flux at the upstream FEB
        esc_cross = moving & injf & (x < feb_up) & (x_old >= feb_up)
        if bool(esc_cross.any()):
            tl.esc[1] += torch.where(esc_cross, e_add * g0u0, 0.0).to(
                f64).sum()
            tl.esc[0] += torch.where(esc_cross, -px_sk * w_lane * g0u0,
                                     0.0).to(f64).sum()

        if xfer_on:
            # ion <-> electron energy transfer (particle_loop.jl:652-723)
            hi_t = torch.clamp(hi_c, max=tb.i_shock)
            xfer = crossed & ~injf & (x_old <= 0.0) & (hi_t >= lo_c)
            if is_el:
                gain = (tb.rp[hi_t + 1] - tb.rp[lo_c]).float() * ewf
                takes = xfer & (gain > 0.0)
                g_f = torch.where(takes, gamma_pf + gain / e0, gamma_pf)
                tl.counts[C_RECV] += torch.where(
                    takes, (g_f - gamma_pf) * e0 * w_lane, 0.0).to(f64).sum()
            else:
                eps_stop = tb.et[hi_t]
                eps_start = tb.et[igc]
                g_f = 1.0 + (gamma_pf - 1.0) * (1.0 - eps_stop) \
                    / torch.maximum(1.0 - eps_start, tiny30)
                donate = xfer & (eps_stop > 0.0)
                g_f = torch.where(donate, torch.clamp(g_f, min=1.0),
                                  gamma_pf)
                n_range = (hi_t - lo_c + 1).to(torch.float32)
                inc = torch.where(donate, (gamma_pf - g_f) * e0 * w_lane
                                  / torch.clamp(n_range, min=1.0), 0.0)
                tl.pool_diff.index_put_(
                    (torch.cat([lo_c, hi_t + 1]),),
                    torch.cat([inc, -inc]).to(f64), accumulate=True)
            scale = (torch.sqrt(torch.clamp(g_f * g_f - 1.0, min=0.0))
                     / torch.maximum(torch.sqrt(torch.clamp(
                         gamma_pf * gamma_pf - 1.0, min=0.0)), tiny30))
            scale = torch.where(xfer & (g_f != gamma_pf), scale, one)
            pb = pb * scale
            pperp = pperp * scale
            ptot = hyp(pb, pperp)
            gamma_pf = hyp(ptot / mc, one)

        # ---- downstream logic -------------------------------------------
        jret_new = torch.zeros_like(jret)
        if is_el:
            low_e = ptot < pe_crit
            v_fac = torch.where(
                low_e,
                (pe_crit * c * gden) * pe_crit / (m * gamma_e_crit * u2),
                (ptot * c * gden) * ptot / (m * gamma_pf * u2))
        else:
            v_fac = (ptot * c * gden) * ptot / (m * gamma_pf * u2)
        l_diff = eta3 * v_fac

        esc_feb_dw = moving & (feb_dw > 0.0) & (x > feb_dw)
        esc_far = (moving & ~esc_feb_dw & (x > 1.1 * prp)
                   & (x > (6.91 * l_diff).to(f64)))
        do_ret = moving & ~esc_feb_dw & ~esc_far

        past_end = do_ret & (x >= x_stop)
        just_end = past_end & (x_old < x_stop)
        r_g2 = ptot * c
        if eps_b:
            r_g2 = r_g2 * decay(x)
        r_g2 = r_g2 * inv_q / bmag2
        l_diff2 = eta3 * r_g2 * ptot / (m * gamma_pf * u2)
        prp = torch.where(just_end, x + (3.0 * l_diff2).to(f64), prp)

        crossed_prp = past_end & ~just_end & (x_old < prp) & (x >= prp)
        if bool(crossed_prp.any()):  # the PRP test and the return
            vt = ptot / (gamma_pf * m)
            q_ret = (vt - u2) / (vt + u2)
            p_ret = q_ret * q_ret
            no_ret = crossed_prp & ((vt < u2) | (u[2] > p_ret))
            status = torch.where(no_ret, FINISHED, status)
            reason = torch.where(no_ret, R_DOWNSTREAM, reason)
            returns = crossed_prp & ~no_ret
            if do_retro:
                # enter the backward walk at the PRP
                retro = retro | returns
                tl.counts[C_RETRO] += returns.sum().to(f64)
            else:
                # the analytic return
                span = u2 + vt
                vmu = u2 - span * torch.sqrt(u[3])
                mu = torch.clamp(vmu / torch.maximum(vt, tiny30), -1.0, 1.0)
                pb_ret = ptot * mu
                pperp_ret = torch.sqrt(torch.clamp(
                    ptot * ptot - pb_ret * pb_ret, min=0.0))
                pb = torch.where(returns, pb_ret, pb)
                pperp = torch.where(returns, pperp_ret, pperp)
                jret_new = jret_new | returns
            phi = torch.where(returns, u[4] * two_pi, phi)
            x = torch.where(returns, prp, x)

        if is_el:
            idle = past_end & ~just_end & ~crossed_prp
            check = (idle & (ptot < pcut_prev)
                     & (nsteps % 1000 == 0))
            r_g = ptot * c * gden
            l_d = eta3 * r_g * ptot / (m * gamma_pf * u2)
            far = x > (2.0e3 * l_d).to(f64)
            ratio = pcut_prev / torch.maximum(ptot, tiny30)
            r2 = ratio * ratio
            p5 = ratio * (r2 * r2)
            shrink = torch.where(
                far, 0.8 * x,
                torch.minimum(prp, x_stop + (l_d * p5).to(f64)))
            prp = torch.where(check, shrink, prp)

        esc = esc_feb_dw | esc_far
        status = torch.where(esc, FINISHED, status)
        reason = torch.where(esc, R_DOWNSTREAM, reason)

        # downstream-escape pressure / KE sums
        esc_dw = moving & (status == FINISHED) & (reason == R_DOWNSTREAM)
        if bool(esc_dw.any()):
            vel = ptot / m
            vel = torch.where((gamma_pf - 1.0) >= e_rel, vel / gamma_pf,
                              vel)
            tl.esc[2] += torch.where(esc_dw, ptot / three * vel * w_lane,
                                     0.0).to(f64).sum()
            tl.esc[3] += torch.where(esc_dw, (gamma_pf - 1.0) * e0 * w_lane,
                                     0.0).to(f64).sum()

        if do_retro:
            # ---- the retro walk (prob_return.jl:217-344), of every lane
            # in retro mode now, those that entered it this step included
            in_retro = act & retro
            b2 = b_dw * decay(x) if eps_b else b_dw
            gden_r = inv_q / b2
            ptot_r = hyp(pb, pperp)
            gamma_r = hyp(ptot_r / mc, one)
            t_fac = two_pi * mc * gden_r / ten
            t_step_r = t_fac * gamma_r
            dx_r = gsf_dw * (pb * t_fac / m + (-ux_dw) * t_step_r)
            x_try = x + dx_r.to(f64)
            acct = acct + torch.where(in_retro, t_step_r * gef_dw,
                                      0.0).to(f64)
            if do_tcuts:
                # tcut tracking continues during the replay
                fire_r = in_retro & (acct >= tcut_time(tcut))
                fire_slot = torch.where(fire_r, tcut.clamp(0, n_tc - 1),
                                        fire_slot)
                fire = fire | fire_r
                tcut = torch.where(fire_r, tcut + 1, tcut)
            phi_las = two_pi * u[0]
            mu_las = 2.0 * u[1] - 1.0
            p_new = ptot_r
            if rad_on:
                b_cmb = b_cmbz * gef_dw
                p_new = radiation_loss(b2 * b2 + b_cmb * b_cmb, ptot_r,
                                       t_step_r, rad)
                tl.counts[C_RAD] += torch.where(
                    in_retro, (gamma_r - hyp(p_new / mc, one)) * e0 * w_lane,
                    0.0).to(f64).sum()
            dead_r = in_retro & (p_new <= 0.0)
            pb_n = p_new * mu_las
            pperp_n = torch.sqrt(torch.clamp(p_new * p_new - pb_n * pb_n,
                                             min=0.0))
            returned = in_retro & ~dead_r & (x_try < prp)
            x = torch.where(in_retro, torch.where(returned, prp, x_try), x)
            pb = torch.where(in_retro, pb_n, pb)
            pperp = torch.where(in_retro, pperp_n, pperp)
            phi = torch.where(in_retro, phi_las, phi)
            status = torch.where(dead_r, FINISHED, status)
            reason = torch.where(dead_r, R_RADIATED, reason)
            retro = retro & ~(returned | dead_r)
            jret_new = jret_new | returned

        if do_tcuts and bool(fire.any()):
            # the coupled weight and spectrum of the step's tcut crossings,
            # binned at the lane's final momentum (tcut_track!,
            # cuts.jl:149-162)
            ip_pf = _mom_bin(hyp(pb, pperp), tb, k).long()
            wv = torch.where(fire, w_lane, 0.0).to(f64)
            slot = fire_slot.long()
            tl.spectra_coupled.view(-1).index_put_(
                (ip_pf * n_tc + slot,), wv, accumulate=True)
            tl.weight_coupled.index_put_((slot,), wv, accumulate=True)

        # helix cap
        nsteps = nsteps + act.to(i32)
        capped = (status == ACTIVE) & (nsteps >= max_helix)
        status = torch.where(capped, FINISHED, status)
        reason = torch.where(capped, R_DOWNSTREAM, reason)

        # a lane that was not ACTIVE at the step's start leaves the
        # kernel's loop, so its flags (the just-returned bit included)
        # stay as they were
        new_flags = (dwf.to(i32) * FL_DW | injf.to(i32) * FL_INJ
                     | retro.to(i32) * FL_RETRO
                     | jret_new.to(i32) * FL_JRET)
        flags = torch.where(act, new_flags, flags).to(i32)

    st.pb.copy_(pb)
    st.pperp.copy_(pperp)
    st.phi.copy_(phi)
    st.ux_prev.copy_(uxp)
    st.xn_per.copy_(xnp)
    st.t_step.copy_(tstep)
    st.prp_x.copy_(prp)
    st.x.copy_(x)
    st.acctime.copy_(acct)
    st.tcut.copy_(tcut)
    st.status.copy_(status)
    st.reason.copy_(reason)
    st.nsteps.copy_(nsteps)
    st.flags.copy_(flags)
    return int((status == ACTIVE).sum())


# ---------------------------------------------------------------------------
# K1: build, bind, launch
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.library("mega_step")
        fn = lib.mcs_mega_launch
        fn.argtypes = [ctypes.c_void_p] * 33 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mcs_mega_instance_word.argtypes = [ctypes.c_int]
        lib.mcs_mega_instance_attrs.argtypes = [ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        built = tuple(lib.mcs_mega_instance_word(i)
                      for i in range(lib.mcs_mega_num_instances()))
        if built != INSTANCES:
            raise RuntimeError(f"K1 was built with the instances {built}, "
                               f"ops/mega.py lists {INSTANCES}")
        _LIB = lib
    return _LIB


def instance_attrs(i: int) -> dict:
    """Registers a thread, bytes of local memory (stack and spills) a
    thread, and the blocks the card holds at once (0 before its first
    launch) of K1's instance `i`, from the CUDA runtime."""
    regs, local, resident = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().mcs_mega_instance_attrs(
        i, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(resident))
    if err != 0:
        raise RuntimeError(f"K1 instance {i}: CUDA error {err}")
    return dict(word=INSTANCES[i], registers=regs.value,
                local_bytes=local.value, resident_blocks=resident.value)


_STATE_SPEC = (
    ("weight", torch.float32), ("pb", torch.float32),
    ("pperp", torch.float32), ("phi", torch.float32),
    ("ux_prev", torch.float32), ("xn_per", torch.float32),
    ("t_step", torch.float32), ("x", torch.float64),
    ("prp_x", torch.float64), ("acctime", torch.float64),
    ("status", torch.int32), ("reason", torch.int32),
    ("nsteps", torch.int32), ("flags", torch.int32),
    ("tcut", torch.int32), ("key0", torch.int32), ("key1", torch.int32),
)


def _check(st: ParticleState, tb: MegaTables, tl: Tallies) -> None:
    n = st.weight.shape[0]
    dev = st.weight.device
    for name, dt in _STATE_SPEC:
        a = getattr(st, name)
        if a.dtype != dt or a.shape != (n,) or a.device != dev \
                or not a.is_contiguous():
            raise ValueError(f"state.{name}: want contiguous {dt} [{n}] "
                             f"on {dev}, got {a.dtype} {tuple(a.shape)} "
                             f"on {a.device}")
    nz = tb.nb + 1
    n_tc = tb.tc.shape[0]
    want = (("xg", tb.xg, torch.float64, (tb.nb,)),
            ("zf", tb.zf, torch.float32, (4, tb.nb)),
            ("sf", tb.sf, torch.float32, (N_SF,)),
            ("sd", tb.sd, torch.float64, (N_SD,)),
            ("si", tb.si, torch.int32, (N_SI,)),
            ("tc", tb.tc, torch.float64, (n_tc,)),
            ("et", tb.et, torch.float32, (tb.nb,)),
            ("rp", tb.rp, torch.float64, (nz,)),
            ("psd_diff", tl.psd_diff, torch.float32,
             ((tb.n_mom + 1) * 2 * (tb.n_theta + 1), nz)),
            ("flux_diff", tl.flux_diff, torch.float64, (4, nz)),
            ("esc", tl.esc, torch.float64, (4,)),
            ("pool_diff", tl.pool_diff, torch.float64, (nz,)),
            ("weight_coupled", tl.weight_coupled, torch.float64, (n_tc,)),
            ("spectra_coupled", tl.spectra_coupled, torch.float64,
             (tb.n_mom + 1, n_tc)),
            ("counts", tl.counts, torch.float64, (N_COUNTS,)))
    for name, a, dt, shape in want:
        if a.dtype != dt or tuple(a.shape) != shape or a.device != dev \
                or not a.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt} {shape} on "
                             f"{dev}, got {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}")
    if nz > ZMAX:
        raise ValueError(f"nb + 1 = {nz} exceeds the {ZMAX}-zone table")


class K1Launch:
    """K1 on one state, table set and tally set on a CUDA device,
    validated once.  ``enqueue`` launches on the current stream and
    returns at once with the count of lanes still ACTIVE as a 0-dim int32
    tensor on the device.  The tensors must outlive the object."""

    def __init__(self, st: ParticleState, tb: MegaTables, tl: Tallies):
        _check(st, tb, tl)
        self.device = st.weight.device
        if self.device.type != "cuda":
            raise ValueError(f"no transport kernel for device {self.device}")
        self.instance = instance_of(tb.flags, tb.is_electron)
        ptr = lambda a: ctypes.c_void_p(a.data_ptr())
        self._fn = _lib().mcs_mega_launch
        self._args = (
            [ptr(getattr(st, name)) for name, _ in _STATE_SPEC]
            + [ptr(a) for a in (tb.xg, tb.zf, tb.sf, tb.sd, tb.si, tb.tc,
                                tb.et, tb.rp, tl.psd_diff, tl.flux_diff,
                                tl.esc, tl.pool_diff, tl.weight_coupled,
                                tl.spectra_coupled, tl.counts)])
        self._n = ctypes.c_int(st.weight.shape[0])
        self._tail = (ctypes.c_int(self.instance),
                      ctypes.c_int(flag_word(tb.flags, tb.is_electron)))

    def enqueue(self, n_steps: int, max_helix: int) -> torch.Tensor:
        global LAUNCHES
        if n_steps < 1:
            raise ValueError(f"n_steps = {n_steps}")
        # the kernel's lane cursor and its count of lanes left ACTIVE
        scratch = torch.zeros(2, dtype=torch.int32, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._fn(*self._args, ctypes.c_void_p(scratch.data_ptr()),
                       self._n, ctypes.c_int(n_steps),
                       ctypes.c_int(max_helix), *self._tail,
                       ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"K1 launch failed: CUDA error {err}")
        LAUNCHES += 1
        return scratch[1]


def launch(st: ParticleState, tb: MegaTables, tl: Tallies,
           n_steps: int = STEPS, max_helix: int | None = None) -> int:
    """One launch of `n_steps` steps: the twin for a state on the CPU,
    K1 for a state on a CUDA device.  Returns the ACTIVE count (and so
    waits for the launch)."""
    if max_helix is None:
        max_helix = MAX_HELIX_STEPS
    if st.weight.device.type == "cpu":
        _check(st, tb, tl)
        return step_twin(st, tb, tl, n_steps, max_helix)
    global HOST_WAITS
    left = K1Launch(st, tb, tl).enqueue(n_steps, max_helix)
    HOST_WAITS += 1
    return int(left)


def drain(st: ParticleState, tb: MegaTables, tl: Tallies,
          n_steps: int = STEPS, max_helix: int | None = None) -> None:
    """Step every lane until none is ACTIVE: each to its end or to the
    helix cap.  On the CPU, twin launches of `n_steps` steps until the
    count is 0 or the cap bounds the launches (MAX_HELIX_STEPS // S + 2,
    pallas_step.py:1650).  On a CUDA device one K1 launch of `max_helix`
    steps, which leaves no lane ACTIVE; the host does not wait for it."""
    if max_helix is None:
        max_helix = MAX_HELIX_STEPS
    if st.weight.device.type != "cpu":
        K1Launch(st, tb, tl).enqueue(max(max_helix, 1), max_helix)
        return
    max_launches = max_helix // n_steps + 2
    n_act = int((st.status == ACTIVE).sum())
    k = 0
    while n_act > 0 and k < max_launches:
        n_act = launch(st, tb, tl, n_steps, max_helix)
        k += 1


# ---------------------------------------------------------------------------
# The pcut ladder's scheduler
# ---------------------------------------------------------------------------


def _fetch(n_new_d: list, nsteps_d: list) -> tuple[np.ndarray, np.ndarray]:
    """The per-segment device scalars on the host, in one read."""
    both = torch.stack([torch.stack(n_new_d).to(torch.int64),
                        torch.stack(nsteps_d).to(torch.int64)]).cpu().numpy()
    return both[0], both[1].astype(np.uint64)


def drive_ladder_async(dispatch, n_seg: int, check=None, capture=None,
                       start: int = 0, sync_at=None, stop=None, read=None):
    """Host loop over pcut segments without a host wait a segment: the
    counterpart of the JAX package's drive_ladder_async
    (pallas_step.py:2057-2127).  A blocking read drains the dispatch
    pipeline, so a read a segment keeps the host from queueing segment
    i + 1 while segment i runs.  The reference's pcut_finalize early
    break (cuts.jl:115-119) is checked every MCS_HYBRID_SYNC_EVERY
    segments (default 8; 0 = never): a segment dispatched after the
    chain died is a no-op (the split left every lane FINISHED with zero
    weight, so the drain steps none and finish_particles adds nothing),
    and a few dead segments cost less than a wait on every live one.

    ``dispatch(i)`` runs segment i and returns (n_new, nsteps) as 0-dim
    device tensors (any integer or float dtype), without waiting.  At a
    sync point, ``(i + 1) % MCS_HYBRID_SYNC_EVERY == 0`` or
    ``sync_at(i)`` true, the host reads n_new; then ``check(i)`` runs,
    then ``capture(i, n_new[start:i+1], nsteps[start:i+1])`` with the
    host's copies of the segments run so far, and the loop breaks if
    the chain is dead.  ``start`` begins the ladder at a later segment
    (a resume): segments below it are reported as zeros for the caller
    to fill in.  ``sync_at``, ``stop`` and ``read`` are the port's own:
    the engine forces a sync where a mid checkpoint is due, and
    ``stop(i)`` true means the host knows, without waiting, that the
    chain died at or before segment i (the card has finished that
    split): no further segment is queued.  ``read(i0, i1)`` (a mesh,
    where what dispatch returns is one rank's share of the chain) gives
    the chain's (n_new, nsteps) of segments [i0, i1) summed over the
    ranks, as host arrays; the scheduler then reads nothing that
    dispatch returned and calls it at each sync point for the segments
    since the last read, and once at the end for every segment it ran,
    so that every rank makes the same calls.  None of the three changes
    the result.  Each blocking read is a ``ladder.sync`` span
    (utils/tracing.py).

    Returns (n_new[n_seg] int64, nsteps[n_seg] uint64), the segments
    past the first die-out reported as the zeros they were."""
    sync_every = int(os.environ.get("MCS_HYBRID_SYNC_EVERY", "8"))
    n_new_d: list = []
    nsteps_d: list = []
    # with ``read``: the host's copies of segments [start, start + len)
    held = (np.zeros(0, np.int64), np.zeros(0, np.uint64))
    n_done = start

    def summed(i0, i1):
        a, s = read(i0, i1)
        return np.asarray(a, np.int64), np.asarray(s).astype(np.uint64)

    for i in range(start, n_seg):
        if stop is not None and i > start and stop(i - 1):
            break
        n_new, nsteps = dispatch(i)
        n_new_d.append(n_new)
        nsteps_d.append(nsteps)
        n_done = i + 1
        if ((sync_every and n_done % sync_every == 0)
                or (sync_at is not None and sync_at(i))):
            with span("ladder.sync"):
                if read is None:
                    dead = int(n_new) == 0
                else:
                    held = tuple(map(np.concatenate, zip(
                        held, summed(start + len(held[0]), n_done))))
                    dead = held[0][-1] == 0
            if check is not None:
                check(i)
            if capture is not None:
                capture(i, *(held if read is not None
                             else _fetch(n_new_d, nsteps_d)))
            if dead:
                break

    n_new_out = np.zeros(n_seg, np.int64)
    nsteps_out = np.zeros(n_seg, np.uint64)
    if n_done > start:
        with span("ladder.sync"):
            n_new_out[start:n_done], nsteps_out[start:n_done] = (
                _fetch(n_new_d, nsteps_d) if read is None
                else summed(start, n_done))
    # segments past the first die-out ran as no-ops and stay zero (scan
    # only the segments this call ran: [0, start) are the caller's)
    dead = np.flatnonzero(n_new_out[start:n_done] == 0)
    if dead.size:
        n_new_out[start + dead[0] + 1:] = 0
        nsteps_out[start + dead[0] + 1:] = 0
    return n_new_out, nsteps_out
