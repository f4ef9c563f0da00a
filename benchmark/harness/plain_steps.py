"""Plain PyTorch helix steps of a few lanes: the reference that the
window's kernels are held to, lane by lane.

Two engines push lanes in the port, each with its plain version, the
spec its kernel is held to bit for bit (K5) or to a few ulp (K1):

* ``helix_block``: the XLA engine's parallel-field step, K5's spec
  (ops/step.py helix_step and _retro_step of the port, the reference
  code's particle_loop.jl and prob_return.jl): uniforms from
  fold_in(lane key, step) and jax.random.bits (``xla_uniforms``), momenta
  in the state's dtype.
* ``mega_block``: K1's spec (ops/mega.py step_twin): uniforms from the
  Threefry blocks at counters (step, 0) and (step, 1) (``k1_uniforms``),
  float32 momenta and float32 tables.

Both are transcribed with the tallies that a drain deposits (``tallies``:
the PSD and the four flux channels in difference form over the grid's
boundaries, the upstream and downstream escape sums and the retro
entries), accumulated in float64.  The segment's tables (zone fields,
scalars, static flags) are read off the objects the program built for
the segment.  Nothing of the port is imported.  Lanes are [B] tensors
in a dict with the ParticleState's field names.  Neither step reads
the device back, so a block of steps can be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import torch

C_CGS = 2.99792458e10
ME_CGS = 9.1093837015e-28
SIGMA_T = 6.6524587321e-25
RAD_LOSS_FAC = ((4.0 / 3.0) * C_CGS * SIGMA_T
                / (C_CGS ** 3 * ME_CGS ** 2 * 8.0 * math.pi))
E_REL_PT = 0.005        # (gamma - 1) from which a particle is relativistic
ACTIVE, SAVED, FINISHED = 0, 1, 2
R_DOWNSTREAM, R_UPSTREAM_PMAX, R_AGE, R_RADIATED = 1, 2, 3, 4
FL_DW, FL_INJ, FL_RETRO, FL_JRET = 1, 2, 4, 8
F64 = torch.float64
MASK32 = 0xFFFFFFFF
_PI32 = float(torch.tensor(math.pi, dtype=torch.float32))
N_REFLECT_TRIES = 2
FIELDS = ("weight", "pb", "pperp", "phi", "x", "igrid", "ux_prev",
          "xn_per", "prp_x", "acctime", "tcut", "status", "reason",
          "nsteps", "flags", "key0", "key1", "t_step")


# ---------------------------------------------------------------------------
# Threefry-2x32-20 and the two streams
# ---------------------------------------------------------------------------

def _u32(x):
    return x.to(torch.int64) & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, on int64 words in [0, 2^32)."""
    k0, k1, c0, c1 = (_u32(torch.as_tensor(a)) for a in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for d in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[d % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & MASK32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & MASK32
    return x0, x1


def _halves(w):
    """8 float32 uniforms (h + 0.5) / 2^16 from four words' 16-bit
    halves, low halves first: [8, ...]."""
    h = torch.cat([w & 0xFFFF, w >> 16]).to(torch.float32)
    return (h + 0.5) * (1.0 / 65536.0)


def xla_uniforms(key0, key1, nsteps):
    """K5's stream: k = fold_in(lane key, step), then the xor of the two
    Threefry words at counters (0, j), j < 4, under k."""
    ctr = _u32(nsteps)
    k0, k1 = threefry2x32(key0, key1, torch.zeros_like(ctr), ctr)
    j = torch.arange(4, dtype=torch.int64, device=ctr.device).view(
        4, *([1] * ctr.dim()))
    y0, y1 = threefry2x32(k0[None], k1[None], torch.zeros_like(j), j)
    return _halves(y0 ^ y1)


def k1_uniforms(key0, key1, nsteps):
    """K1's stream: the Threefry words at counters (step, 0) and
    (step, 1) under the lane key."""
    ctr = _u32(nsteps)
    y0, y1 = threefry2x32(key0, key1, ctr, torch.zeros_like(ctr))
    z0, z1 = threefry2x32(key0, key1, ctr, torch.ones_like(ctr))
    w = torch.stack([y0, y1, z0, z1])
    h = torch.stack([w & 0xFFFF, w >> 16], dim=1).to(torch.float32)
    return ((h + 0.5) * (1.0 / 65536.0)).reshape(8, *ctr.shape)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def hyp(a, b):
    """hypot as max * sqrt(1 + (min/max)^2), 0 at 0."""
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    r = lo / torch.where(zero, torch.ones_like(hi), hi)
    return torch.where(zero, hi, hi * torch.sqrt(1.0 + r * r))


def floor_mod(a, b):
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def zone(x_grid, x):
    return torch.searchsorted(x_grid, x.contiguous(), right=True) - 1


def radiation_loss(b_sq, p, dt, fac):
    dlnp = fac * b_sq * p * dt
    return torch.where(dlnp > 1.0e-2, p / (1.0 + dlnp), p * (1.0 - dlnp))


def to_parallel_sk(pb, pperp, gamma_pf, ux, gsf, m, c):
    """Plasma -> shock frame along x: (|p|, p_x, gamma) in the shock
    frame."""
    px = gsf * (pb + gamma_pf * m * ux)
    pt = hyp(px, pperp)
    return pt, px, hyp(pt / (m * c), torch.ones_like(pt))


def tallies(n_cells: int, nb: int, device) -> dict:
    """Zeroed float64 tallies of a drain: ``psd`` [n_cells * (nb + 1)]
    and ``flux`` [4 * (nb + 1)] in difference form, ``esc`` [4]
    (-px and energy escaping upstream, the downstream escapes' pressure
    and kinetic-energy sums) and ``retro`` [1]."""
    z = lambda n: torch.zeros(n, dtype=F64, device=device)
    return {"psd": z(n_cells * (nb + 1)), "flux": z(4 * (nb + 1)),
            "esc": z(4), "retro": z(1)}


def mom_bin(p, log_pmin, bins_per_dec: int, n_mom: int, pmin, log,
            tiny):
    """Momentum bin (get_psd_bins.jl:16-39): 0 below `pmin`, then
    `bins_per_dec` a decade, clamped at `n_mom`; `log` is log10 of its
    argument."""
    b = torch.floor((log(torch.clamp(p, min=tiny)) - log_pmin)
                    * bins_per_dec).to(torch.int64) + 1
    return torch.where(p < pmin, 0, b).clamp(0, n_mom)


def angle_bin(px, pt, cos_fine, dcos, theta_min, log_tmin,
              bins_per_dec: int, n_theta: int, log, tiny):
    """Angle bin of the negative pitch cosine -px/|p|
    (get_psd_bins.jl:73-97): log-theta bins above `cos_fine`, linear
    cosine bins below."""
    p_cos = torch.clamp(-px / torch.clamp(pt, min=tiny), -1.0, 1.0)
    lin = n_theta - torch.floor((p_cos + 1.0) / dcos).to(torch.int64)
    theta = torch.acos(p_cos)
    lg = torch.floor((log(torch.clamp(theta, min=tiny)) - log_tmin)
                     * bins_per_dec).to(torch.int64) + 1
    lg = torch.where(theta < theta_min, 0, lg)
    b = torch.where(p_cos < cos_fine, lin, lg)
    return torch.where(pt <= 0.0, 0, b).clamp(0, n_theta)


def deposit(tl: dict, nz: int, crossed, moved_down, inj, lo, hi, weight,
            px_sk, pz_sk, inv_vx, e_add, g0u0, cell) -> None:
    """A step's zone crossings into the flux channels (p_xx, p_xz,
    energy, crossings) and the PSD, each over the boundaries lo..hi in
    difference form (all_flux.jl:45-259); the PSD weight is rounded to
    float32, as the card's histograms hold it."""
    on = crossed.to(px_sk.dtype)
    sign = torch.where(moved_down, 1.0, -1.0).to(px_sk.dtype)
    vals = torch.stack([sign * px_sk * weight * g0u0 * on,
                        pz_sk.abs() * weight * g0u0 * on,
                        sign * e_add * g0u0 * on,
                        (crossed & ~inj).to(px_sk.dtype)]).to(F64)
    vals = torch.where(crossed, vals, 0.0)
    ch = torch.arange(4, device=lo.device)[:, None] * nz
    tl["flux"].index_add_(0, torch.cat([(ch + lo).reshape(-1),
                                        (ch + hi + 1).reshape(-1)]),
                          torch.cat([vals.reshape(-1), -vals.reshape(-1)]))
    w = torch.where(crossed, weight * inv_vx * on, 0.0).to(
        torch.float32).to(F64)
    base = cell * nz
    tl["psd"].index_add_(0, torch.cat([base + lo, base + hi + 1]),
                         torch.cat([w, -w]))


def _esc_dw(moving, status, reason, ptot, gamma_pf, m, e0, three, e_rel,
            weight):
    """The downstream escapes' pressure and kinetic-energy sums of a
    step (particle_loop.jl:477-495)."""
    esc_dw = moving & (status == FINISHED) & (reason == R_DOWNSTREAM)
    vel = ptot / m
    vel = torch.where((gamma_pf - 1.0) >= e_rel, vel / gamma_pf, vel)
    return (torch.where(esc_dw, ptot / three * vel * weight, 0.0).to(
        F64).sum(), torch.where(esc_dw, (gamma_pf - 1.0) * e0 * weight,
                                0.0).to(F64).sum())


# ---------------------------------------------------------------------------
# K5's spec
# ---------------------------------------------------------------------------

def helix_step(st: dict, tb, k: dict, u, max_helix: int,
               tl: dict | None = None) -> None:
    """One parallel-field helix (or retro) step of every ACTIVE lane of
    `st`, in place, its tallies added into `tl` (``tallies``) where
    given.  `tb` carries the zone tables (x_grid, ux, gamma_sf,
    gamma_ef, btot, tcuts, eps_target, recv_prefix), its ``ss`` the
    static flags, and `k` the segment's scalars as 0-dim tensors."""
    ss = tb.ss
    if not ss.parallel:
        raise NotImplementedError("oblique fields")
    m, mc, e0, u2 = k["m"], k["mc"], k["e0"], k["u2"]
    one, tiny = k["one"], k["tiny"]
    c = C_CGS
    eta3 = ss.eta_mfp / 3.0
    nb = ss.nb
    pdt = st["pb"].dtype

    status, reason, flags = st["status"], st["reason"], st["flags"]
    weight, x_old = st["weight"], st["x"]
    act = status == ACTIVE
    retro_old = (flags & FL_RETRO) != 0
    dw_old = (flags & FL_DW) != 0
    inj_old = (flags & FL_INJ) != 0
    norm = act & ~retro_old
    do_b3 = norm & ((flags & FL_JRET) == 0)

    ig = st["igrid"].long()
    ux, gsf = tb.ux[ig], tb.gamma_sf[ig]
    gef, bmag = tb.gamma_ef[ig], tb.btot[ig]

    def decay(x):
        return torch.sqrt(k["x_stop"] / torch.maximum(x, k["x_stop"])).to(
            pdt)

    if ss.use_custom_eps_b:
        bmag = torch.where(x_old > k["x_stop"], k["b_dw"] * decay(x_old),
                           bmag)
    gyro_denom = torch.div(one, k["abs_charge"] * bmag)

    pb, pperp, phi = st["pb"], st["pperp"], st["phi"]
    ptot = hyp(pb, pperp)
    gamma_pf = hyp(ptot / mc, one)

    # frame re-transform, escapes, scattering
    changed = do_b3 & (ux != st["ux_prev"])
    beta_old = st["ux_prev"] / k["c"]
    gsf_old = torch.div(one, torch.sqrt(torch.maximum(
        1.0 - beta_old * beta_old, k["tiny30"])))
    _, px_o, g_o = to_parallel_sk(pb, pperp, gamma_pf, st["ux_prev"],
                                  gsf_old, m, c)
    pb = torch.where(changed, gsf * (px_o - g_o * m * ux), pb)
    ptot = hyp(pb, pperp)
    gamma_pf = hyp(ptot / mc, one)
    ux_prev = torch.where(do_b3, ux, st["ux_prev"])

    if ss.dont_scatter:
        esc_ns = do_b3 & (x_old > 10.0 * (pperp * c * gyro_denom))
        status = torch.where(esc_ns, FINISHED, status)
        reason = torch.where(esc_ns, R_DOWNSTREAM, reason)
        do_b3 = do_b3 & ~esc_ns

    ptot_sk0, _, _ = to_parallel_sk(pb, pperp, gamma_pf, ux, gsf, m, c)
    esc_pmax = do_b3 & (ptot > k["pmax"]) & (ptot_sk0 > k["pmax"])
    esc_feb = do_b3 & ~esc_pmax & inj_old & (x_old < k["feb_up"])
    esc_up = esc_pmax | esc_feb
    status = torch.where(esc_up, FINISHED, status)
    reason = torch.where(esc_up, R_UPSTREAM_PMAX, reason)
    do_b3 = do_b3 & ~esc_up
    if tb.age_cut:
        esc_age = do_b3 & (st["acctime"] > k["age_max"])
        status = torch.where(esc_age, FINISHED, status)
        reason = torch.where(esc_age, R_AGE, reason)
        do_b3 = do_b3 & ~esc_age

    if ss.do_rad_losses and ss.is_electron:
        b_cmb = k["b_cmbz"] * gef
        p_lost = radiation_loss(bmag * bmag + b_cmb * b_cmb, ptot,
                                st["t_step"], RAD_LOSS_FAC)
        dead = do_b3 & (p_lost <= 0.0)
        scale = torch.where(do_b3, p_lost / torch.maximum(ptot, tiny), one)
        pb, pperp = pb * scale, pperp * scale
        ptot = hyp(pb, pperp)
        gamma_pf = hyp(ptot / mc, one)
        status = torch.where(dead, FINISHED, status)
        reason = torch.where(dead, R_RADIATED, reason)
        do_b3 = do_b3 & ~dead

    g_eff = (torch.where(ptot < k["pe_crit"], k["gamma_e_crit"], gamma_pf)
             if ss.is_electron else gamma_pf)
    period = 2.0 * math.pi * g_eff * mc * gyro_denom
    if not ss.dont_scatter:
        cos_max = torch.where(st["xn_per"] == k["xn_coarse"],
                              k["cmax_coarse"], k["cmax_fine"])
        if ss.frg_rg0_cm > 0.0:
            p_scat = (torch.where(ptot < k["pe_crit"], k["pe_crit"], ptot)
                      if ss.is_electron else ptot)
            f_frg = torch.pow(p_scat * c * gyro_denom / k["frg_rg0"],
                              k["frg_am1"])
            cos_max = torch.cos(torch.sqrt(
                k["twelve_pi"] / (st["xn_per"] * k["eta"]
                                  * torch.maximum(f_frg, k["tiny30"]))))
        safe = torch.clamp(ptot, min=1.0e-300)
        cos_old, sin_old = pb / safe, pperp / safe
        cos_dt = 1.0 - u[0] * (1.0 - cos_max)
        sin_dt = torch.sqrt(torch.clamp(1.0 - cos_dt * cos_dt, min=0.0))
        phi_scat = ((u[1].double() * 2.0) * _PI32 - _PI32).to(u[1].dtype)
        cos_new = torch.clamp(cos_old * cos_dt
                              + sin_old * sin_dt * torch.cos(phi_scat),
                              -1.0, 1.0)
        sin_new = torch.sqrt(torch.clamp(1.0 - cos_new * cos_new, min=0.0))
        pb = torch.where(do_b3, ptot * cos_new, pb)
        pperp = torch.where(do_b3, ptot * sin_new, pperp)

    adding = do_b3 & dw_old
    acct = st["acctime"] + torch.where(adding, (st["t_step"] * gef).to(F64),
                                       0.0)
    tcut = st["tcut"]
    n_slots = tb.tcuts.shape[0]
    if ss.do_tcuts:
        slot = tcut.clamp(0, n_slots - 1).long()
        fire = adding & (tcut < n_slots) & (acct >= tb.tcuts[slot])
        tcut = torch.where(fire, tcut + 1, tcut)
    save = adding & (ptot > k["pcut"])
    status = torch.where(save, SAVED, status)
    prp_x = torch.where(save & (x_old >= st["prp_x"]), x_old * 1.1,
                        st["prp_x"])

    r_g_tot = ptot * c * gyro_denom
    xn_per = torch.where(norm & (status == ACTIVE),
                         torch.where(x_old > r_g_tot, k["xn_coarse"],
                                     k["xn_fine"]), st["xn_per"])

    # movement
    moving = (status == ACTIVE) & ~retro_old
    t_step = period / xn_per
    m_gpf = gamma_pf * m
    dphi = torch.div(k["two_pi"], xn_per)

    def move(pb_m, phi_m):
        phi_try = floor_mod(phi_m + dphi, k["two_pi"])
        dx = gsf * (pb_m * t_step / m_gpf + ux * t_step)
        return phi_try, x_old + dx.to(F64)

    pb_m, phi_m = pb, phi
    if tb.reflect:
        done = ~moving
        x_new, phi_fin = x_old, phi
        for kk in range(N_REFLECT_TRIES):
            phi_try, x_try = move(pb_m, phi_m)
            cross_up = (x_try <= 0.0) & (x_old > 0.0) & ~inj_old
            fail = (cross_up if ss.dont_dsa else
                    cross_up & (u[(5, 6)[kk]].to(pdt) > k["inj_frac"]))
            refl = ~done & fail
            accept = ~done & ~refl
            x_new = torch.where(accept, x_try, x_new)
            phi_fin = torch.where(accept, phi_try, phi_fin)
            done = done | accept
            neg = pb_m < 0.0
            pb_m = torch.where(refl & neg, -pb_m, pb_m)
            phi_m = torch.where(refl & ~neg,
                                (u[(7, 3)[kk]] * 2.0 * math.pi).to(pdt),
                                phi_m)
        phi_try, x_try = move(pb_m, phi_m)
        x_new = torch.where(done, x_new, x_try)
        phi_fin = torch.where(done, phi_fin, phi_try)
    else:
        phi_fin, x_try = move(pb_m, phi_m)
        x_new = torch.where(moving, x_try, x_old)
    pb = torch.where(moving, pb_m, pb)
    phi = torch.where(moving, phi_fin, phi)

    first_dw = moving & (x_old < 0.0) & (x_new >= 0.0)
    downstream = dw_old | first_dw
    l_diff0 = (eta3 * r_g_tot * ptot / (m * gamma_pf * u2)).to(F64)
    prp_x = torch.where(first_dw, torch.maximum(prp_x, l_diff0), prp_x)
    inj = inj_old | (moving & downstream & (x_new < 0.0))

    ig_new = zone(tb.x_grid, x_new).clamp(0, nb - 2)
    ig_new = torch.where(moving, ig_new, ig)
    moved_down = x_new > x_old
    lo = torch.where(moved_down, ig + 1, ig_new + 1)
    hi = torch.where(moved_down, ig_new, ig)
    lo = torch.where(~moved_down & inj,
                     torch.clamp(lo, min=ss.i_grid_feb + 1), lo)
    crossed = moving & (hi >= lo)
    lo_c, hi_c = lo.clamp(0, nb - 1), hi.clamp(0, nb - 1)

    if tl is not None:
        pt_sk, px_sk, g_sk = to_parallel_sk(pb, pperp, gamma_pf, ux, gsf,
                                            m, c)
        pz_sk = -pperp * torch.sin(phi)
        spike = pt_sk > px_sk.abs() * k["spike"]
        px_safe = torch.where(px_sk == 0.0, tiny, px_sk)
        inv_vx = torch.where(spike, torch.div(k["spike"], ux).abs(),
                             (g_sk * m / px_safe).abs())
        e_add = torch.where((g_sk - 1.0) > E_REL_PT,
                            (g_sk - 1.0) * e0 * weight,
                            torch.div(pt_sk * pt_sk, k["two_m"]) * weight)
        fine = torch.finfo(pdt).tiny
        ip = mom_bin(pt_sk, math.log10(ss.psd_mom_min),
                     ss.bins_per_dec_mom, ss.n_mom, ss.psd_mom_min,
                     torch.log10, fine)
        jt = angle_bin(px_sk, pt_sk, ss.cos_fine, ss.dcos, ss.theta_min,
                       math.log10(ss.theta_min), ss.bins_per_dec_theta,
                       ss.n_theta, torch.log10, fine)
        cell = (ip * 2 + (~inj).to(torch.int64)) * (ss.n_theta + 1) + jt
        deposit(tl, nb + 1, crossed, moved_down, inj, lo_c.long(),
                hi_c.long(), weight, px_sk, pz_sk, inv_vx, e_add,
                k["g0u0"], cell)
        esc_cross = (moving & inj & (x_new < k["feb_up"])
                     & (x_old >= k["feb_up"]))
        esc_up = [torch.where(esc_cross, px_sk * weight * k["g0u0"],
                              0.0).to(F64).sum().neg(),
                  torch.where(esc_cross, e_add * k["g0u0"], 0.0).to(
                      F64).sum()]

    if ss.do_energy_transfer:
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
        else:
            gain = (tb.recv_prefix[(hi_t + 1).clamp(0, nb)]
                    - tb.recv_prefix[lo_c.clamp(0, nb)]).to(pdt) \
                * ss.electron_weight_fac
            g_f = torch.where(xfer & (gain > 0.0), gamma_now + gain / e0,
                              gamma_now)
        scale = torch.sqrt(torch.clamp(g_f * g_f - 1.0, min=0.0)) \
            / torch.maximum(torch.sqrt(torch.clamp(
                gamma_now * gamma_now - 1.0, min=0.0)), k["tiny30"])
        scale = torch.where(xfer & (g_f != gamma_now), scale, one)
        pb, pperp = pb * scale, pperp * scale

    # downstream escape / return
    if ss.is_electron:
        v_fac = torch.where(
            ptot < k["pe_crit"],
            (k["pe_crit"] * c * gyro_denom) * k["pe_crit"]
            / (m * k["gamma_e_crit"] * u2),
            (ptot * c * gyro_denom) * ptot / (m * gamma_pf * u2))
    else:
        v_fac = (ptot * c * gyro_denom) * ptot / (m * gamma_pf * u2)
    l_diff = (eta3 * v_fac).to(F64)
    esc_feb_dw = (moving & (x_new > k["feb_dw"]) if tb.feb_dw_on
                  else torch.zeros_like(moving))
    esc_far = (moving & ~esc_feb_dw & (x_new > 1.1 * prp_x)
               & (x_new > 6.91 * l_diff))
    do_ret = moving & ~esc_feb_dw & ~esc_far
    past_end = do_ret & (x_new >= k["x_stop"])
    just_end = past_end & (x_old < k["x_stop"])
    r_g2 = ptot * c
    if ss.use_custom_eps_b:
        r_g2 = r_g2 * decay(x_new)
    r_g2 = torch.div(r_g2, k["qb2"])
    l_diff2 = (eta3 * r_g2 * ptot / (m * gamma_pf * u2)).to(F64)
    prp_x = torch.where(just_end, x_new + 3.0 * l_diff2, prp_x)

    crossed_prp = past_end & ~just_end & (x_old < prp_x) & (x_new >= prp_x)
    vt = ptot / m_gpf
    q_ret = (vt - u2) / (vt + u2)
    no_ret = crossed_prp & ((vt < u2) | (u[2] > q_ret * q_ret))
    status = torch.where(no_ret, FINISHED, status)
    reason = torch.where(no_ret, R_DOWNSTREAM, reason)
    returns = crossed_prp & ~no_ret
    phi = torch.where(returns, (u[4] * 2.0 * math.pi).to(pdt), phi)
    x_new = torch.where(returns, prp_x, x_new)
    if tl is not None and ss.do_retro:
        tl["retro"].add_(returns.sum().to(F64))
    if ss.do_retro:
        retro = retro_old | returns
        just_ret = torch.zeros_like(returns)
    else:
        vmu = u2 - (u2 + vt) * torch.sqrt(u[3])
        mu = torch.clamp(vmu / torch.maximum(vt, tiny), -1.0, 1.0)
        pb_ret = ptot * mu
        pperp_ret = torch.sqrt(torch.clamp(ptot * ptot - pb_ret * pb_ret,
                                           min=0.0))
        pb = torch.where(returns, pb_ret, pb)
        pperp = torch.where(returns, pperp_ret, pperp)
        retro, just_ret = retro_old, returns

    if ss.is_electron:
        idle = past_end & ~just_end & ~crossed_prp
        check = idle & (ptot < k["pcut_prev"]) & (st["nsteps"] % 1000 == 0)
        l_d = (eta3 * (ptot * c * gyro_denom) * ptot
               / (m * gamma_pf * u2)).to(F64)
        ratio = torch.div(k["pcut_prev"], torch.maximum(ptot, tiny))
        r2 = ratio * ratio
        shrink = torch.where(
            x_new > 2.0e3 * l_d, 0.8 * x_new,
            torch.minimum(prp_x, k["x_stop"] + l_d * (ratio * (r2 * r2))))
        prp_x = torch.where(check, shrink, prp_x)

    esc = esc_feb_dw | esc_far
    status = torch.where(esc, FINISHED, status)
    reason = torch.where(esc, R_DOWNSTREAM, reason)
    if tl is not None:
        tl["esc"].add_(torch.stack(esc_up + list(_esc_dw(
            moving, status, reason, ptot, gamma_pf, m, e0, k["three"],
            E_REL_PT, weight))))

    if ss.do_retro:
        in_retro = act & retro_old
        b2 = k["b_dw"]
        if ss.use_custom_eps_b:
            b2 = b2 * decay(st["x"])
        gden = torch.div(one, k["abs_charge"] * b2)
        pt_r = hyp(pb, pperp)
        g_r = hyp(pt_r / (m * c), one)
        t_fac = k["two_pi"] * m * c * gden / k["ten"]
        ts_r = t_fac * g_r
        dx = k["gsf_dw"] * (pb * t_fac / m + (-k["ux_dw"]) * ts_r)
        x_try = st["x"] + dx.to(F64)
        acct_new = acct + (ts_r * k["gef_dw"]).to(F64)
        if ss.do_tcuts:
            slot = tcut.clamp(0, n_slots - 1).long()
            fire = in_retro & (tcut < n_slots) & (acct_new >= tb.tcuts[slot])
            tcut = torch.where(fire, tcut + 1, tcut)
        phi_las = (2.0 * math.pi * u[0]).to(pdt)
        mu_las = 2.0 * u[1] - 1.0
        p_new = pt_r
        if ss.do_rad_losses and ss.is_electron:
            b_cmb = k["b_cmbz"] * k["gef_dw"]
            p_new = radiation_loss(b2 * b2 + b_cmb * b_cmb, pt_r, ts_r,
                                   RAD_LOSS_FAC)
        dead = in_retro & (p_new <= 0.0)
        pb_n = (p_new * mu_las).to(pdt)
        pperp_n = torch.sqrt(torch.clamp(p_new * p_new - pb_n * pb_n,
                                         min=0.0))
        returned = in_retro & ~dead & (x_try < prp_x)
        x_new = torch.where(in_retro, torch.where(returned, prp_x, x_try),
                            x_new)
        pb = torch.where(in_retro, pb_n, pb)
        pperp = torch.where(in_retro, pperp_n, pperp)
        phi = torch.where(in_retro, phi_las, phi)
        acct = torch.where(in_retro, acct_new, acct)
        status = torch.where(dead, FINISHED, status)
        reason = torch.where(dead, R_RADIATED, reason)
        retro = retro & ~(returned | dead)
        just_ret = just_ret | returned

    nsteps = st["nsteps"] + act.to(torch.int32)
    capped = (status == ACTIVE) & (nsteps >= max_helix)
    status = torch.where(capped, FINISHED, status)
    reason = torch.where(capped, R_DOWNSTREAM, reason)
    st.update(
        pb=pb, pperp=pperp, phi=phi, x=x_new, igrid=ig_new.to(torch.int32),
        ux_prev=ux_prev, xn_per=xn_per, prp_x=prp_x, acctime=acct,
        tcut=tcut, status=status, reason=reason, nsteps=nsteps,
        t_step=torch.where(moving, t_step, st["t_step"]),
        flags=(downstream.to(torch.int32) * FL_DW
               | inj.to(torch.int32) * FL_INJ
               | retro.to(torch.int32) * FL_RETRO
               | just_ret.to(torch.int32) * FL_JRET))


def helix_block(st: dict, tb, k: dict, n: int, max_helix: int,
                tl: dict | None = None) -> None:
    """`n` helix steps of K5's spec, the uniforms of the block drawn at
    once (a lane ACTIVE at step s has made exactly s steps in it)."""
    ctr = st["nsteps"][None] + torch.arange(
        n, dtype=torch.int32, device=st["x"].device)[:, None]
    u_blk = xla_uniforms(st["key0"], st["key1"], ctr)
    for s in range(n):
        helix_step(st, tb, k, u_blk[:, s], max_helix, tl)


# ---------------------------------------------------------------------------
# K1's spec
# ---------------------------------------------------------------------------

# indices of K1's float32 scalar vector `sf` and float64 vector `sd`
(SF_M, SF_MC, SF_E0, SF_INV_Q, SF_PCUT, SF_PCUT_PREV, SF_PMAX, SF_U2,
 SF_BMAG2, SF_G0U0, SF_PE_CRIT, SF_GAMMA_E_CRIT, SF_INJ_FRAC, SF_C,
 SF_ETA3, SF_XN_COARSE, SF_XN_FINE, SF_CMAX_COARSE, SF_CMAX_FINE,
 SF_TWO_PI, SF_PI, SF_PSD_MOM_MIN, SF_LOG_PMIN, SF_THETA_MIN,
 SF_LOG_TMIN, SF_COS_FINE, SF_DCOS, SF_INV_LN10, SF_SPIKE, SF_THREE,
 SF_ONE, SF_TINY30, SF_TINY37, SF_E_REL, SF_B_CMBZ, SF_EWF, SF_RAD,
 SF_B_DW, SF_GSF_DW, SF_GEF_DW, SF_UX_DW, SF_TEN, SF_FRG_RG0, SF_FRG_AM1,
 SF_ETA, SF_TWELVE_PI) = range(46)
SD_FEB_UP, SD_FEB_DW, SD_X_STOP, SD_AGE_MAX = range(4)
(FLAG_DONT_SCATTER, FLAG_DONT_DSA, FLAG_RAD_LOSSES, FLAG_RETRO, FLAG_TCUTS,
 FLAG_ENERGY_TRANSFER, FLAG_CUSTOM_EPS_B, FLAG_CUSTOM_FRG) = (
     1, 2, 4, 8, 16, 32, 64, 128)
U_BLOCK = 64


def mega_block(st: dict, tb, n_steps: int, max_helix: int,
               tl: dict | None = None) -> None:
    """`n_steps` steps of K1's spec on every ACTIVE lane of `st`, in
    place, the tallies added into `tl` (``tallies``) where given; a lane
    that is not ACTIVE does not move.  `tb` carries K1's segment tables:
    ``sf`` (float32 scalars, or another dtype for a control), ``sd``
    (float64), ``xg``, ``zf`` [4, nb], ``tc``, ``et``, ``rp``, the static
    fields and ``reflect`` (whether the move can reflect: injection
    fraction under 1, or no DSA), read once on the host."""
    k = lambda i: tb.sf[i]
    m, mc, e0, inv_q = k(SF_M), k(SF_MC), k(SF_E0), k(SF_INV_Q)
    pcut, pcut_prev, pmax = k(SF_PCUT), k(SF_PCUT_PREV), k(SF_PMAX)
    u2, bmag2 = k(SF_U2), k(SF_BMAG2)
    pe_crit, gamma_e_crit = k(SF_PE_CRIT), k(SF_GAMMA_E_CRIT)
    inj_frac, c, eta3 = k(SF_INJ_FRAC), k(SF_C), k(SF_ETA3)
    xn_coarse, xn_fine = k(SF_XN_COARSE), k(SF_XN_FINE)
    cmax_coarse, cmax_fine = k(SF_CMAX_COARSE), k(SF_CMAX_FINE)
    two_pi, pi, one, tiny30 = k(SF_TWO_PI), k(SF_PI), k(SF_ONE), \
        k(SF_TINY30)
    b_cmbz, ewf, rad = k(SF_B_CMBZ), k(SF_EWF), k(SF_RAD)
    b_dw, gsf_dw, gef_dw = k(SF_B_DW), k(SF_GSF_DW), k(SF_GEF_DW)
    ux_dw, ten = k(SF_UX_DW), k(SF_TEN)
    frg_rg0, frg_am1 = k(SF_FRG_RG0), k(SF_FRG_AM1)
    eta, twelve_pi = k(SF_ETA), k(SF_TWELVE_PI)
    feb_up, feb_dw = tb.sd[SD_FEB_UP], tb.sd[SD_FEB_DW]
    x_stop, age_max = tb.sd[SD_X_STOP], tb.sd[SD_AGE_MAX]
    nb = tb.nb
    is_el = tb.is_electron
    on = lambda f: bool(tb.flags & f)
    dont_scatter, dont_dsa = on(FLAG_DONT_SCATTER), on(FLAG_DONT_DSA)
    rad_on = on(FLAG_RAD_LOSSES) and is_el
    do_retro, do_tcuts = on(FLAG_RETRO), on(FLAG_TCUTS)
    xfer_on, eps_b = on(FLAG_ENERGY_TRANSFER), on(FLAG_CUSTOM_EPS_B)
    frg_on = on(FLAG_CUSTOM_FRG)
    n_tc = tb.tc.shape[0]
    xg = tb.xg
    zux, zgsf, zgef, zb = tb.zf[0], tb.zf[1], tb.zf[2], tb.zf[3]
    i32 = torch.int32
    dt = tb.sf.dtype
    inf = torch.full((), float("inf"), dtype=F64, device=st["x"].device)
    log10 = lambda a: torch.log(a) * k(SF_INV_LN10)

    def decay(x):
        return torch.sqrt((x_stop / torch.maximum(x, x_stop)).to(dt))

    def tcut_time(idx):
        return torch.where(idx < n_tc, tb.tc[idx.clamp(0, n_tc - 1).long()],
                           inf)

    pb, pperp, phi = st["pb"], st["pperp"], st["phi"]
    uxp, xnp, tstep = st["ux_prev"], st["xn_per"], st["t_step"]
    prp, x, acct = st["prp_x"], st["x"], st["acctime"]
    status, reason, nsteps, flags = (st["status"], st["reason"],
                                     st["nsteps"], st["flags"])
    tcut = st["tcut"]
    reflect = tb.reflect
    nsteps0 = nsteps.clone()
    for s in range(n_steps):
        act = status == ACTIVE
        if s % U_BLOCK == 0:
            ctr = (nsteps0[None] + torch.arange(
                min(U_BLOCK, n_steps - s), device=nsteps0.device,
                dtype=i32)[:, None] + s)
            u_blk = k1_uniforms(st["key0"], st["key1"], ctr)
        u = u_blk[:, s % U_BLOCK].to(dt)
        retro = (flags & FL_RETRO) != 0
        jret = (flags & FL_JRET) != 0
        dwf = (flags & FL_DW) != 0
        injf = (flags & FL_INJ) != 0
        norm = act & ~retro
        do_b3 = norm & ~jret

        ig = zone(xg, x)
        igc = ig.clamp(min=0)
        ux, gsf, gef, bmag = zux[igc], zgsf[igc], zgef[igc], zb[igc]
        if eps_b:
            bmag = torch.where(x > x_stop, b_dw * decay(x), bmag)
        gden = inv_q / bmag
        ptot = hyp(pb, pperp)
        gamma_pf = hyp(ptot / mc, one)

        changed = do_b3 & (ux != uxp)
        beta_old = uxp / c
        gsf_old = torch.div(one, torch.sqrt(torch.maximum(
            1.0 - beta_old * beta_old, tiny30)))
        px_sk_t = gsf_old * (pb + gamma_pf * m * uxp)
        pt_sk_t = hyp(px_sk_t, pperp)
        g_sk_t = hyp(pt_sk_t / mc, one)
        pb = torch.where(changed, gsf * (px_sk_t - g_sk_t * m * ux), pb)
        ptot = hyp(pb, pperp)
        gamma_pf = hyp(ptot / mc, one)
        uxp = torch.where(do_b3, ux, uxp)

        if dont_scatter:
            esc_ns = do_b3 & (x > 10.0 * (pperp * c * gden))
            status = torch.where(esc_ns, FINISHED, status)
            reason = torch.where(esc_ns, R_DOWNSTREAM, reason)
            do_b3 = do_b3 & ~esc_ns
        px_sk0 = gsf * (pb + gamma_pf * m * ux)
        pt_sk0 = hyp(px_sk0, pperp)
        esc_pmax = do_b3 & (ptot > pmax) & (pt_sk0 > pmax)
        status = torch.where(esc_pmax, FINISHED, status)
        reason = torch.where(esc_pmax, R_UPSTREAM_PMAX, reason)
        do_b3 = do_b3 & ~esc_pmax
        esc_feb = do_b3 & injf & (x < feb_up)
        status = torch.where(esc_feb, FINISHED, status)
        reason = torch.where(esc_feb, R_UPSTREAM_PMAX, reason)
        do_b3 = do_b3 & ~esc_feb
        esc_age = do_b3 & (acct > age_max)
        status = torch.where(esc_age, FINISHED, status)
        reason = torch.where(esc_age, R_AGE, reason)
        do_b3 = do_b3 & ~esc_age

        if rad_on:
            b_cmb = b_cmbz * gef
            p_lost = radiation_loss(bmag * bmag + b_cmb * b_cmb, ptot,
                                    tstep, rad)
            dead = do_b3 & (p_lost <= 0.0)
            scale = torch.where(do_b3, p_lost / torch.maximum(ptot, tiny30),
                                one)
            pb, pperp = pb * scale, pperp * scale
            ptot = hyp(pb, pperp)
            gamma_pf = hyp(ptot / mc, one)
            status = torch.where(dead, FINISHED, status)
            reason = torch.where(dead, R_RADIATED, reason)
            do_b3 = do_b3 & ~dead

        if not dont_scatter:
            cos_max = torch.where(xnp == xn_coarse, cmax_coarse, cmax_fine)
            if frg_on:
                p_scat = (torch.where(ptot < pe_crit, pe_crit, ptot)
                          if is_el else ptot)
                lg = torch.log(torch.maximum(p_scat * c * gden / frg_rg0,
                                             tiny30))
                f_frg = torch.exp(lg * frg_am1)
                cos_max = torch.cos(torch.sqrt(
                    twelve_pi / (xnp * eta) / torch.maximum(f_frg, tiny30)))
            safe_pt = torch.maximum(ptot, tiny30)
            cos_old, sin_old = pb / safe_pt, pperp / safe_pt
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

        g_eff = (torch.where(ptot < pe_crit, gamma_e_crit, gamma_pf)
                 if is_el else gamma_pf)
        gyro_period = two_pi * g_eff * mc * gden

        adding = do_b3 & dwf
        acct = acct + torch.where(adding, tstep * gef, 0.0).to(F64)
        if do_tcuts:
            fire = adding & (acct >= tcut_time(tcut))
            tcut = torch.where(fire, tcut + 1, tcut)
        save = adding & (ptot > pcut)
        status = torch.where(save, SAVED, status)
        prp = torch.where(save & (x >= prp), x * 1.1, prp)
        do_b3 = do_b3 & ~save
        r_g_tot = ptot * c * gden
        xnp = torch.where(norm & (status == ACTIVE),
                          torch.where(x > r_g_tot, xn_coarse, xn_fine), xnp)

        moving = (status == ACTIVE) & ~retro
        tstep = torch.where(moving, gyro_period / xnp, tstep)
        x_old = x
        done = ~moving
        pb_m, phi_m = pb, phi
        dx_acc = torch.zeros_like(pb)
        phi_fin = phi
        for kk in range(N_REFLECT_TRIES if reflect else 0):
            phi_try = floor_mod(phi_m + torch.div(two_pi, xnp), two_pi)
            dx = gsf * (pb_m * tstep / (gamma_pf * m) + ux * tstep)
            x_try = x_old + dx.to(F64)
            cross_up = (x_try <= 0.0) & (x_old > 0.0) & ~injf
            if not dont_dsa:
                cross_up = cross_up & (inj_frac < 1.0) & (
                    (u[5], u[6])[kk] > inj_frac)
            refl = ~done & cross_up
            accept = ~done & ~refl
            dx_acc = torch.where(accept, dx, dx_acc)
            phi_fin = torch.where(accept, phi_try, phi_fin)
            done = done | accept
            neg = pb_m < 0.0
            pb_m = torch.where(refl & neg, -pb_m, pb_m)
            phi_m = torch.where(refl & ~neg, (u[7], u[3])[kk] * two_pi,
                                phi_m)
        phi_try = floor_mod(phi_m + torch.div(two_pi, xnp), two_pi)
        dx = gsf * (pb_m * tstep / (gamma_pf * m) + ux * tstep)
        dx_acc = torch.where(done, dx_acc, dx)
        phi_fin = torch.where(done, phi_fin, phi_try)
        pb = torch.where(moving, pb_m, pb)
        phi = torch.where(moving, phi_fin, phi)
        x = x + torch.where(moving, dx_acc, 0.0).to(F64)

        first_dw = moving & (x_old < 0.0) & (x >= 0.0)
        dwf = dwf | first_dw
        l_diff0 = eta3 * r_g_tot * ptot / (m * gamma_pf * u2)
        prp = torch.where(first_dw, torch.maximum(prp, l_diff0), prp)
        injf = injf | (moving & dwf & (x < 0.0))

        ig_new = zone(xg, x).clamp(0, nb - 2)
        ig_new = torch.where(moving, ig_new, ig)
        moved_down = x > x_old
        lo_z = torch.where(moved_down, ig + 1, ig_new + 1)
        hi_z = torch.where(moved_down, ig_new, ig)
        lo_z = torch.where(~moved_down & injf,
                           torch.clamp(lo_z, min=tb.i_grid_feb + 1), lo_z)
        crossed = moving & (hi_z >= lo_z)
        lo_c, hi_c = lo_z.clamp(0, nb - 1), hi_z.clamp(0, nb - 1)

        if tl is not None:
            px_sk = gsf * (pb + gamma_pf * m * ux)
            pt_sk = hyp(px_sk, pperp)
            g_sk = hyp(pt_sk / mc, one)
            pz_sk = -pperp * torch.sin(phi)
            spike = pt_sk > px_sk.abs() * k(SF_SPIKE)
            inv_vx = torch.where(
                spike, torch.div(k(SF_SPIKE), ux).abs(),
                (g_sk * m / torch.where(px_sk == 0.0, tiny30,
                                        px_sk)).abs())
            e_add = torch.where((g_sk - 1.0) > k(SF_E_REL),
                                (g_sk - 1.0) * e0 * st["weight"],
                                pt_sk * pt_sk / (2.0 * m) * st["weight"])
            tiny37 = k(SF_TINY37)
            ip = mom_bin(pt_sk, k(SF_LOG_PMIN), tb.bins_per_dec_mom,
                         tb.n_mom, k(SF_PSD_MOM_MIN), log10, tiny37)
            jt = angle_bin(px_sk, pt_sk, k(SF_COS_FINE), k(SF_DCOS),
                           k(SF_THETA_MIN), k(SF_LOG_TMIN),
                           tb.bins_per_dec_theta, tb.n_theta, log10,
                           tiny37)
            cell = ((ip * 2 + (~injf).to(torch.int64)) * (tb.n_theta + 1)
                    + jt)
            deposit(tl, nb + 1, crossed, moved_down, injf, lo_c.long(),
                    hi_c.long(), st["weight"], px_sk, pz_sk, inv_vx, e_add,
                    k(SF_G0U0), cell)
            esc_cross = moving & injf & (x < feb_up) & (x_old >= feb_up)
            esc_up = [torch.where(esc_cross, -px_sk * st["weight"]
                                  * k(SF_G0U0), 0.0).to(F64).sum(),
                      torch.where(esc_cross, e_add * k(SF_G0U0), 0.0).to(
                          F64).sum()]

        if xfer_on:
            hi_t = torch.clamp(hi_c, max=tb.i_shock)
            xfer = crossed & ~injf & (x_old <= 0.0) & (hi_t >= lo_c)
            if is_el:
                gain = (tb.rp[hi_t + 1] - tb.rp[lo_c]).to(dt) * ewf
                g_f = torch.where(xfer & (gain > 0.0), gamma_pf + gain / e0,
                                  gamma_pf)
            else:
                eps_stop, eps_start = tb.et[hi_t], tb.et[igc]
                g_f = 1.0 + (gamma_pf - 1.0) * (1.0 - eps_stop) \
                    / torch.maximum(1.0 - eps_start, tiny30)
                g_f = torch.where(xfer & (eps_stop > 0.0),
                                  torch.clamp(g_f, min=1.0), gamma_pf)
            scale = (torch.sqrt(torch.clamp(g_f * g_f - 1.0, min=0.0))
                     / torch.maximum(torch.sqrt(torch.clamp(
                         gamma_pf * gamma_pf - 1.0, min=0.0)), tiny30))
            scale = torch.where(xfer & (g_f != gamma_pf), scale, one)
            pb, pperp = pb * scale, pperp * scale
            ptot = hyp(pb, pperp)
            gamma_pf = hyp(ptot / mc, one)

        jret_new = torch.zeros_like(jret)
        if is_el:
            v_fac = torch.where(
                ptot < pe_crit,
                (pe_crit * c * gden) * pe_crit / (m * gamma_e_crit * u2),
                (ptot * c * gden) * ptot / (m * gamma_pf * u2))
        else:
            v_fac = (ptot * c * gden) * ptot / (m * gamma_pf * u2)
        l_diff = eta3 * v_fac
        esc_feb_dw = moving & (feb_dw > 0.0) & (x > feb_dw)
        esc_far = (moving & ~esc_feb_dw & (x > 1.1 * prp)
                   & (x > (6.91 * l_diff).to(F64)))
        do_ret = moving & ~esc_feb_dw & ~esc_far
        past_end = do_ret & (x >= x_stop)
        just_end = past_end & (x_old < x_stop)
        r_g2 = ptot * c
        if eps_b:
            r_g2 = r_g2 * decay(x)
        r_g2 = r_g2 * inv_q / bmag2
        l_diff2 = eta3 * r_g2 * ptot / (m * gamma_pf * u2)
        prp = torch.where(just_end, x + (3.0 * l_diff2).to(F64), prp)

        crossed_prp = past_end & ~just_end & (x_old < prp) & (x >= prp)
        vt = ptot / (gamma_pf * m)
        q_ret = (vt - u2) / (vt + u2)
        no_ret = crossed_prp & ((vt < u2) | (u[2] > q_ret * q_ret))
        status = torch.where(no_ret, FINISHED, status)
        reason = torch.where(no_ret, R_DOWNSTREAM, reason)
        returns = crossed_prp & ~no_ret
        if tl is not None and do_retro:
            tl["retro"].add_(returns.sum().to(F64))
        if do_retro:
            retro = retro | returns
        else:
            vmu = u2 - (u2 + vt) * torch.sqrt(u[3])
            mu = torch.clamp(vmu / torch.maximum(vt, tiny30), -1.0, 1.0)
            pb_ret = ptot * mu
            pperp_ret = torch.sqrt(torch.clamp(ptot * ptot - pb_ret * pb_ret,
                                               min=0.0))
            pb = torch.where(returns, pb_ret, pb)
            pperp = torch.where(returns, pperp_ret, pperp)
            jret_new = jret_new | returns
        phi = torch.where(returns, u[4] * two_pi, phi)
        x = torch.where(returns, prp, x)

        if is_el:
            idle = past_end & ~just_end & ~crossed_prp
            check = idle & (ptot < pcut_prev) & (nsteps % 1000 == 0)
            l_d = eta3 * (ptot * c * gden) * ptot / (m * gamma_pf * u2)
            ratio = pcut_prev / torch.maximum(ptot, tiny30)
            r2 = ratio * ratio
            shrink = torch.where(
                x > (2.0e3 * l_d).to(F64), 0.8 * x,
                torch.minimum(prp, x_stop + (l_d * (ratio * (r2 * r2))).to(
                    F64)))
            prp = torch.where(check, shrink, prp)

        esc = esc_feb_dw | esc_far
        status = torch.where(esc, FINISHED, status)
        reason = torch.where(esc, R_DOWNSTREAM, reason)
        if tl is not None:
            tl["esc"].add_(torch.stack(esc_up + list(_esc_dw(
                moving, status, reason, ptot, gamma_pf, m, e0, k(SF_THREE),
                k(SF_E_REL), st["weight"]))))

        if do_retro:
            in_retro = act & retro
            b2 = b_dw * decay(x) if eps_b else b_dw
            gden_r = inv_q / b2
            ptot_r = hyp(pb, pperp)
            gamma_r = hyp(ptot_r / mc, one)
            t_fac = two_pi * mc * gden_r / ten
            t_step_r = t_fac * gamma_r
            x_try = x + (gsf_dw * (pb * t_fac / m
                                   + (-ux_dw) * t_step_r)).to(F64)
            acct = acct + torch.where(in_retro, t_step_r * gef_dw,
                                      0.0).to(F64)
            if do_tcuts:
                fire_r = in_retro & (acct >= tcut_time(tcut))
                tcut = torch.where(fire_r, tcut + 1, tcut)
            phi_las = two_pi * u[0]
            mu_las = 2.0 * u[1] - 1.0
            p_new = ptot_r
            if rad_on:
                b_cmb = b_cmbz * gef_dw
                p_new = radiation_loss(b2 * b2 + b_cmb * b_cmb, ptot_r,
                                       t_step_r, rad)
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

        nsteps = nsteps + act.to(i32)
        capped = (status == ACTIVE) & (nsteps >= max_helix)
        status = torch.where(capped, FINISHED, status)
        reason = torch.where(capped, R_DOWNSTREAM, reason)
        new_flags = (dwf.to(i32) * FL_DW | injf.to(i32) * FL_INJ
                     | retro.to(i32) * FL_RETRO
                     | jret_new.to(i32) * FL_JRET)
        flags = torch.where(act, new_flags, flags).to(i32)

    st.update(pb=pb, pperp=pperp, phi=phi, ux_prev=uxp, xn_per=xnp,
              t_step=tstep, prp_x=prp, x=x, acctime=acct, tcut=tcut,
              status=status, reason=reason, nsteps=nsteps, flags=flags)
