"""The plain reference of the nonlinear smoothing: each iteration's new
shock profile worked out again, in NumPy, from what the iteration
tallied.

Each iteration solves, zone by zone, the momentum and energy
flux-conservation relations for a new flow speed (the reference code's
smoothers.jl:351-570: the relativistic forms above beta0 = 0.02, else
the O(beta^2) forms by Newton's method from a small start), pins the
downstream side, sweeps the profile monotone and smooths it over three
points, rescales it to span u0 -> u2, averages it with the old profile
(old-profile weight, damped up by 1.15 and 1.5 a iteration where the
configuration asks, at most 10), and rebuilds the Lorentz factors and
the field (smoothers.jl:306-346).  A solve whose span vanishes keeps
the old profile.

Its inputs are the iteration's flux tallies (p_xx and energy, summed
over species), the pressures and energy density of the species'
phase-space reductions, the escape fractions averaged over the last
four iterations, the upstream fluxes and the grid, as the program
computed them; the PSD and flux deposits themselves are checked on a
drawn drain (harness/lanes.py) and the dN/dp reductions against
harness/reference.py.  Nothing of the port is imported.
"""

from __future__ import annotations

import math

import numpy as np

C_CGS = 2.99792458e10
MP_CGS = 1.67262192369e-24
BETA_REL_FL = 0.02


def newton(f, x0: float, tol: float = 1.0e-12, max_iter: int = 200):
    """Newton's method on a central difference, stopped where the step
    is within `tol` of max(|x|, 1)."""
    x = float(x0)
    for _ in range(max_iter):
        fx = f(x)
        h = 1.0e-7 * max(abs(x), 1.0e-30)
        d = (f(x + h) - f(x - h)) / (2.0 * h)
        if d == 0.0:
            break
        step = fx / d
        x -= step
        if abs(step) <= tol * max(abs(x), 1.0):
            return x
    return x


def monotone_smooth(y, lo: int, hi: int) -> None:
    """Make y[lo..hi] non-increasing from the downstream end, then
    average over three points, the ends weighted 2:1:1."""
    for i in range(hi, lo, -1):
        y[i - 1] = max(y[i - 1], y[i])
    d = y.copy()
    d[lo + 1] = (2 * y[lo] + y[lo + 1] + y[lo + 2]) / 4.0
    for i in range(lo + 2, hi - 1):
        d[i] = (y[i - 1] + y[i] + y[i + 1]) / 3.0
    d[hi - 1] = (y[hi - 2] + y[hi - 1] + 2 * y[hi]) / 4.0
    y[lo + 1:hi] = d[lo + 1:hi]


def rescale(u, lo: int, hi: int, u0: float, u2: float, x_rg) -> bool:
    """Stretch u[lo..hi] to run from u0 to u2, the downstream mean of
    its last ten zones pinned to u2, downstream of the shock u2; False
    (and u untouched) where the span vanishes."""
    dw = u[hi - 9:hi + 1].mean()
    span = u[lo] - dw
    if abs(span) < 1e-3 * abs(u0 - u2):
        return False
    u[lo:hi + 1] = (u0 - u2) / span * (u[lo:hi + 1] - dw) + u2
    u[lo:hi + 1] = np.where(x_rg[lo:hi + 1] >= 0.0, u2, u[lo:hi + 1])
    return True


def solve(rel: bool, n0, u0, beta0, gamma0, u2, pxx, en, q_px, q_en, x_rg,
          ux, gsf, g_post, btot, theta, omega, p_tot, f_px, f_en, mix):
    """The new flow speed of every inner boundary, or None where the
    rescale is degenerate."""
    nb = ux.shape[0]
    lo, hi = 1, nb - 2
    q_px_flux = q_px * pxx[lo] if rel else 0.0
    q_en_flux = q_en * en[lo]
    u_px, u_en = np.zeros(nb), np.zeros(nb)
    rho0 = n0 * MP_CGS
    for i in range(lo, hi + 1):
        bx = btot[i] * math.cos(theta[i])
        bz = btot[i] * math.sin(theta[i])
        bu = ux[i] / C_CGS
        gb = gsf[i] * bu
        gp = max(g_post[i], 1.0 + 1e-6)
        xi = gp / (gp - 1.0)
        pxx_em = (gb ** 2 * btot[i] ** 2 / (8 * math.pi)
                  + gsf[i] ** 2 * (bz ** 2 - bx ** 2) / (8 * math.pi))
        en_em = gsf[i] ** 2 * bu * bz ** 2 / (4 * math.pi) * C_CGS
        if rel:
            dens = gamma0 * beta0 / gb * n0
            pres = ((1.0 - omega) * (pxx[i] - gb ** 2 * dens * MP_CGS
                                     * C_CGS ** 2) / (1.0 + gb ** 2 * xi)
                    + omega * p_tot[i])
            pres = max(pres, 1e-99)
            coeff = gamma0 * beta0 * n0 * (MP_CGS * C_CGS ** 2
                                           + pres * xi / dens)
            rhs = f_px - q_px_flux - pxx_em - pres
            g1 = max(rhs / coeff if coeff != 0 else gb, 1e-12)
            u_px[i] = g1 / math.sqrt(1.0 + g1 ** 2) * C_CGS
            k = C_CGS * (dens * MP_CGS * C_CGS ** 2 + xi * pres)
            a = (f_en - q_en_flux - en_em) / k if k != 0 else gb
            g2 = (-1.0 + math.sqrt(1.0 + 4.0 * a * a)) / 2.0
            g1 = max(math.sqrt(max(g2, 1e-24)) * math.copysign(1.0, a),
                     1e-12)
            u_en[i] = g1 / math.sqrt(1.0 + g1 ** 2) * C_CGS
        else:
            pres = ((1.0 - omega) * (pxx[i] - rho0 * u0 * ux[i]
                                     * (1.0 + bu ** 2))
                    / (1.0 + bu ** 2 * xi) + omega * p_tot[i])
            pres = max(pres, 1e-99)

            def f_mom(b):
                return (f_px - q_px_flux - pxx_em
                        - rho0 * u0 * b * C_CGS * (1.0 + b ** 2)
                        - (1.0 + b ** 2 * xi) * pres)

            def f_en_(u):
                b = u / C_CGS
                return (f_en - q_en_flux - en_em
                        - 0.5 * rho0 * u0 * u ** 2 * (1.0 + 1.25 * b ** 2)
                        - xi * pres * u * (1.0 + b ** 2))

            u_px[i] = max(newton(f_mom, beta0 * 1.0e-4), 1e-12) * C_CGS
            u_en[i] = max(newton(f_en_, u0 * 1.0e-4), 1.0)
    if rel:
        dw = x_rg[lo:hi + 1] >= 0.0
        for u in (u_px, u_en):
            u[lo:hi + 1] = np.where(dw, u2, u[lo:hi + 1])
            monotone_smooth(u, lo, hi)
        ok = rescale(u_px, lo, hi, u0, u2, x_rg)
        ok &= rescale(u_en, lo, hi, u0, u2, x_rg)
    else:
        ok = rescale(u_px, lo, hi, u0, u2, x_rg)
        ok &= rescale(u_en, lo, hi, u0, u2, x_rg)
        monotone_smooth(u_px, lo, hi)
        monotone_smooth(u_en, lo, hi)
    return (1.0 - mix) * u_px + mix * u_en if ok else None


def b_factor(gamma0, u0, gsf, ux, comp_frac, amp) -> float:
    """Compressed-turbulence field amplification."""
    z = (gamma0 * u0) / (gsf * ux)
    comp = 1.0 + (math.sqrt((1.0 + 2.0 * z ** 2) / 3.0) - 1.0) * comp_frac
    return 1.0 + (comp - 1.0) * amp


def weight_fac(cfg, i_iter: int) -> float:
    """The old profile's weight in iteration `i_iter`."""
    w = cfg.prof_weight_fac
    for i in range(1, i_iter + 1):
        if cfg.do_prof_fac_damp:
            w = min(10.0, w * (1.15 if i < 5 else 1.5))
    return w


def profile(result, i_iter: int, cast=None) -> dict:
    """{"ux_sk", "gamma_sf", "btot"} of the profile after iteration
    `i_iter` of `result`; `cast` rounds every array input (the
    control)."""
    setup, cfg = result.setup, result.setup.cfg
    old = (setup.profile if i_iter == 0
           else result.iterations[i_iter - 1].profile_after)
    itr = result.iterations[i_iter]
    c = (lambda a: np.asarray(a, np.float64)) if cast is None else cast
    ux, gsf = c(old.ux_sk), c(old.gamma_sf)
    btot, theta = c(old.btot), c(old.theta)
    want = {"ux_sk": ux, "gamma_sf": gsf, "btot": btot}
    if not cfg.do_smoothing:
        return want
    fins = itr.ion_finals
    p_par = c(sum(f.p_psd_par for f in fins))
    p_perp = c(sum(f.p_psd_perp for f in fins))
    e_dens = c(sum(f.energy_density_psd for f in fins))
    with np.errstate(divide="ignore", invalid="ignore"):
        g_post = np.where(e_dens <= 1e-90, 1e-99,
                          1.0 + (p_par + p_perp) / e_dens)
    rho0 = sum(sp.number_density * sp.mass for sp in cfg.species)
    x_rg = np.asarray(setup.x_grid_rg, np.float64)
    u0, u2 = cfg.u0, setup.u2
    new = solve(cfg.beta0 >= BETA_REL_FL, rho0 / MP_CGS, u0, cfg.beta0,
                cfg.gamma0, u2, c(itr.tallies.pxx_flux),
                c(itr.tallies.energy_flux), itr.q_esc_px, itr.q_esc_en,
                x_rg, ux, gsf, g_post, btot, theta,
                cfg.smooth_pressure_flux_psd_fac, p_par + p_perp,
                setup.f_px_upstream, setup.f_energy_upstream,
                cfg.smooth_mom_energy_fac)
    if new is None:
        return want
    nb = new.shape[0]
    if cfg.x_art_start_rg < 0:
        i0 = int(np.searchsorted(x_rg, cfg.x_art_start_rg)) - 1
        fac = -(new[i0] - new[nb - 2]) / math.atan(x_rg[i0])
        for i in range(i0, setup.i_shock + 1):
            new[i] = -math.atan(x_rg[i]) * fac + new[nb - 2]
    w = weight_fac(cfg, i_iter)
    new[1:nb - 1] = (new[1:nb - 1] + w * ux[1:nb - 1]) / (1.0 + w)
    new[0], new[nb - 1] = new[1], new[nb - 2]
    g_new = 1.0 / np.sqrt(np.maximum(1.0 - (new / C_CGS) ** 2, 1e-30))
    b_new = np.array([cfg.bmag0 * b_factor(
        cfg.gamma0, u0, g_new[i], new[i], cfg.bturb_comp_frac,
        cfg.bfield_amp) for i in range(nb)])
    if cfg.use_custom_eps_b:
        e_rest = rho0 * C_CGS ** 2
        f_px, f_en = setup.f_px_upstream, setup.f_energy_upstream
        e_d = (f_en + cfg.gamma0 * u0 * e_rest) / new - f_px
        b_new = np.sqrt(np.maximum(8 * math.pi * c(old.eps_b) * e_d, 0.0))
    return {"ux_sk": new, "gamma_sf": g_new, "btot": b_new}


def gap(result, cast=None) -> float:
    """``smooth_gap``: over every iteration, the widest gap of the
    profile the program went on with (flow speed, gamma - 1 of the flow,
    field) from the reference's, over the largest entry of the
    reference's; with `cast` the reference with its inputs rounded is
    judged in the program's place (the control)."""
    out = 0.0
    for i, itr in enumerate(result.iterations):
        want = profile(result, i)
        if cast is None:
            p = itr.profile_after
            got = {"ux_sk": p.ux_sk, "gamma_sf": p.gamma_sf, "btot": p.btot}
        else:
            got = profile(result, i, cast)
        for f, w in want.items():
            w = np.asarray(w, np.float64)
            g = np.asarray(got[f], np.float64)
            if f == "gamma_sf":
                w, g = w - 1.0, g - 1.0
            scale = np.abs(w).max()
            d = np.abs(g - w).max()
            if not (np.isfinite(d) and np.isfinite(scale)):
                return math.inf
            out = max(out, float(d / scale if scale > 0 else d))
    return out
