"""The electron SED deployment's own numbers for ``correct``: its photons
and the electrons' ISM-frame d2N they are made from.

A plain reference of the emission pass of an iteration (the upstream
code's photon_calcs.jl:27-161 and get_summed_emission.jl), worked out
stage by stage from what a run hands it: every species' normalized
dN/dp (thermal plus CR, plasma frame) and the electrons' ISM-frame
d2N/(dp dcos) (``IterationResult.ion_finals``), the iteration's shock
profile (its B-field and the Lorentz factors of its zones), the momentum
and angle bins, the shells and the redshift (``setup``).  Each zone is
worked out on its own, in a loop:

* synchrotron (photon_synch.jl, synch_emission.jl:28-171): R&L Eq 6.18's
  prefactor without sin(alpha), omega_c = 3 gamma^2 q B / (2 m c), the
  kernel F(x) = x int_x^inf K_5/3, dP/dlnE = N omega p_fac F summed over
  the electron bins of 3 MeV and more, in the plasma frame;
* inverse Compton off the CMB (inverse_compton.jl:191-383): the
  blackbody at T(1 + z) in 60 log bins over [nu_peak/30, 20 nu_peak],
  the electrons inside the jet's cone (the pitch cut), Jones (1968)
  Eq 9 for each (electron bin, seed bin, outgoing bin) term, terms of
  1e-60 and less dropped, the flux over the jet's beam area, in the ISM
  frame;
* pi0 decay (pion_kafexhiu.jl:36-245 with KATV2014.jl:22-296, Kafexhiu
  et al. 2014, GEANT4 fits): sigma_pi, Amax, E_gamma^max and F(Tp, Eg)
  for every proton bin above threshold, the target density the zone's
  compression of the far-upstream density, the A^0.375 scaling of
  Baring et al. 1999 Eq 26, in the plasma frame;
* the sum (get_summed_emission.jl:91-200, 249-310, 789-806): pion and
  synchrotron spectra Doppler-shifted to the ISM frame over 180 cosine
  slices with gamma^3, re-binned on the same log grid; zones summed
  into shells; the three processes merged onto the 1e-13 to 1e12 MeV
  grid; the flux at Earth over 4 pi d_L^2;
* the electrons' ISM-frame d2N (``d2n_ef``: get_dNdp_2D,
  particle_counter.jl:343-613) from their PSD tallies.

Departures from upstream, each as the port documents it
(montecarloscattering_jl_tpu_torch/models/emission):

* F(x) comes from a table of 400 points log-spaced over [1e-15, 30]
  (ln F linear in ln x, 0 outside), each point a trapezoid of K_5/3
  over 4,000 log-spaced points from x to 120, where upstream calls
  SynchrotronKernel.jl.  K_5/3 itself is evaluated here from its
  integral representation int_0^inf exp(-t cosh u) cosh(5u/3) du (no
  SciPy);
* the thermal and CR counts of a zone are summed before the kernels
  (upstream loops over the thermal bins, then the CR ones: the same
  sum);
* synchrotron self-Compton is not modelled (this configuration leaves
  ``calculate-ssc`` off).

The numbers (``read``), each the widest gap of an array from the
reference's, over the array's largest entry (``d2n_gap``: over the
zone's):

* ``synch_gap``, ``ic_gap``, ``pion_gap``: each process's summed
  ISM-frame spectrum of every shell (``EmissionResult.*_shell``) and its
  per-zone spectrum (``*_grid``);
* ``photon_tot_gap``: the merged total (``tot_shell`` and ``tot``);
* ``d2n_gap``: every species' ISM-frame d2N (``IonFinal.d2n_ef``, the IC
  pass's input) against the reference's from the species' own PSD
  tallies of the iteration (``psd``, ``therm_psd``, ``num_crossings``),
  zone by zone: the zones' scales span some 60 decades, so a zone held
  to the whole array's largest entry would go unseen;
* ``photon_file_gap``: every ``photon_*.dat`` the run wrote in
  `out_dir`, each value against the reference's: the widest gap of a
  log10 value over the value's size (at least 1), as the shared
  ``file_gap``; MISSING where a file is missing or holds other rows.

With `low` (a torch dtype) the reference computed in that precision
takes the program's place: its arrays, and the files written from them
with the writer's five decimals (the control).

Each zone's spectra are computed on magnitudes scaled to their largest
(the CGS counts reach 1e134): the scale is a float64 factor, the
arithmetic in the precision asked for.  Plain torch and NumPy, float64
by default; it imports nothing of the port or of JAX (the zones'
populations come from benchmark/harness/reference.py, loaded by path).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

# PERF.md section 2 gives the readings each limit was set from
LIMITS = {"float64": {"synch_gap": 1.0e-9, "ic_gap": 1.0e-9,
                      "pion_gap": 1.0e-9, "photon_tot_gap": 1.0e-9,
                      "d2n_gap": 1.0e-9, "photon_file_gap": 2.0e-5}}
# the gap of arrays of another shape or with a value not finite
MISSING = 1.0e9

# CGS constants (CODATA 2018) and the upstream code's own
C = 2.99792458e10
M_E = 9.1093837015e-28
M_P = 1.67262192369e-24
Q_E = 4.80320471257e-10
K_B = 1.380649e-16
H_P = 6.62607015e-27
HBAR = 1.054571817e-27
MEV = 1.602176634e-6
GEV = 1.602176634e-3
MPC = 1.0e6 * 3.0856775814913673e18
ME_C2 = M_E * C ** 2
T_CMB0 = 2.725
E_REL_PT = 0.005
# Kafexhiu et al. 2014, in GeV
T_TH = 0.2797
M_RES = 1.1883
G_RES = 0.2264
M_PI = 0.134976
M_P_GEV = M_P * C ** 2 / GEV
MB = 1.0e-27

# photon grids (photon_calcs.jl:10-19), MeV, 10 bins a decade
E_MIN, E_MAX, PER_DEC = 1.0e-13, 1.0e12, 10
E_PION_MIN, E_SYNCH_MAX, E_IC_MIN = 1.0, 1.0e5, 1.0e-2
N_COS = 180
X_MIN, X_MAX, N_F = 1.0e-15, 30.0, 400
WIEN_NU = 5.879e10


def _n(emin, emax) -> int:
    return int(math.log10(emax / emin) * PER_DEC)


def _grid(emin_mev, n) -> np.ndarray:
    return 10.0 ** (math.log10(emin_mev * MEV) + np.arange(n) / PER_DEC)


def k53(t: np.ndarray) -> np.ndarray:
    """K_5/3(t) from int_0^inf exp(-t cosh u) cosh(5u/3) du, a
    trapezoid of step 0.1 in u out to where the integrand is below
    e^-800 of its size: for this analytic, doubly decaying integrand the
    rule is exact to rounding (3.6e-15 in ln F against SciPy's kv)."""
    t = torch.as_tensor(np.asarray(t, np.float64))
    top = float(math.log(240.0 / min(float(t.min()), 1.0)) + 2.0)
    u = torch.arange(0.0, top + 0.1, 0.1, dtype=torch.float64)
    out = []
    for tt in t.reshape(-1).split(8192):
        f = torch.exp(-tt[:, None] * torch.cosh(u) + 5.0 / 3.0 * u) * 0.5 \
            * (1.0 + torch.exp(-10.0 / 3.0 * u))
        out.append(0.1 * (f.sum(dim=1) - 0.5 * f[:, 0]))
    return torch.cat(out).reshape(t.shape).numpy()


_F = None


def f_table():
    """(ln x, ln F) of the 400-point table of F(x) over [1e-15, 30]."""
    global _F
    if _F is None:
        xs = np.logspace(math.log10(X_MIN), math.log10(X_MAX), N_F)
        fs = np.empty(N_F)
        for i, x in enumerate(xs):
            t = np.geomspace(x, 120.0, 4000)
            k = k53(t)
            fs[i] = x * float(np.sum((k[1:] + k[:-1]) * np.diff(t)) / 2.0)
        _F = (np.log(xs), np.log(np.maximum(fs, 1e-300)))
    return _F


def interp(x, xp, fp):
    """Linear interpolation, held at the ends."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.numel() - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class _Pass:
    """What every zone's kernels share: dtype, device, grids."""

    def __init__(self, setup, dt, dev):
        self.dt, self.dev = dt, torch.device(dev)
        bins, cfg = setup.bins, setup.cfg
        self.p_edges = 10.0 ** np.asarray(bins.mom_bounds_log, np.float64)
        self.dp = np.diff(self.p_edges)
        self.e_pion = _grid(E_PION_MIN, _n(E_PION_MIN, E_MAX))
        self.e_synch = _grid(E_MIN, _n(E_MIN, E_SYNCH_MAX))
        self.e_ic = _grid(E_IC_MIN, _n(E_IC_MIN, E_MAX))
        self.e_tot = _grid(E_MIN, _n(E_MIN, E_MAX))
        d_l = cfg.jet_dist_mpc * (1.0 + setup.redshift) * MPC
        self.flux_fac = 1.0 / (4.0 * math.pi * d_l ** 2)
        self.beam_area = 4.0 * math.pi * d_l ** 2 * max(cfg.jet_sph_frac,
                                                        1e-12)
        tb = np.asarray(bins.theta_bounds, np.float64)
        j = np.arange(bins.n_theta + 2)
        cos_b = np.where(j > bins.n_theta - bins.lin_cos_bins, -tb,
                         -np.cos(tb))
        self.jt_max = max(int(np.searchsorted(
            cos_b, 2.0 * cfg.jet_sph_frac - 1.0)), 1)
        self.seed = self.cmb(setup.redshift)

    def t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            self.dev, self.dt)

    @staticmethod
    def back(a) -> np.ndarray:
        return a.to("cpu", torch.float64).numpy()

    def cmb(self, z):
        """(E / m_e c^2, photons per cm^3) of each of the 60 seed bins."""
        temp = T_CMB0 * (1.0 + z)
        nu_pk = WIEN_NU * temp
        lg = np.linspace(math.log10(nu_pk / 30.0), math.log10(nu_pk * 20.0),
                         61)
        nu1, nu2 = 10.0 ** lg[:-1], 10.0 ** lg[1:]
        nu = np.sqrt(nu1 * nu2)
        u_nu = ((nu2 - nu1) * 8.0 * math.pi * H_P / C ** 3 * nu ** 3
                / (np.exp(np.minimum(H_P * nu / (K_B * temp), 200.0)) - 1.0))
        return H_P * nu / ME_C2, u_nu / (H_P * nu)

    # -- the three processes, one zone each: float64 results ----------

    def synch(self, counts, bmag):
        """dP/dlnE [erg/s] of one zone's electrons (counts a bin)."""
        e_g = self.e_synch
        scale = counts.max()
        if bmag < 1.0e-20 or scale <= 0:
            return np.full(len(e_g), 1.0e-99)
        t = self.t
        mc = M_E * C
        pe = t(self.p_edges)
        p = torch.sqrt(pe[:-1] * pe[1:])
        gam = torch.sqrt((p / mc) ** 2 + 1.0)
        b = t(bmag)
        p_fac = (math.sqrt(3.0) / (2.0 * math.pi) * Q_E ** 3 * b
                 / (M_E * C ** 2))
        omega_c = 3.0 * gam ** 2 * Q_E * b / (2.0 * mc)
        w = t(counts / scale)
        keep = ((w > 1.0e-60 / scale) & (p * C >= 3.0 * MEV)
                & (omega_c >= 1.0e-55))
        if not bool(keep.any()):
            return np.full(len(e_g), 1.0e-99)
        omega_g = t(e_g / HBAR)
        x = omega_g[None, :] / omega_c[keep][:, None]
        lx, lf = (t(a) for a in f_table())
        f = torch.exp(interp(torch.log(x.clamp(min=X_MIN)), lx, lf))
        f = torch.where((x >= X_MAX) | (x < X_MIN), 0.0, f)
        emis = (w[keep][:, None] * omega_g[None, :] * p_fac * f).sum(0)
        return np.maximum(self.back(emis) * scale, 1.0e-99)

    def ic(self, n_e, mc):
        """Observed IC flux [erg/(s cm^2)] a log bin of one zone's
        electrons in the cone (n_e: counts a momentum bin)."""
        alpha = self.e_ic / ME_C2
        scale = n_e.max()
        if not scale > 1.0e-99:
            return np.full(len(alpha), 1.0e-99)
        t = self.t
        pe = t(self.p_edges)
        pm = torch.sqrt(pe[:-1] * pe[1:]) / mc
        gam = torch.where(pm < E_REL_PT, 1.0, torch.sqrt(pm ** 2 + 1.0))
        w = t(n_e / scale)
        keep = w > 1.0e-99 / scale
        w, g = w[keep][:, None, None], gam[keep][:, None, None]
        a1, n_ph = (t(a)[None, :, None] for a in self.seed)
        al = t(alpha)[None, None, :]
        r0 = Q_E ** 2 / ME_C2
        q = al / (4.0 * a1 * g ** 2 * (1.0 - al / g))
        brack = (2.0 * q * torch.log(q) + (1.0 + 2.0 * q) * (1.0 - q)
                 + 8.0 * (a1 * g * q) ** 2 * (1.0 - q)
                 / (1.0 + 4.0 * a1 * g * q))
        term = n_ph * 2.0 * math.pi * r0 ** 2 * C / (a1 * g ** 2) * w * brack
        term = torch.where((al < g) & (q > 0) & (q <= 1.0)
                           & torch.isfinite(term)
                           & (term > 1.0e-60 / scale), term, 0.0)
        per_e = term.sum(dim=(0, 1)) * t(alpha) ** 2 * ME_C2
        emis = self.back(per_e) * scale / self.beam_area
        return np.where(emis <= 1.0e-55, 1.0e-99, emis)

    def pion(self, counts, target, aa, mc, scaling):
        """dP/dlnE [erg/s] of pi0-decay photons of one zone's ions."""
        e_g = self.e_pion
        scale = counts.max()
        if not scale > 0:
            return np.full(len(e_g), 1.0e-99)
        t = self.t
        pe = t(self.p_edges)
        p2 = pe[:-1] * pe[1:]
        gam = torch.sqrt(1.0 + p2 / mc ** 2)
        tp = (gam - 1.0) * mc * C / GEV / aa
        vel = torch.sqrt(p2) / (gam * (mc / C))
        w = t(counts / scale)
        keep = (w > 1.0e-99 / scale) & (tp >= T_TH)
        if not bool(keep.any()):
            return np.full(len(e_g), 1.0e-99)
        tp, vel, w = tp[keep], vel[keep], w[keep]
        sig = sigma_pi(tp)
        eg_max, amax = amax_egmax(tp, sig)
        eg = t(e_g / GEV)
        ff = f_shape(tp, eg, eg_max)
        rate = (target * w[:, None] * vel[:, None] * amax[:, None] * ff
                * eg[None, :] * MB)
        emis = self.back((rate * t(e_g)[None, :]).sum(0)) * scale
        return np.where(emis < 1.0e-99, 1.0e-99, emis * scaling)

    def doppler(self, col, e_g, beta, gamma):
        """One zone's plasma-frame spectrum in the ISM frame: 180 cosine
        slices, each shifted by gamma sqrt((1 - b c_l)(1 - b c_l+1)),
        re-binned on the same log grid, times gamma^3; 0 for a zone
        without photons."""
        n_g = len(e_g)
        counts = col / e_g
        scale = counts.max()
        if scale <= 1.0e-90:
            return np.zeros(n_g)
        t = self.t
        log_e = torch.log(t(e_g))
        dlog = log_e[1] - log_e[0]
        cb = t(np.linspace(-1.0, 1.0, N_COS + 1))
        dim = torch.sqrt((1.0 - beta * cb[:-1]) * (1.0 - beta * cb[1:]))
        shift = torch.log(gamma * dim)
        idx = torch.floor((log_e[:, None] + shift[None, :] - log_e[0])
                          / dlog + 1.0e-9).long().clamp(0, n_g - 1)
        e_new = t(e_g)[:, None] * gamma * dim[None, :]
        contrib = (t(counts / scale)[:, None] * (1.0 / N_COS) * gamma ** 3
                   * e_new)
        out = torch.zeros(n_g, dtype=self.dt, device=self.dev)
        out.index_add_(0, idx.reshape(-1), contrib.reshape(-1))
        return self.back(out) * scale

    def sum_shells(self, grid, ends):
        scale = np.abs(grid).max()
        g = self.t(grid / scale if scale > 0 else grid)
        out = torch.stack([g[:, a:b].sum(dim=1)
                           for a, b in zip(ends[:-1], ends[1:])], dim=1)
        return self.back(out) * scale


# -- Kafexhiu et al. 2014 (KATV2014.jl), GEANT4 fits (i_data = 1) -------

def sigma_pi(tp):
    """The inclusive pi0 cross section [mb] at proton kinetic energy tp
    [GeV] above threshold."""
    s = 2.0 * M_P_GEV * (tp + 2.0 * M_P_GEV)
    gp = M_RES * math.sqrt(M_RES ** 2 + G_RES ** 2)
    kk = (math.sqrt(8.0) * M_RES * G_RES * gp
          / (math.pi * math.sqrt(M_RES ** 2 + gp)))
    f_bw = M_P_GEV * kk / (((torch.sqrt(s) - M_P_GEV) ** 2 - M_RES ** 2) ** 2
                           + M_RES ** 2 * G_RES ** 2)
    eta = torch.sqrt(torch.clamp(
        (s - M_PI ** 2 - 4.0 * M_P_GEV ** 2) ** 2
        - (4.0 * M_PI * M_P_GEV) ** 2, min=0.0)) / (2.0 * M_PI * torch.sqrt(s))
    one_pi = 7.66e-3 * eta ** 1.95 * (1.0 + eta + eta ** 5) * f_bw ** 1.86
    two_pi = torch.where(tp < 2.0 * T_TH, 0.0,
                         5.7 / (1.0 + torch.exp(-9.3 * (tp - 1.4))))
    ratio = tp / T_TH
    lr = torch.log(ratio)
    inel = ((30.7 - 0.96 * lr + 0.18 * lr ** 2)
            * torch.clamp(1.0 - ratio ** -1.9, min=0.0) ** 3)
    q = (tp - T_TH) / M_P_GEV
    n_mid = -6.0e-3 + 0.237 * q - 0.023 * q ** 2
    xi = torch.clamp((tp - 3.0) / M_P_GEV, min=1e-12)
    n_hi = (0.728 * xi ** 0.2503 * (1.0 + torch.exp(-0.596 * xi ** 0.117))
            * (1.0 - torch.exp(-0.491 * xi ** 0.25)))
    return torch.where(tp < 2.0, one_pi + two_pi,
                       torch.where(tp < 5.0, n_mid, n_hi) * inel)


def amax_egmax(tp, sig):
    """(E_gamma^max [GeV], Amax [mb/GeV])."""
    s = 2.0 * M_P_GEV * (tp + 2.0 * M_P_GEV)
    rs = torch.sqrt(s)
    e_pi = (s - 4.0 * M_P_GEV ** 2 + M_PI ** 2) / (2.0 * rs)
    g_cm = (tp + 2.0 * M_P_GEV) / rs
    b_cm = torch.sqrt(torch.clamp(1.0 - 1.0 / g_cm ** 2, min=0.0))
    p_pi = torch.sqrt(torch.clamp(e_pi ** 2 - M_PI ** 2, min=0.0))
    e_pi_max = g_cm * (e_pi + p_pi * b_cm)
    g_lab = torch.clamp(e_pi_max / M_PI, min=1.0 + 1e-12)
    b_lab = torch.sqrt(torch.clamp(1.0 - 1.0 / g_lab ** 2, min=0.0))
    eg_max = M_PI / 2.0 * g_lab * (1.0 + b_lab)
    theta = tp / M_P_GEV
    lt = torch.log(theta)

    def form(b1, b2, b3):
        return b1 * theta ** -b2 * sig / M_P_GEV * torch.exp(b3 * lt ** 2)

    amax = torch.where(tp < 1.0, 5.9 * sig / e_pi_max,
                       torch.where(tp < 5.0, form(9.53, 0.52, 0.054),
                                   form(9.13, 0.35, 0.0097)))
    return eg_max, amax


def f_shape(tp, eg, eg_max):
    """F(Tp, E_gamma), [n_p, n_g]."""
    tp, egm, eg = tp[:, None], eg_max[:, None], eg[None, :]
    y = eg + M_PI ** 2 / (4.0 * eg)
    y_max = egm + M_PI ** 2 / (4.0 * egm)
    x = (y - M_PI) / (y_max - M_PI)
    theta = tp / M_P_GEV
    xc = torch.clamp(x, 0.0, 1.0)
    low = (1.0 - xc) ** (3.29 - 0.2 * theta ** -1.5)
    q = torch.clamp((tp - 1.0) / M_P_GEV, min=0.0)
    mu = 1.25 * q ** 1.25 * torch.exp(-1.25 * q)

    def par(lam, alpha, beta, gam):
        c = lam * M_PI / y_max
        return (torch.clamp(1.0 - xc ** alpha, min=0.0) ** beta
                / (1.0 + xc / c) ** gam)

    f = torch.where(tp < 1.0, low, torch.where(
        tp < 4.0, par(3.0, 1.0, mu + 2.45, mu + 1.45), torch.where(
            tp < 20.0, par(3.0, 1.0, 1.5 * mu + 4.95, mu + 1.5),
            torch.where(tp > 100.0, par(3.0, 0.5, 4.9, 1.0),
                        par(3.0, 0.5, 4.2, 1.0)))))
    return torch.where((x < 0) | (x > 1) | ~torch.isfinite(x), 0.0, f)


# -- the pass --------------------------------------------------------------

def emission(setup, prof, ion_finals, dtype=torch.float64, device="cpu"
             ) -> dict:
    """The reference's spectra of one iteration: per-zone plasma-frame
    (pion, synchrotron) or ISM-frame (IC) grids [n_g, nb], their
    shells [n_g, n_shells] in the ISM frame, the merged total per shell
    and summed, and the photon grids [erg]."""
    cfg = setup.cfg
    z = _Pass(setup, dtype, device)
    nb = setup.nb
    ends = [int(e) for e in setup.n_shell_endpoints]
    aa_ion = [s.aa for s in cfg.species]
    n0 = [s.number_density for s in cfg.species]
    grid = {"pion": np.full((len(z.e_pion), nb), 1e-99),
            "synch": np.full((len(z.e_synch), nb), 1e-99),
            "ic": np.full((len(z.e_ic), nb), 1e-99)}
    for i_ion, fi in enumerate(ion_finals):
        s = cfg.species[i_ion]
        for n in range(ends[0], ends[-1]):
            counts = (np.asarray(fi.dndp_therm[:, n, 1], np.float64)
                      + np.asarray(fi.dndp_cr[:, n, 1], np.float64)) * z.dp
            if s.aa >= 1:
                if counts.max() <= 1e-90:
                    continue
                gb = math.sqrt(max(prof.gamma_sf[n] ** 2 - 1.0, 1e-30))
                scaling = sum((s.aa ** 0.375 + a ** 0.375 - 1.0) ** 2
                              * d / n0[0] for a, d in zip(aa_ion, n0)
                              if a >= 1)
                emis = z.pion(counts,
                              float(n0[0] * cfg.gamma0 * cfg.beta0 / gb),
                              s.aa, s.mass * C, scaling)
                grid["pion"][:, n] = (np.maximum(grid["pion"][:, n], 0.0)
                                      + emis * z.flux_fac)
                continue
            if counts.max() > 1e-90:
                grid["synch"][:, n] += z.synch(counts, float(prof.btot[n])) \
                    * z.flux_fac
            if fi.d2n_ef is None:
                continue
            d2n = np.asarray(fi.d2n_ef[:, :, n], np.float64) * z.dp[:, None]
            if d2n.max() <= 1e-90:
                continue
            grid["ic"][:, n] += z.ic(d2n[:, :z.jt_max].sum(axis=1),
                                     s.mass * C)
    out = {"e_pion": z.e_pion, "e_synch": z.e_synch, "e_ic": z.e_ic,
           "e_tot": z.e_tot}
    for k, e_g in (("pion", z.e_pion), ("synch", z.e_synch)):
        ism = np.stack([z.doppler(grid[k][:, n], e_g, float(prof.beta_ef[n]),
                                  float(prof.gamma_ef[n]))
                        for n in range(nb)],
                       axis=1)
        out[k + "_shell"] = z.sum_shells(ism, ends)
    out["ic_shell"] = z.sum_shells(grid["ic"], ends)
    for k in grid:
        out[k + "_grid"] = grid[k]
    tot = np.zeros((len(z.e_tot), len(ends) - 1))
    for k, emin in (("pion", E_PION_MIN), ("synch", E_MIN), ("ic", E_IC_MIN)):
        a = out[k + "_shell"]
        o = int(round(math.log10(emin / E_MIN) * PER_DEC))
        m = min(a.shape[0], len(z.e_tot) - o)
        tot[o:o + m] += np.where(a[:m] > 1e-90, a[:m], 0.0)
    out["tot_shell"] = tot
    out["tot"] = tot.sum(axis=1)
    return out


# -- the electrons' ISM-frame d2N (get_dNdp_2D, particle_counter.jl:343-613)

def bin_momentum(p, bins):
    """The PSD's momentum bin of each momentum (get_psd_bins.jl:16-39)."""
    lg = np.log10(np.maximum(p, 1e-300)) - math.log10(bins.psd_mom_min)
    b = np.floor(lg * bins.bins_per_dec_mom).astype(np.int64) + 1
    return np.clip(np.where(p < bins.psd_mom_min, 0, b), 0, bins.n_mom)


def bin_angle(px, p, bins):
    """The PSD's angle bin of each (px, p) (get_psd_bins.jl:73-97): the
    negative pitch cosine, log-theta bins above ``cos_fine``, linear
    cosine bins below."""
    c = np.clip(-px / np.maximum(p, 1e-300), -1.0, 1.0)
    n = bins.n_theta
    lin = n - np.floor((c + 1.0) / bins.dcos).astype(np.int64)
    th = np.arccos(c)
    lg = np.floor((np.log10(np.maximum(th, 1e-300))
                   - math.log10(bins.theta_min))
                  * bins.bins_per_dec_theta).astype(np.int64) + 1
    lg = np.where(th < bins.theta_min, 0, lg)
    b = np.where(c < bins.cos_fine, lin, lg)
    return np.clip(np.where(p <= 0.0, 0, b), 0, n)


def cos_centers(bins) -> np.ndarray:
    """The pitch cosine at the middle of each angle bin, sign flipped as
    the bins index -cos (particle_counter.jl:618-644)."""
    tb, n = np.asarray(bins.theta_bounds, np.float64), bins.n_theta
    out = np.zeros(n + 1)
    for j in range(n + 1):
        lo = tb[j + 1] if j >= n - bins.lin_cos_bins else math.cos(tb[j + 1])
        hi = tb[j] if j > n - bins.lin_cos_bins else math.cos(tb[j])
        out[j] = -(lo + hi) / 2.0
    return out


def _harness_reference():
    """benchmark/harness/reference.py (the shared check's plain dN/dp
    reference: the zones' populations), loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "harness", "reference.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_harness_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def d2n_ef(setup, prof, fi, s, dtype=torch.float64):
    """The electrons' ISM-frame d2N/(dp dcos) [n_mom+1, n_theta+1, nb]:
    each zone's CR plus thermal PSD scaled to the zone's population
    (its upstream flux times shell area times dwell time; a zone with
    particles and no crossings counts the far-upstream density too),
    each cell's centre boosted by gamma0 along x into the ISM frame and
    its weight moved to the bin the centre lands in, over dp.  The boost
    and the binning in `dtype`; each zone's weights are scaled to their
    largest by a float64 factor (populations reach 1e50)."""
    ref = _harness_reference()
    cfg, bins = setup.cfg, setup.bins
    lg = np.asarray(bins.mom_bounds_log, np.float64)
    edges = 10.0 ** lg
    pop = ref.zone_populations(setup.x_grid_cm, setup.i_shock,
                               s.number_density, cfg.beta0, cfg.gamma0,
                               cfg.jet_rad_pc, cfg.jet_sph_frac, prof.ux_sk)
    tot = np.asarray(fi.psd, np.float64) + np.asarray(fi.therm_psd,
                                                      np.float64)
    n_p, n_t, nb = tot.shape
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dtype)
    p = t(10.0 ** ((lg[:-1] + lg[1:]) / 2.0))[:, None].expand(n_p, n_t)
    px = p * t(cos_centers(bins))[None, :]
    e0 = s.mass * C ** 2
    etot = torch.sqrt((p * C) ** 2 + e0 ** 2)
    px_b = cfg.gamma0 * (px - cfg.beta0 * etot / C)
    p_b = torch.sqrt(torch.clamp(p * p - px * px + px_b * px_b, min=0.0))
    px_b = torch.where(px_b.abs() > p_b, torch.sign(px_b) * p_b, px_b)
    p_b = p_b.to(torch.float64).numpy()
    ip = bin_momentum(p_b, bins).reshape(-1)
    jt = bin_angle(px_b.to(torch.float64).numpy(), p_b, bins).reshape(-1)
    out = np.zeros((n_p, n_t, nb))
    crossed = np.asarray(fi.num_crossings)
    for z in range(nb):
        w = tot[:, :, z]
        dens = w.sum() + (s.number_density
                          if crossed[z] == 0 and w.sum() > 0 else 0.0)
        if not dens > 0:
            continue
        scale = w.max()
        cell = t(w / scale).reshape(-1)
        acc = torch.zeros(n_p * n_t, dtype=dtype).index_add_(
            0, torch.as_tensor(ip * n_t + jt), cell)
        out[:, :, z] = (acc.to(torch.float64).numpy().reshape(n_p, n_t)
                        * scale * (pop[z] / dens))
    return out / np.diff(edges)[:, None, None]


def gap(got, want) -> float:
    """The widest gap of `got` from `want` over the largest entry of
    `want`; MISSING for another shape or a value not finite."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape:
        return MISSING
    scale = np.abs(w).max()
    d = np.abs(g - w).max()
    if not (np.isfinite(d) and np.isfinite(scale)):
        return MISSING
    return float(d / scale if scale > 0 else d)


def zone_gap(got, want) -> float:
    """The widest gap of `got` from `want` in any zone (the last axis)
    over that zone's largest entry of `want` (the whole array's where
    the zone is empty); MISSING for another shape or a value not
    finite."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape:
        return MISSING
    whole = np.abs(w).max()
    out = 0.0
    for z in range(w.shape[-1]):
        scale = np.abs(w[..., z]).max()
        scale = scale if scale > 0 else whole
        d = np.abs(g[..., z] - w[..., z]).max()
        if not (np.isfinite(d) and np.isfinite(scale)):
            return MISSING
        out = max(out, float(d / scale if scale > 0 else d))
    return out


# -- the files (engine/io.py write_photons) --------------------------------

def _lg(x):
    return np.log10(np.maximum(np.asarray(x, np.float64), 1e-99))


def file_rows(sp) -> dict:
    """{file name: rows of numbers} as the run writes them from the
    spectra `sp`."""
    out = {}
    for name, e_key, g_key in (("pion_decay", "e_pion", "pion_grid"),
                               ("synch", "e_synch", "synch_grid"),
                               ("IC", "e_ic", "ic_grid")):
        e = sp[e_key] / MEV
        rows = []
        for i in range(sp[g_key].shape[1]):
            col = sp[g_key][:, i]
            if col.max() <= 1e-90:
                continue
            v = col / MEV
            pf = np.where(v > 1e-99, v / e, 1e-99)
            for j in range(len(e) - 1):
                rows.append([i, _lg(pf[j]), np.log10(e[j]), _lg(v[j]),
                             _lg(pf[j] / e[j])])
        out[f"photon_{name}_grid.dat"] = rows
    for name, e_key, s_key in (("pion", "e_pion", "pion_shell"),
                               ("synch", "e_synch", "synch_shell"),
                               ("IC", "e_ic", "ic_shell"),
                               ("tot", "e_tot", "tot_shell")):
        e = sp[e_key] / MEV
        rows = []
        for n in range(sp[s_key].shape[1]):
            for j in range(len(e) - 1):
                v = sp[s_key][j, n] / MEV
                pf = v / e[j] if v > 1e-99 else 1e-99
                rows.append([n + 1, _lg(pf), np.log10(e[j]), _lg(v)])
        out[f"photon_{name}_summed.dat"] = rows
    e = sp["e_tot"] / MEV
    rows = []
    for j in range(len(e)):
        v = sp["tot"][j] / MEV
        pf = v / e[j] if v > 1e-99 else 1e-99
        rows.append([np.log10(e[j]), _lg(v), _lg(pf)])
    out["photon_tot.dat"] = rows
    return out


def read_rows(path: str) -> list:
    with open(path) as f:
        return [[float(v) for v in line.split()] for line in f
                if line.strip() and not line.startswith("#")]


def rows_gap(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape or g.size == 0:
        return MISSING
    d = float((np.abs(g - w) / np.maximum(np.abs(w), 1.0)).max())
    return d if np.isfinite(d) else MISSING


def files_gap(files: dict, want: dict) -> float:
    out = 0.0
    for name, rows in want.items():
        got = files.get(name)
        out = max(out, MISSING if got is None else rows_gap(got, rows))
    return out


def _profile(result):
    i = len(result.iterations) - 1
    return (result.setup.profile if i == 0
            else result.iterations[i - 1].profile_after)


def read(result, out_dir: str, device, low=None) -> dict:
    """{number: reading} of the run `result` whose files are in
    `out_dir`, against the reference computed in float64 on `device`;
    with `low`, the reference in that precision in the program's
    place."""
    itr = result.iterations[-1]
    args = (result.setup, _profile(result), itr.ion_finals)
    want = emission(*args, torch.float64, device)
    if low is None:
        em = itr.emission
        got = {k: getattr(em, k, None) for k in want}
        files = {}
        for name in file_rows(want):
            path = os.path.join(out_dir, name)
            if os.path.exists(path):
                files[name] = read_rows(path)
    else:
        got = emission(*args, low, device)
        files = {name: np.round(np.asarray(rows, np.float64), 5)
                 for name, rows in file_rows(got).items()}
    if any(got[k] is None for k in want):
        return {}
    g = {k: gap(got[k], want[k]) for k in want}
    d2n = 0.0
    for s, fi in zip(result.setup.cfg.species, itr.ion_finals):
        if fi.d2n_ef is None:
            continue
        ref = d2n_ef(result.setup, args[1], fi, s, torch.float64)
        mine = fi.d2n_ef if low is None else d2n_ef(result.setup, args[1],
                                                     fi, s, low)
        d2n = max(d2n, zone_gap(mine, ref))
    return {"synch_gap": max(g["synch_shell"], g["synch_grid"]),
            "ic_gap": max(g["ic_shell"], g["ic_grid"]),
            "pion_gap": max(g["pion_shell"], g["pion_grid"]),
            "photon_tot_gap": max(g["tot_shell"], g["tot"]),
            "d2n_gap": d2n,
            "photon_file_gap": files_gap(files, file_rows(want))}
