"""Flagship single-card run: relativistic p+e shock with the full
multi-messenger SED (BASELINE.md configs 3+4).

Counterpart of scripts/flagship_sed.py of the JAX package:
examples/04_hadronic_sed.toml (gamma0 = 5, protons and electrons,
radiative losses, 9 pcuts, synchrotron + IC + pion photon production)
with ``--per-pcut`` particles at every pcut, float32 momenta (the
transport runs on K1) unless ``--f64``, from config to the photon
files, followed by two physics checks on the result: the SED is not
empty, and L_synch / L_IC lies within a factor 30 of U_B / U_CMB.

Usage:

    python -m montecarloscattering_jl_tpu_torch.scripts.flagship_sed \\
        [--per-pcut 16384] [--f64] [--cutoff-run] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..engine.driver import run
from ..utils import constants as K
from ..utils import load_config
from ..utils.config import auto_pcut_ladder, check_pcuts

EXAMPLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "examples", "04_hadronic_sed.toml")


def sed_config(per_pcut: int, cutoff_run: bool = False):
    """The example's RunConfig with `per_pcut` particles injected and at
    every pcut.  `cutoff_run` raises pmax to 1e7 m_p c on a geometric
    pcut ladder, so that the electrons' radiative cutoff (gamma_c ~ 2e9
    at these fields, p ~ 1e6 m_p c) falls inside the momentum range; the
    shipped pmax of 500 m_p c lies three decades below it."""
    cfg = load_config(EXAMPLE)
    cfg.n_pts_inj = per_pcut
    cfg.n_pts_pcut = per_pcut
    cfg.n_pts_pcut_hi = per_pcut
    if cutoff_run:
        cfg.pmax = 1.0e7 * K.MP_C
        cfg.pcuts = auto_pcut_ladder(cfg.pcuts[0], 2, cfg.emax,
                                     cfg.emax_per_aa, cfg.pmax)
        check_pcuts(cfg.pcuts, cfg.emax, cfg.emax_per_aa, cfg.pmax)
    return cfg


def check_sed(cfg, res) -> bool:
    """Print the SED's extent and the run's physics checks; False if
    one fails."""
    em = res.iterations[-1].emission
    ok = True
    e_mev = np.asarray(em.e_tot) / K.MEV_ERG
    nz = np.asarray(em.tot) > 0
    if nz.any():
        print(f"SED: {nz.sum()} nonzero bins over "
              f"[{e_mev[nz].min():.1e}, {e_mev[nz].max():.1e}] MeV")
    else:
        print("SED: EMPTY (no nonzero bins)")
        ok = False

    setup = res.setup
    i_el = next(i for i, s in enumerate(cfg.species) if s.is_electron)
    fin_e = res.iterations[-1].ion_finals[i_el]
    fin_p = res.iterations[-1].ion_finals[0]
    zone = setup.i_shock + 3
    dnd_e = fin_e.dndp_cr[:, zone, 0]
    dnd_p = fin_p.dndp_cr[:, zone, 0]
    pc = setup.bins.mom_centers
    # electron radiative cutoff: the electron spectrum must END below
    # the proton spectrum's reach (synchrotron + IC losses cap electron
    # acceleration; protons are loss-free), but only when the
    # loss-limited Lorentz factor gamma_c (acceleration rate
    # q B / (acc_fac m_e c) == loss rate coeff * gamma^2) falls inside
    # the configured momentum range
    p_top_e = pc[np.nonzero(dnd_e > 0)[0]].max()
    p_top_p = pc[np.nonzero(dnd_p > 0)[0]].max()
    b_dw = setup.profile.bmag2
    u_rad = (b_dw ** 2 + (K.B_CMB0 * (1 + cfg.redshift) ** 2) ** 2
             ) / (8.0 * np.pi)
    coeff = (4.0 / 3.0) * K.SIGMA_T * K.C_CGS * u_rad / K.ME_C2
    acc_fac = 10.0    # t_acc ~ acc_fac r_g/c (relativistic DSA)
    gamma_c = np.sqrt(K.QE_CGS * b_dw
                      / (acc_fac * K.ME_CGS * K.C_CGS * coeff))
    p_c = gamma_c * K.ME_CGS * K.C_CGS
    print(f"electron dN/dp reaches p = {p_top_e/K.MP_C:.3g} mp c; "
          f"proton reaches {p_top_p/K.MP_C:.3g} mp c; "
          f"loss-limited p_c ~ {p_c/K.MP_C:.3g} mp c")
    if p_c < 0.3 * p_top_p:
        if not p_top_e < 0.5 * p_top_p:
            print("FAIL: radiative cutoff expected at "
                  f"{p_c/K.MP_C:.3g} mp c but electrons reach "
                  "the proton top")
            ok = False
        else:
            print(f"radiative cutoff visible: electrons stop "
                  f"{p_top_p/p_top_e:.1f}x below protons")
    else:
        print("(cutoff beyond configured pmax: gated; use "
              "--cutoff-run to exercise it)")

    # synchrotron / IC luminosity ratio ~ U_B / U_CMB to an order of
    # magnitude (the same electrons radiate in both channels; the zone
    # mixture of B fields, the jet cone cut and Klein-Nishina
    # corrections move the ratio around the Thomson estimate)
    lum_s = float(np.asarray(em.synch_shell).sum())
    lum_ic = float(np.asarray(em.ic_shell).sum())
    u_b = setup.profile.bmag2 ** 2 / (8.0 * np.pi)
    # B_CMB0 is the field whose u_B equals the CMB energy density;
    # u_CMB ~ (1+z)^4
    u_cmb = K.B_CMB0 ** 2 / (8.0 * np.pi) * (1.0 + cfg.redshift) ** 4
    ratio = lum_s / max(lum_ic, 1e-300)
    expect = u_b / u_cmb
    print(f"L_synch/L_IC = {ratio:.3g} vs U_B/U_CMB = "
          f"{expect:.3g} (x{ratio/expect:.2f})")
    if not (0.03 < ratio / expect < 30.0):
        print("FAIL: synch/IC ratio inconsistent with U_B/U_CMB")
        ok = False
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-pcut", type=int, default=16384)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cutoff-run", action="store_true",
                    help="raise pmax to 1e7 mp c (geometric pcut ladder) "
                    "so the electron radiative cutoff falls inside the "
                    "momentum range")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("-o", "--out-dir", default="flagship_sed_out")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    cfg = sed_config(args.per_pcut, args.cutoff_run)
    t0 = time.perf_counter()
    res = run(cfg, args.device, out_dir=args.out_dir,
              p_dtype=torch.float64 if args.f64 else torch.float32)
    dt = time.perf_counter() - t0
    print(f"wall={dt:.1f}s trajs={res.n_trajectories} "
          f"pushes={res.n_pushes}")
    print("timers:", {k: round(v, 1)
                      for k, v in res.timers.totals.items()})
    ok = check_sed(cfg, res)
    print("FLAGSHIP SED " + ("PASSED" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
