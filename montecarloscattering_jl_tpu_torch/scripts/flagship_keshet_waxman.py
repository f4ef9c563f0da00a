"""Keshet-Waxman relativistic-index validation (the pitch-diffusion
limit), on one card.

Counterpart of scripts/flagship_keshet_waxman.py of the JAX package.
The Keshet & Waxman (2005) index s = (3 b0 - 2 b0 b2^2 + b2^3)/(b0 - b2)
(the diagnostic the reference prints, io.jl:147-151) holds for
relativistic DSA in the pitch-angle-diffusion limit: a deflection per
scattering dtheta << 1/Gamma_rel.  That needs N_g ~ 1e4 steps a
gyroperiod, far beyond the default 10,000-step helix cap
(particle_loop.jl:162-165), so the run raises the cap and transports
test-particle gamma0 = 5 protons (tests/data/electron_photon.toml,
protons only, no photons, no radiative losses) through a pcut ladder
from 0.5 to ~pmax m_p c, with the host split (``fused=False``) and the
compaction ladder at depth 4, as the JAX script does.  At float32 the
drains run on K1; with ``--f64`` on the XLA engine.

The downstream dN/dp (zone i_shock + 5) is fitted over 9-120 m_p c; the
fitted index s_fit = 2 - slope must lie within ``--tol`` of s_KW.

Usage:

    python -m montecarloscattering_jl_tpu_torch.scripts.flagship_keshet_waxman \\
        [--per-pcut 8192] [--ng 8000] [--cap 200000] [--tol 0.25] \\
        [--pmax 300] [--f64] [--device cuda|cpu]

Exits 0 when the fit passes, 1 otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..engine.run import TransportEngine
from ..engine.setup import build_setup
from ..utils import constants as K
from ..utils import load_config
from . import workloads as wl

CONFIG = os.path.join(wl.ROOT, "tests", "data", "electron_photon.toml")


def kw_config(per_pcut: int, ng: float, pmax: float):
    """The run's RunConfig: protons only, `per_pcut` particles injected
    and at every pcut, fine and coarse steps at `ng` a gyroperiod, the
    maximum momentum `pmax` m_p c and pcuts up to it."""
    cfg = load_config(CONFIG)
    cfg.species = cfg.species[:1]          # protons only
    cfg.inj_fracs = cfg.inj_fracs[:1]
    cfg.do_photons = False
    cfg.do_rad_losses = False
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = per_pcut
    # the pitch-angle-diffusion limit: fine and coarse steps at N_g
    cfg.xn_per_fine = cfg.xn_per_coarse = ng
    # the thermal peak of the gamma0 = 5 shock sits at ~3.4 m_p c; the
    # power law is measured over ~1.2 decades above it
    cfg.pmax = pmax * K.MP_C
    pcuts = [0.5, 4.5, 9.0, 18.0, 36.0, 72.0, 145.0, 290.0]
    p = 290.0
    while p * 2.0 < pmax:
        p *= 2.0
        pcuts.append(p)
    cfg.pcuts = [q * K.MP_C for q in pcuts]
    return cfg


def measure(per_pcut: int = 8192, ng: float = 8000.0, cap: int = 200_000,
            pmax: float = 300.0, f64: bool = False, device="cuda") -> dict:
    """One Keshet-Waxman run; prints the JAX script's lines and returns
    s_KW, the fit (slope, bins, s_fit), pushes, trajectories, wall
    seconds and the run's IonResult."""
    cfg = kw_config(per_pcut, ng, pmax)
    setup = build_setup(cfg)
    b0, b2 = cfg.beta0, setup.beta2
    s_kw = (3 * b0 - 2 * b0 * b2**2 + b2**3) / (b0 - b2)
    print(f"gamma0={cfg.gamma0:.2f} beta0={b0:.4f} beta2={b2:.4f} "
          f"s_KW={s_kw:.3f} (dN/dp slope {2 - s_kw:.3f})", flush=True)

    eng = TransportEngine(
        setup, device=device,
        p_dtype=torch.float64 if f64 else torch.float32,
        fused=False, compact_levels=4)
    it = eng.new_iteration_tallies()
    with wl.helix_cap(cap):
        t0 = time.perf_counter()
        res = eng.run_ion(0, 0, setup.profile, it)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        dt = time.perf_counter() - t0
    print(f"wall={dt:.1f}s pushes={res.n_pushes} "
          f"({res.n_pushes / dt / 1e6:.1f}M/s) trajs={res.n_trajectories}",
          flush=True)

    # downstream dN/dp slope over the clean power-law window
    p_cent = setup.bins.mom_centers
    dp = np.diff(setup.bins.mom_edges)
    zone = setup.i_shock + 5
    dndp = res.psd[:, :, zone].sum(dim=1).double().cpu().numpy() / dp
    sel = ((p_cent > 9.0 * K.MP_C) & (p_cent < 120.0 * K.MP_C)
           & (dndp > 0))
    if sel.sum() >= 2:
        slope = float(np.polyfit(np.log10(p_cent[sel]),
                                 np.log10(dndp[sel]), 1)[0])
    else:
        slope = float("nan")     # too few bins to fit: the gate fails
    s_fit = 2.0 - slope
    print(f"fitted dN/dp slope = {slope:.3f} over {int(sel.sum())} bins "
          f"=> s_fit = {s_fit:.3f} vs s_KW = {s_kw:.3f} "
          f"(|diff| = {abs(s_fit - s_kw):.3f})", flush=True)
    return dict(s_kw=s_kw, slope=slope, n_bins=int(sel.sum()), s_fit=s_fit,
                pushes=res.n_pushes, trajectories=res.n_trajectories,
                wall=dt, result=res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-pcut", type=int, default=8192)
    ap.add_argument("--ng", type=float, default=8000.0,
                    help="steps per gyroperiod (pitch-diffusion: >= ~5e3)")
    ap.add_argument("--cap", type=int, default=200_000,
                    help="helix-step cap per segment")
    ap.add_argument("--tol", type=float, default=0.25,
                    help="accepted |s_fit - s_KW|")
    ap.add_argument("--pmax", type=float, default=300.0,
                    help="maximum momentum in mp c.  The default keeps "
                    "the historical budget; raising it moves the "
                    "spectral cutoff away from the fit window (9-120 "
                    "mp c), isolating cutoff contamination of the "
                    "fitted index from genuine scattering physics")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    out = measure(args.per_pcut, args.ng, args.cap, args.pmax, args.f64,
                  args.device)
    ok = abs(out["s_fit"] - out["s_kw"]) <= args.tol
    print("KESHET-WAXMAN VALIDATION " + ("PASSED" if ok else "FAILED"),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
