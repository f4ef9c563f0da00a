"""Keshet-Waxman N_g sweep: the finite-N_g systematic of the fitted
index, on one card.

Counterpart of scripts/flagship_kw_sweep.py of the JAX package.  The
deflection per scattering dtheta ~ sqrt(12 pi / (N_g eta)) reaches the
pitch-diffusion limit only as N_g -> inf (scattering.jl:60-75), so the
gamma0 = 5 test-particle index is measured at several N_g
(flagship_keshet_waxman.py, each point in a fresh process), fitted as
s(N_g) = s_inf + a N_g^-p for p in {1/2, 1}, and extrapolated to
N_g -> inf.  The helix cap is the same for every point, `orbits` times
the largest N_g: a cap too small for the larger N_g truncates their
acceleration and steepens the spectrum.

Writes the sweep as JSON to ``-o`` only; it refuses the repo root's
kw_sweep.json, the JAX package's measurement.

Usage:

    python -m montecarloscattering_jl_tpu_torch.scripts.flagship_kw_sweep \\
        [--ngs 4000,8000,16000,32000] [--per-pcut 8192] [--orbits 25] \\
        [--tol 0.1] [--pmax 2400] [--f64] [--device cuda|cpu] \\
        [-o kw_sweep_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from . import workloads as wl

REFERENCE = os.path.join(wl.ROOT, "kw_sweep.json")


def run_point(ng: float, per_pcut: int, cap: int, pmax: float, f64: bool,
              device: str) -> dict:
    """One N_g measurement in a fresh process (K1 and the helix cap are
    a process's own), parsed from the script's printed lines."""
    cmd = [sys.executable, "-m",
           "montecarloscattering_jl_tpu_torch.scripts.flagship_keshet_waxman",
           "--ng", str(ng), "--per-pcut", str(per_pcut), "--cap", str(cap),
           "--tol", "99", "--pmax", str(pmax), "--device", device]
    if f64:
        cmd.append("--f64")
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=wl.ROOT, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    s_fit = s_kw = pushes = None
    for ln in out.stdout.splitlines():
        if "s_fit =" in ln:
            s_fit = float(ln.split("s_fit =")[1].split()[0])
            s_kw = float(ln.split("s_KW =")[1].split()[0])
        if "pushes=" in ln:
            pushes = int(ln.split("pushes=")[1].split()[0])
    if s_fit is None:
        print(out.stdout[-2000:], out.stderr[-2000:])
        raise RuntimeError(f"N_g={ng}: no fit in output")
    print(f"N_g={ng:.0f} cap={cap} -> s_fit={s_fit:.3f} "
          f"(wall {dt:.0f}s, {pushes} pushes)", flush=True)
    return dict(ng=ng, cap=cap, s_fit=s_fit, s_kw=s_kw, pushes=pushes,
                wall_s=dt)


def fit_sweep(points: list) -> dict:
    """s(N_g) = s_inf + a N_g^-p for p = 1/2 ("invsqrt") and 1 ("inv")."""
    x = np.array([p["ng"] for p in points])
    y = np.array([p["s_fit"] for p in points])
    fits = {}
    for p_exp, name in ((0.5, "invsqrt"), (1.0, "inv")):
        c = np.polyfit(x ** -p_exp, y, 1)
        resid = y - np.polyval(c, x ** -p_exp)
        fits[name] = dict(s_inf=float(c[1]), slope=float(c[0]),
                          rms=float(np.sqrt(np.mean(resid ** 2))))
        print(f"s(N_g) = {c[1]:.3f} + {c[0]:.1f} * N_g^-{p_exp}: "
              f"s_inf = {c[1]:.3f} (rms {fits[name]['rms']:.4f})",
              flush=True)
    return fits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ngs", default="4000,8000,16000,32000")
    ap.add_argument("--per-pcut", type=int, default=8192)
    ap.add_argument("--orbits", type=int, default=25,
                    help="helix cap in gyro-orbits (cap = orbits*N_g)")
    ap.add_argument("--tol", type=float, default=0.1,
                    help="accepted |s_inf - s_KW| on the best fit")
    ap.add_argument("--pmax", type=float, default=2400.0,
                    help="maximum momentum in mp c; the default puts "
                    "the spectral cutoff 3 octaves above the fit "
                    "window (the historical pmax=300 bled cutoff "
                    "curvature into the fitted index)")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("-o", "--out", default="kw_sweep_torch.json")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == REFERENCE:
        raise SystemExit(f"-o {args.out}: that is the JAX package's "
                         f"measurement; write the sweep elsewhere")

    ngs = [float(x) for x in args.ngs.split(",")]
    cap = int(args.orbits * max(ngs))
    points = [run_point(ng, args.per_pcut, cap, args.pmax, args.f64,
                        args.device) for ng in ngs]
    s_kw = points[0]["s_kw"]
    fits = fit_sweep(points)
    best = min(fits, key=lambda k: fits[k]["rms"])
    s_inf = fits[best]["s_inf"]
    ok = abs(s_inf - s_kw) <= args.tol
    print(f"best model {best}: s_inf = {s_inf:.3f} vs s_KW = "
          f"{s_kw:.3f} (|diff| = {abs(s_inf - s_kw):.3f}) -> "
          + ("PASSED" if ok else "FAILED"), flush=True)
    with open(args.out, "w") as f:
        json.dump(dict(points=points, fits=fits, best=best, s_inf=s_inf,
                       s_kw=s_kw, tol=args.tol, passed=bool(ok)), f,
                  indent=1)
    print(f"sweep artifact -> {args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
