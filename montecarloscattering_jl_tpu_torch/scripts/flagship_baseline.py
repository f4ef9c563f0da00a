"""Reference-parity baseline flagship: configs/baseline.toml, the
key-for-key mirror of the reference's shipped mc_in.toml, run to
completion on one card.

Counterpart of scripts/flagship_baseline.py of the JAX package.  The
shipped config is a gamma0 = 5 parallel shock, protons and electrons,
20 iterations, 45 pcuts, tcuts, radiative losses, fast push and custom
eps_B, with the testing switches no-scatter / no-DSA on and smoothing
off (mc_in.toml:132-139).  ``--dsa`` turns them to the physical
configuration (scattering, DSA, smoothing): the science variant, with
the switches of scripts/workloads.py ``science_variant``.

Prints the dashboard the reference writes to mc_grid.dat and stdout:
r_comp against r_RH, Gamma_2 against R-H, the escaping-flux fractions
against the q_esc theory, the flux-conservation norms, wall time, push
and trajectory totals; writes the full file set to ``--out-dir``.

Usage:

    python -m montecarloscattering_jl_tpu_torch.scripts.flagship_baseline \\
        [--dsa] [--pcuts-per-decade N] [--iters N] [--max-helix-steps N] \\
        [--n-pts-mult N] [--f64] [--checkpoint CK.npz] [--resume CK] \\
        [--mid-every N] [-o OUT] [--device cuda|cpu]

The science variant of the chip's smoke test: ``--dsa
--pcuts-per-decade 4 --max-helix-steps 200000 --n-pts-mult 4``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from ..engine.driver import run
from . import workloads as wl


def baseline_config(dsa: bool = False, pcuts_per_decade: int = 0,
                    iters: int = 0, n_pts_mult: int = 1):
    """configs/baseline.toml with the script's switches."""
    cfg = wl.load_variant(wl.BASELINE)
    wl.science_variant(cfg, dsa=dsa, pcuts_per_decade=pcuts_per_decade,
                       n_pts_mult=n_pts_mult)
    if iters:
        cfg.n_itrs = iters
    return cfg


def dashboard(res, dt: float, out_dir: str | None) -> list:
    """The dashboard's lines."""
    cfg, setup = res.setup.cfg, res.setup
    lines = [
        f"wall={dt:.1f}s iterations={len(res.iterations)} "
        f"species={cfg.n_ions} pcuts={len(cfg.pcuts)}",
        f"trajs={res.n_trajectories} pushes={res.n_pushes} "
        f"-> {res.n_trajectories / dt:.0f} trajs/s, "
        f"{res.n_pushes / dt / 1e6:.1f} M pushes/s",
        f"r_comp={setup.r_comp:.4f} r_RH={setup.r_rh:.4f} "
        f"Gamma2_RH={setup.gamma2_rh:.4f}"]
    for i, itr in enumerate(res.iterations):
        pxx = en = float("nan")
        if itr.diag is not None:
            pxx = float(np.max(itr.diag.pxx_norm))
            en = float(np.max(itr.diag.energy_norm))
        lines.append(
            f"iter {i + 1:2d}: Gamma_dw={itr.gamma_downstream:.4f} "
            f"px_esc={itr.px_esc_frac:.4f} en_esc={itr.en_esc_frac:.4f} "
            f"q_esc_px={itr.q_esc_px:.4f} q_esc_en={itr.q_esc_en:.4f} "
            f"pxx_norm_max={pxx:.3f} en_norm_max={en:.3f}")
    lines.append("timers: " + str({k: round(v, 1) for k, v in
                                   res.timers.totals.items()}))
    for f in ("mc_out.dat", "mc_grid.dat", "mc_coupled_weights.csv",
              "mc_coupled_spectra.csv"):
        p = os.path.join(out_dir, f) if out_dir else f
        lines.append(f"{f}: " + ("%d bytes" % os.path.getsize(p)
                                 if out_dir and os.path.exists(p)
                                 else "MISSING"))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dsa", action="store_true",
                    help="science variant: scattering + DSA + smoothing")
    ap.add_argument("--pcuts-per-decade", type=int, default=0,
                    help="replace the shipped 45-pcut ladder with a "
                    "geometric one (utils.config.auto_pcut_ladder); "
                    "the shipped ladder's factor-60 first gap cannot "
                    "be climbed at gamma0=5 where P_ret ~ 0.25")
    ap.add_argument("--iters", type=int, default=0,
                    help="override num-iterations (0 = config value)")
    ap.add_argument("--max-helix-steps", type=int, default=0,
                    help="raise the per-segment helix step cap (the "
                    "reference hardcodes 10k with its own FIXME, "
                    "particle_loop.jl:162; a gamma0=5 DSA cycle needs "
                    "~20k fine-scattering steps downstream, so the "
                    "--dsa science run dies by step-cap without this; "
                    "200000 is a good value)")
    ap.add_argument("--n-pts-mult", type=int, default=1,
                    help="multiply the config's particle counts "
                    "(n_pts_inj / n_pts_pcut / n_pts_pcut_hi).  The "
                    "reference's shipped 100/400/2000 counts starve "
                    "the gamma0=5 nonlinear fixed point: once "
                    "smoothing weakens the subshock, 392 lanes "
                    "cannot populate the first pcut and the tallies "
                    "die; 16-64x fixes both.")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="iteration-boundary checkpoint path (engine "
                    "driver passthrough)")
    ap.add_argument("--resume", default=None,
                    help="resume from an iteration or .mid checkpoint")
    ap.add_argument("--mid-every", type=int, default=0,
                    help="with --checkpoint: segment-boundary "
                    "checkpoint every N pcut segments")
    ap.add_argument("-o", "--out-dir", default="flagship_baseline_out")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    cfg = baseline_config(args.dsa, args.pcuts_per_decade, args.iters,
                          args.n_pts_mult)
    cap = (wl.helix_cap(args.max_helix_steps) if args.max_helix_steps
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with cap:
        res = run(cfg, args.device, out_dir=args.out_dir,
                  p_dtype=torch.float64 if args.f64 else torch.float32,
                  checkpoint=args.checkpoint, resume=args.resume,
                  mid_every=args.mid_every)
    dt = time.perf_counter() - t0
    for ln in dashboard(res, dt, args.out_dir):
        print(ln)
    return 0


if __name__ == "__main__":
    sys.exit(main())
