"""Flagship single-card run: the nonlinear smoothed shock driven to
convergence at production batch size (BASELINE.md config 2).

Counterpart of scripts/flagship_nonlinear.py of the JAX package:
tests/data/dsa_nonrel.toml (protons, 6 pcuts, u0 = 3000 km/s) with
smoothing on, ``--per-pcut`` particles injected and at every pcut,
``--iters`` iterations, float32 momenta (the transport runs on K1)
unless ``--f64``.  Prints each iteration's escaping momentum and energy
fractions and the largest pxx-flux overshoot (max pxx_norm), which
decays towards 1 over the odd iterations as the profile converges (the
even ones are damped by the smoothing's relaxation).  With
``--checkpoint`` it writes the iteration checkpoint (and, with
``--mid-every``, the segment-boundary one); ``--resume`` goes on from
either.

Usage:

    python -m montecarloscattering_jl_tpu_torch.scripts.flagship_nonlinear \\
        [--per-pcut 65536] [--iters 10] [--f64] [--device cuda|cpu] \\
        [--checkpoint CK.npz] [--mid-every N] [--resume CK.npz[.mid]]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..engine.driver import run
from ..utils import load_config

CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "data", "dsa_nonrel.toml")


def nonlinear_config(per_pcut: int, iters: int):
    """The flagship's RunConfig: smoothing on, `per_pcut` particles
    injected and at every pcut, `iters` iterations."""
    cfg = load_config(CONFIG)
    cfg.n_itrs = iters
    cfg.do_smoothing = True
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = per_pcut
    return cfg


def iteration_rows(res, first: int = 1) -> list:
    """Per iteration (numbered from `first`): pushes, trajectories, the
    escaping fractions and the max pxx_norm."""
    return [dict(iteration=first + i,
                 pushes=sum(f.n_pushes for f in itr.ion_finals),
                 trajectories=sum(f.n_trajectories for f in itr.ion_finals),
                 px_esc_frac=float(itr.px_esc_frac),
                 en_esc_frac=float(itr.en_esc_frac),
                 pxx_norm_max=float(np.max(itr.diag.pxx_norm)))
            for i, itr in enumerate(res.iterations)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-pcut", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--checkpoint", default=None,
                    help="write a checkpoint here after every iteration")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint (iteration-boundary "
                         "NPZ or segment-boundary .mid, auto-detected)")
    ap.add_argument("--mid-every", type=int, default=0,
                    help="with --checkpoint: also write a segment-boundary "
                         "checkpoint (<path>.mid) every N pcut segments")
    ap.add_argument("-o", "--out-dir", default="flagship_out")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    cfg = nonlinear_config(args.per_pcut, args.iters)
    t0 = time.perf_counter()
    res = run(cfg, args.device, out_dir=args.out_dir,
              p_dtype=torch.float64 if args.f64 else torch.float32,
              checkpoint=args.checkpoint, resume=args.resume,
              mid_every=args.mid_every)
    dt = time.perf_counter() - t0
    print(f"wall={dt:.1f}s trajs={res.n_trajectories} "
          f"pushes={res.n_pushes} -> {res.n_pushes / dt / 1e6:.1f}M "
          f"pushes/s")
    first = cfg.n_itrs - len(res.iterations) + 1
    for row in iteration_rows(res, first):
        print(f"iter {row['iteration']}: px_esc={row['px_esc_frac']:.4f} "
              f"en_esc={row['en_esc_frac']:.4f} "
              f"pxx_norm_max={row['pxx_norm_max']:.3f}")
    print("timers:", {k: round(v, 2)
                      for k, v in res.timers.totals.items()})
    if res.subtimers:
        print("transport breakdown:", {k: round(v, 2)
                                       for k, v in res.subtimers.items()},
              "launches:", res.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
