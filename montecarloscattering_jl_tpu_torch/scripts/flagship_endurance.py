"""Single-card endurance run: drive >= 1e8 trajectories through the pcut
ladder and show that device memory stays flat and the rate does not
decay.

Counterpart of scripts/flagship_endurance.py of the JAX package.  The
flagship nonlinear workload (tests/data/dsa_nonrel.toml, smoothing on)
is repeated block by block at a frozen profile: transport and the full
per-species reduction, the steady state of a long run.  Each block
prints its wall time, trajectories, pushes, push rate, and the card's
memory: ``torch.cuda.memory_allocated`` (hbm_in_use_mb),
``max_memory_allocated`` (hbm_peak_mb) and ``memory_reserved``
(hbm_reserved_mb), 0 on the CPU.  Float32 momenta (K1) unless
``--f64``.

Pass criteria printed at the end, as the JAX script's:
  * allocated memory drifts by less than 1% from block 2 to the last
    (block 1 warms the allocator);
  * each block's push rate lies within 5% of the median.

Usage:

    python -m montecarloscattering_jl_tpu_torch.scripts.flagship_endurance \\
        [--trajectories 1e8] [--per-pcut 262144] [--f64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..engine.driver import ion_finalize_start
from ..engine.run import TransportEngine
from ..engine.setup import build_setup
from ..utils import load_config
from . import workloads as wl


def mem(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return dict(in_use=0, peak=0, reserved=0)
    return dict(in_use=torch.cuda.memory_allocated(dev),
                peak=torch.cuda.max_memory_allocated(dev),
                reserved=torch.cuda.memory_reserved(dev))


def endurance(trajectories: float = 1e8, per_pcut: int = 262_144,
              f64: bool = False, device="cuda") -> dict:
    """Blocks until `trajectories` have run; prints each block's JSON
    line and the summary, and returns the blocks, the drift, the rate
    floor against the median and both verdicts."""
    cfg = load_config(wl.CFG)
    cfg.do_smoothing = True
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = per_pcut
    setup = build_setup(cfg)
    engine = TransportEngine(
        setup, device=device,
        p_dtype=torch.float64 if f64 else torch.float32)
    dev = engine.device
    prof = setup.profile

    target = int(trajectories)
    blocks = []
    t_start = time.perf_counter()
    i_iter = 0
    while engine.n_trajectories_total < target:
        t0 = time.perf_counter()
        it = engine.new_iteration_tallies(prof)
        tr0, pu0 = engine.n_trajectories_total, engine.n_pushes_total
        for i_ion in range(cfg.n_ions):
            res = engine.run_ion(i_iter, i_ion, prof, it)
            # the reductions run too (their buffers could creep);
            # the products are dropped
            fin = ion_finalize_start(setup, res, prof, i_ion,
                                     i_ion == cfg.n_ions - 1)()
            del fin, res
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        m = mem(dev)
        blk = {
            "block": i_iter,
            "wall_s": round(dt, 2),
            "trajs": engine.n_trajectories_total - tr0,
            "pushes": engine.n_pushes_total - pu0,
            "mpushes_per_s": round(
                (engine.n_pushes_total - pu0) / dt / 1e6, 1),
            "hbm_in_use_mb": round(m["in_use"] / 1e6, 1),
            "hbm_peak_mb": round(m["peak"] / 1e6, 1),
            "hbm_reserved_mb": round(m["reserved"] / 1e6, 1),
            "total_trajs": engine.n_trajectories_total,
        }
        blocks.append(blk)
        print(json.dumps(blk), flush=True)
        i_iter += 1

    wall = time.perf_counter() - t_start
    rates = np.array([b["mpushes_per_s"] for b in blocks[1:]]
                     or [blocks[0]["mpushes_per_s"]])
    hbm = np.array([b["hbm_in_use_mb"] for b in blocks[1:]]
                   or [blocks[0]["hbm_in_use_mb"]])
    med = float(np.median(rates))
    drift = float((hbm[-1] - hbm[0]) / max(hbm[0], 1e-9))
    # (a rate that rounds to 0 M pushes/s, a tiny CPU run's, shows none)
    decay = float((rates.min() - med) / med) if med > 0 else 0.0
    print(f"\nendurance: {engine.n_trajectories_total:.3g} trajs, "
          f"{engine.n_pushes_total:.3g} pushes in {wall:.0f}s "
          f"({engine.n_pushes_total / wall / 1e6:.1f} M pushes/s "
          f"sustained, {engine.n_trajectories_total / wall:.0f} "
          f"trajs/s)")
    print(f"HBM drift (block 2 -> last): {drift:+.2%} "
          f"({'PASS' if abs(drift) < 0.01 else 'FAIL'} < 1%)")
    print(f"rate floor vs median: {decay:+.2%} "
          f"({'PASS' if decay > -0.05 else 'FAIL'} within 5%)")
    return dict(blocks=blocks, drift=drift, rate_floor=decay, wall=wall,
                trajectories=engine.n_trajectories_total,
                pushes=engine.n_pushes_total,
                drift_ok=abs(drift) < 0.01, rate_ok=decay > -0.05)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trajectories", type=float, default=1e8)
    ap.add_argument("--per-pcut", type=int, default=262144,
                    help="split target per pcut level")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    endurance(args.trajectories, args.per_pcut, args.f64, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
