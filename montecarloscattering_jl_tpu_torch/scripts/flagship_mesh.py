"""Mesh flagship: the nonlinear smoothed shock sharded over ranks
(BASELINE.md config 5, the 1e9-trajectory scale).

Counterpart of scripts/flagship_mesh.py of the JAX package: the
particle batch of tests/data/dsa_nonrel.toml (smoothing on,
``--per-pcut`` particles, a global count, ``--iters`` iterations) is
sharded over ``--devices`` ranks, one process a card.  At float32 (the
default) every rank runs the mesh hybrid ladder on K1: it drains,
finishes and splits its own lanes, and only its splits' counters (new
lanes, steps and weights: one gather a sync point and one at the end of
a species' ladder) and, once a species, the tallies cross ranks
(parallel/shard.py).  ``--f64`` runs the XLA engine with the host split,
which gathers the lanes a segment.

    python -m montecarloscattering_jl_tpu_torch.scripts.flagship_mesh \\
        [--devices N] [--per-pcut 65536] [--iters 10] [--f64] \\
        [--device cuda|cpu] [--backend nccl|gloo] [-o DIR]

``--multihost``: this process is one rank of a group started elsewhere
(torchrun's environment; one process a card), and every rank runs the
script with the same arguments.  Under gloo on a card, ranks may share
it; the rates are then those of processes sharing one card.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..engine.driver import run
from ..parallel import multihost, shard
from .flagship_nonlinear import nonlinear_config


def _rank(mesh, args) -> dict:
    cfg = nonlinear_config(args.per_pcut, args.iters)
    t0 = time.perf_counter()
    res = run(cfg, device=mesh.device, mesh=mesh, out_dir=args.out_dir,
              p_dtype=torch.float64 if args.f64 else torch.float32)
    return dict(wall=time.perf_counter() - t0, trajectories=res.n_trajectories,
                pushes=res.n_pushes, timers=dict(res.timers.totals),
                mesh=res.mesh)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh size (0 = all visible devices)")
    ap.add_argument("--per-pcut", type=int, default=65536,
                    help="split target per pcut level (global, not "
                    "per chip)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group from torchrun's "
                    "environment (one process a card)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: nccl on cuda, gloo on the CPU")
    ap.add_argument("-o", "--out-dir", default="flagship_mesh_out")
    args = ap.parse_args(argv)

    if args.multihost:
        multihost.init_distributed(backend=args.backend, device=args.device)
        mesh = shard.make_mesh(args.devices or None, args.device)
        n = mesh.size
        backend = mesh.backend
    else:
        n = multihost.local_ranks(args.devices, args.device, args.backend)
        backend = args.backend or multihost.default_backend(args.device)
    print(f"mesh: {n} devices ({args.device}, {backend})")
    if args.multihost:
        out = _rank(mesh, args)
        if mesh.rank != 0:
            return
    elif n > 1:
        out = multihost.spawn(_rank, n, args=(args,), backend=backend,
                              device=args.device)[0]
    else:
        out = _rank(shard.make_mesh(None, args.device), args)
    dt = out["wall"]
    print(f"wall={dt:.1f}s trajs={out['trajectories']} "
          f"pushes={out['pushes']} -> {out['trajectories'] / dt:.0f} "
          f"trajs/s, {out['pushes'] / dt / 1e6:.1f} M pushes/s "
          f"({out['pushes'] / dt / 1e6 / n:.1f} M/chip)")
    print("timers:", {k: round(v, 1) for k, v in out["timers"].items()})
    if out["mesh"] is not None:
        # a species: the hybrid's gather a sync point and one at the end,
        # or the host split's gather a segment, then 17 reductions
        per = ("a segment" if args.f64
               else "a sync point and one at the ladder's end")
        print("collectives:", out["mesh"]["collectives"],
              f"in {out['mesh']['collective_s']:.3f} s (rank 0; a gather "
              f"{per} and 17 reductions a species, barriers)")


if __name__ == "__main__":
    main()
