"""Weak-scaling curve of the mesh: the same work a rank at 1, 2, 4, 8
ranks.

Counterpart of scripts/weak_scaling.py of the JAX package: for each
size of ``--sizes`` a fresh set of ranks (one process a card) runs
tests/data/dsa_nonrel.toml with smoothing on and ``--per-shard`` lanes
a rank (the global batch grows with the mesh), and the push rate a rank
is reported against the size.  Flat is perfect: lanes are independent
between tallies, and the ranks meet only in the mesh hybrid's split
counters (K1, the default: one gather a sync point and one at the end of
a species' ladder), the host split's gather a segment (float64) and one
tally reduction a species (parallel/shard.py): a row's ``collectives``
counts them all on rank 0, with the barriers.

On fewer cards than ranks (gloo), ranks share the cards, and a rank's
rate is that of processes sharing a card: the output says so in every
row (``ranks_per_card``).  On the CPU the rates say how the collectives
scale, not what a card does.

    python -m montecarloscattering_jl_tpu_torch.scripts.weak_scaling \\
        [--per-shard 8192] [--iters 1] [--sizes 1,2,4,8] [--f64] \\
        [--device cuda|cpu] [--backend nccl|gloo]

Writes one JSON line per mesh size and a summary table to stdout.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..engine.driver import run
from ..parallel import multihost, shard
from .flagship_nonlinear import nonlinear_config


def _rank(mesh, args) -> dict:
    # weak scaling: the global batch grows with the mesh so the lanes a
    # rank stay fixed
    cfg = nonlinear_config(args.per_shard * mesh.size, args.iters)
    t0 = time.perf_counter()
    res = run(cfg, device=mesh.device, mesh=mesh,
              p_dtype=torch.float64 if args.f64 else torch.float32)
    return dict(wall=time.perf_counter() - t0, pushes=res.n_pushes,
                transport=res.timers.totals.get("transport", 0.0),
                mesh=res.mesh)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-shard", type=int, default=8192,
                    help="particle lanes per shard (fixed as the mesh "
                    "grows — weak scaling)")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--sizes", default="1,2,4,8",
                    help="comma-separated mesh sizes")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: nccl on cuda, gloo on the CPU")
    args = ap.parse_args(argv)

    backend = args.backend or multihost.default_backend(args.device)
    cards = (torch.cuda.device_count() if args.device == "cuda" else 0)
    sizes = [int(s) for s in args.sizes.split(",")]
    if backend == "nccl":
        sizes = [s for s in sizes if s <= cards]

    rows = []
    for size in sizes:
        if size > 1:
            out = multihost.spawn(_rank, size, args=(args,),
                                  backend=backend, device=args.device)[0]
        else:
            out = _rank(shard.make_mesh(None, args.device), args)
        dt, transport = out["wall"], out["transport"] or out["wall"]
        row = {
            "mesh": size,
            "per_shard_lanes": args.per_shard,
            "wall_s": round(dt, 2),
            "transport_s": round(transport, 2),
            "pushes": int(out["pushes"]),
            "mpushes_per_s": round(out["pushes"] / dt / 1e6, 2),
            "mpushes_per_s_per_shard": round(
                out["pushes"] / dt / 1e6 / size, 3),
            "mpushes_per_s_per_shard_transport": round(
                out["pushes"] / max(transport, 1e-9) / 1e6 / size, 3),
            "device": args.device,
            "backend": backend if size > 1 else None,
            "ranks_per_card": (round(size / cards, 2) if cards else None),
            "collectives": (out["mesh"] or {}).get("collectives", 0),
            "collective_s": (out["mesh"] or {}).get("collective_s", 0.0),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    if not rows:
        print(f"no size of {args.sizes} fits {cards} card(s) under "
              f"{backend}")
        return
    base = rows[0]["mpushes_per_s_per_shard_transport"]
    print("\nmesh  per-shard M/s (transport)  efficiency")
    for r in rows:
        eff = r["mpushes_per_s_per_shard_transport"] / base
        rate = r["mpushes_per_s_per_shard_transport"]
        print(f"{r['mesh']:4d}  {rate:22.3f}  {eff:8.2%}")
    if cards and max(sizes) > cards:
        print(f"ranks above {cards} share the {cards} card(s): their rate "
              f"a rank is that of processes sharing a card, not of a card "
              f"each")


if __name__ == "__main__":
    main()
