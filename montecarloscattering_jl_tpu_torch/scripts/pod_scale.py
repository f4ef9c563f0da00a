"""BASELINE.json config 5: large trajectory counts sharded over ranks.

Counterpart of examples/05_pod_scale.py of the JAX package: shards the
particle batch over ``--devices`` ranks (every visible card by default,
one process a card) and scales the per-pcut population with them,
``--per-chip`` particles a rank, on examples/01_test_particle.toml.  On
a machine of many cards this is the 1e9-trajectory path; anywhere else
it runs the same program on the ranks there are, the CPU included:

    python -m montecarloscattering_jl_tpu_torch.scripts.pod_scale \\
        [--per-chip 2048] [--devices N] [--iterations 1] [--f32] \\
        [--device cuda|cpu] [--backend nccl|gloo]

Lane keys come from global lane indices, so on the host-split paths
(the default float64 engine) the physics is the same bits on any number
of ranks.  Under gloo on a card, ranks may share it: their rates are
then those of processes sharing one card.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..engine.driver import run
from ..parallel import multihost, shard
from ..utils import load_config

CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "examples", "01_test_particle.toml")


def _rank(mesh, args) -> dict:
    cfg = load_config(CONFIG)
    cfg.n_itrs = args.iterations
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = (
        args.per_chip * mesh.size)
    t0 = time.time()
    res = run(cfg, device=mesh.device, mesh=mesh,
              p_dtype=torch.float32 if args.f32 else torch.float64)
    last = res.iterations[-1]
    return dict(trajectories=res.n_trajectories, pushes=res.n_pushes,
                wall=time.time() - t0, en_esc_frac=last.en_esc_frac,
                gamma_downstream=last.gamma_downstream)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-chip", type=int, default=2048,
                    help="particles per pcut per chip")
    ap.add_argument("--iterations", type=int, default=1)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks (0 = every visible card; 1 on the CPU)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: nccl on cuda, gloo on the CPU")
    args = ap.parse_args(argv)

    n_dev = multihost.local_ranks(args.devices, args.device, args.backend)
    backend = args.backend or multihost.default_backend(args.device)
    print(f"devices: {n_dev} x {args.device} ({backend})")
    if n_dev > 1:
        out = multihost.spawn(_rank, n_dev, args=(args,), backend=backend,
                              device=args.device)[0]
    else:
        out = _rank(shard.make_mesh(None, args.device), args)
    dt = out["wall"]
    print(f"{out['trajectories']} trajectories, {out['pushes']} pushes "
          f"in {dt:.1f}s -> {out['pushes'] / dt / 1e6:.2f} M pushes/s "
          f"({out['pushes'] / dt / 1e6 / n_dev:.2f} M/s/chip)")
    # test-particle mode has no back-reaction, so the escaping energy
    # flux can exceed the far-upstream flux (>1 is expected here; the
    # smoothed config of example 02 drives this below 1)
    print(f"escaping / far-upstream energy flux: {out['en_esc_frac']:.4f};"
          f" Gamma_downstream = {out['gamma_downstream']:.4f}")


if __name__ == "__main__":
    main()
