"""Command-line driver: python -m montecarloscattering_jl_tpu_torch.

Reads a TOML config, runs the nonlinear loop and writes the output-file
surface of the JAX package's CLI.  Momenta are float64 unless ``--f32``
is given, as in the JAX CLI; ``--checkpoint``, ``--resume``,
``--mid-every``, ``--no-fused``, ``--compact-levels``, ``--devices``,
``--coordinator``, ``--num-processes`` and ``--process-id`` are the JAX
CLI's.

``--devices N`` (N > 1) shards the particle batch over N ranks on this
host, one process a card (parallel/multihost.spawn; on ``--device cpu``
N processes joined by gloo).  One process of a run over several hosts
joins its process group with ``--coordinator``, ``--num-processes`` and
``--process-id``, or from torchrun's environment (WORLD_SIZE and RANK
set): ``torchrun --nproc-per-node 4 -m montecarloscattering_jl_tpu_torch
CONFIG``.
"""

import argparse
import logging
import os
import sys
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarloscattering_jl_tpu_torch",
        description="Nonlinear Monte Carlo DSA shock runs on a CUDA card",
        epilog="Environment, as in the JAX package's CLI: MCS_I_APPROX, "
               "the dN/dp rebinning's cell spreading (0 uniform, 1 "
               "isosceles, 2 scalene, the default, 3 exact overlap); "
               "MCS_MID_CKPT_EVERY, --mid-every's default; "
               "MCS_MID_STOP_AFTER=1, stop after the first segment-boundary "
               "save; MCS_OVERLAP_REDUCE=0, reduce each species before the "
               "next one transports; MCS_SUBTIMERS=1, time population "
               "setup, ladder and tally fetch")
    ap.add_argument("config", nargs="?", default="mc_in.toml",
                    help="TOML run configuration (default: mc_in.toml)")
    ap.add_argument("-o", "--out-dir", default=".",
                    help="output directory (default: cwd)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="run on the CUDA card (default) or on the CPU "
                         "through the kernels' plain versions")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the particle batch over N devices "
                         "(0 = all available when > 1)")
    ap.add_argument("--f32", action="store_true",
                    help="float32 momenta (positions stay float64)")
    ap.add_argument("--checkpoint", default=None,
                    help="write a checkpoint here after every iteration")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint (iteration-boundary "
                         "NPZ or segment-boundary .mid, auto-detected)")
    ap.add_argument("--mid-every", type=int, default=0,
                    help="with --checkpoint: also write a "
                         "segment-boundary checkpoint (<path>.mid) "
                         "every N pcut segments so a kill mid-species "
                         "resumes inside the transport ladder")
    ap.add_argument("--no-fused", action="store_true",
                    help="use host-side pcut splitting instead of the "
                         "fused on-device ladder")
    ap.add_argument("--compact-levels", type=int, default=-1,
                    help="live-lane compaction ladder depth "
                         "(-1 auto, 0 off)")
    ap.add_argument("--coordinator", default=None,
                    help="multi-host: torch.distributed coordinator "
                         "address (host:port)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="multi-host: total process count")
    ap.add_argument("--process-id", type=int, default=None,
                    help="multi-host: this process's id")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap


def _run(mesh, args) -> tuple:
    """One rank's run (the whole run without a mesh); the totals and the
    wall seconds."""
    import torch

    from .engine.driver import run

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(message)s")
    t0 = time.time()
    result = run(args.config, device=args.device, out_dir=args.out_dir,
                 p_dtype=torch.float32 if args.f32 else torch.float64,
                 checkpoint=args.checkpoint, resume=args.resume,
                 mid_every=args.mid_every, fused=not args.no_fused,
                 compact_levels=args.compact_levels, mesh=mesh)
    return (len(result.iterations), result.n_trajectories, result.n_pushes,
            time.time() - t0)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(message)s")

    import torch

    from .parallel import multihost, shard

    if not os.path.exists(args.config):
        print(f"error: config file {args.config!r} not found",
              file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    if args.coordinator is not None or args.num_processes is not None:
        multihost.init_distributed(args.coordinator, args.num_processes,
                                   args.process_id, device=args.device)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        multihost.init_distributed(device=args.device)

    if torch.distributed.is_initialized():
        mesh = shard.make_mesh(args.devices or None, args.device)
        out = _run(mesh, args)
        if mesh.rank != 0:
            return 0
        ranks = f" on {mesh.size} ranks ({mesh.backend})"
    else:
        n = multihost.local_ranks(args.devices, args.device)
        if n > 1:
            out = multihost.spawn(_run, n, args=(args,),
                                  device=args.device)[0]
            ranks = (f" on {n} ranks "
                     f"({multihost.default_backend(args.device)})")
        else:
            out = _run(None, args)
            ranks = ""
    n_itrs, trajectories, pushes, dt = out
    print(f"finished: {n_itrs} iterations, {trajectories} trajectories, "
          f"{pushes} pushes in {dt:.1f}s "
          f"({pushes / max(dt, 1e-9) / 1e6:.2f} M pushes/s){ranks}")
    print(f"outputs written to {os.path.abspath(args.out_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
