"""Command-line driver: python -m montecarloscattering_jl_tpu_torch.

Reads a TOML config, runs the nonlinear loop on one device and writes
the output-file surface of the JAX package's CLI.  Momenta are float64
unless ``--f32`` is given, as in the JAX CLI.
"""

import argparse
import logging
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="montecarloscattering_jl_tpu_torch",
        description="Nonlinear Monte Carlo DSA shock runs on a CUDA card",
        epilog="MCS_I_APPROX (environment): the dN/dp rebinning's cell "
               "spreading, 0 uniform, 1 isosceles, 2 scalene (default), "
               "3 exact overlap, as in the JAX package's CLI")
    ap.add_argument("config", nargs="?", default="mc_in.toml",
                    help="TOML run configuration (default: mc_in.toml)")
    ap.add_argument("-o", "--out-dir", default=".",
                    help="output directory (default: cwd)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="run on the CUDA card (default) or on the CPU "
                         "through the kernels' plain versions")
    ap.add_argument("--f32", action="store_true",
                    help="float32 momenta (positions stay float64)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(message)s")

    import torch

    from .engine.driver import run

    if not os.path.exists(args.config):
        print(f"error: config file {args.config!r} not found",
              file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    t0 = time.time()
    result = run(args.config, device=args.device, out_dir=args.out_dir,
                 p_dtype=torch.float32 if args.f32 else torch.float64)
    dt = time.time() - t0
    print(f"finished: {len(result.iterations)} iterations, "
          f"{result.n_trajectories} trajectories, "
          f"{result.n_pushes} pushes in {dt:.1f}s "
          f"({result.n_pushes / max(dt, 1e-9) / 1e6:.2f} M pushes/s)")
    print(f"outputs written to {os.path.abspath(args.out_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
