"""The controls and the sound readings of `correct`'s numbers, on the
card, at a cell's own size: for each seed, one whole run of the cell's
configuration through engine.driver.run (the first run of that seed's
window), then the numbers the benchmark compares (harness/check.py),
read two ways: the program's outputs (sound), and the plain reference
computed in the next lower precision put in the program's place (the
control: float32 for a float64 cell, bfloat16 for a float32 cell).
The numbers of the configuration's own check (checks/<configuration>.py),
where it has one, are read both ways too, after the shared ones.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 ...

One JSON line a seed and reading.  The benchmark's own runs do not run
this; PERF.md keeps its readings beside the limits set from them."""

import argparse
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import check, lanes, main as hm, manifest  # noqa: E402

CONTROLS = {"float64": "float32", "float32": "bfloat16"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    hm.set_env(cell["meta"])
    import torch

    from montecarloscattering_jl_tpu_torch.engine import driver
    from montecarloscattering_jl_tpu_torch.utils import load_config

    torch.set_num_threads(hm.THREADS)
    p_dtype = cell["traffic"]["p_dtype"]
    own = cell["check"]
    own_names = own.LIMITS[p_dtype] if own else ()
    max_helix = int(os.environ.get("MCS_MAX_HELIX_STEPS", "10000"))
    out_dir = os.path.join(hm.WORK, "control", args.workload)
    capture = lanes.Capture(0)
    capture.install()
    for seed in args.seeds:
        shutil.rmtree(out_dir, ignore_errors=True)
        cfg = load_config(cell["toml"])
        cfg.random_seed = hm.run_seed(seed, 0)
        capture.seed = seed
        capture.start_run(0)
        t0 = time.perf_counter()
        res = driver.run(cfg, device=args.device, out_dir=out_dir,
                         p_dtype=getattr(torch, p_dtype))
        if args.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name in ("program", CONTROLS[p_dtype]):
            low = None if name == "program" else getattr(torch, name)
            t1 = time.perf_counter()
            got, seen = check.judge(capture, res, out_dir, args.device,
                                    max_helix, low=low, own=own,
                                    own_names=own_names)
            print(json.dumps(dict(
                workload=args.workload, seed=seed, reading=name,
                run_s=wall, check_s=time.perf_counter() - t1,
                pushes=res.n_pushes, **{k: float(v) for k, v in got.items()},
                seen=seen)), flush=True)
        del res
    capture.remove()
    return 0


if __name__ == "__main__":
    sys.exit(main())
