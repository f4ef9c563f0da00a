"""One run of one cell: set-up, a timed window of whole model runs of
the port, the check against the plain reference, and the result line.

Set-up (``setup_s``, from the process's start to the window's start)
imports torch and the port, sets the cell's environment first (the
configuration's ``env``, the kernel caches inside the checkout), loads
the frozen configuration, and warms up with one iteration of it at the
cell's precision: the port's kernels are built (the first run in a
checkout) or loaded from ``montecarloscattering_jl_tpu_torch/build/``,
and the allocator is filled.

The window runs ``engine.driver.run`` (the entry the CLI drives) on the
whole configuration, back to back, each run's ``random_seed`` made from
``--seed`` and the run's index, and each writing the CLI's files over
the last run's.  Runs start until ``--seconds`` have passed; the run in
flight completes and counts.  Around every drain the lanes' steps and
exits are counted on the device, and one drain and one split of each
run, drawn from the seed, are copied for the check (harness/lanes.py),
in every run alike.  With ``--trace 1`` the window runs under
torch.profiler and the per-layer metrics are read from it.  The process
runs torch with ``THREADS`` host threads, whatever the machine has.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import check, guard, lanes, manifest

# caches and the runs' files, at fixed paths inside the checkout
WORK = os.path.join(manifest.HERE, ".work")
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions"}
THREADS = 4


def process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)


def run_seed(seed: int, k: int) -> int:
    """The configuration's random_seed of the window's run `k`."""
    return (int(seed) * 256 + k % 256) & (2 ** 62 - 1)


@dataclass
class Run:
    seed: int
    wall_s: float
    pushes: int
    timers: dict


@dataclass
class Context:
    """What a metric's reader gets (metrics/<name>.py ``read``)."""

    p_dtype: str
    setup_s: float
    window_s: float
    runs: list = field(default_factory=list)
    trace: object = None


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_env(meta: dict) -> None:
    """The cell's environment, before torch or the port is imported: no
    inherited MCS_* switch, the configuration's own, the host threads
    and the caches."""
    for k in [k for k in os.environ if k.startswith("MCS_")]:
        del os.environ[k]
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = str(THREADS)
    os.environ.update({k: str(v) for k, v in meta.get("env", {}).items()})
    for k, d in CACHES.items():
        os.environ[k] = os.path.join(WORK, d)
        os.makedirs(os.environ[k], exist_ok=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: not available"
    return out.stdout.strip().replace("\n", "; ")


def err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv, t0: float) -> int:
    age = process_age()
    args = parse(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    chips = cell["workload"]["chips"]
    set_env(cell["meta"])

    # the interpreter's own start (site packages) to run.py's first
    # line, then run.py's imports (torch among them) to main's start
    now = time.perf_counter()
    marks = [("start", now - age), ("interpreter", t0),
             ("imports", now)]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"benchmark: needs {chips} CUDA device(s), found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    marks.append(("cuda", time.perf_counter()))
    try:
        from montecarloscattering_jl_tpu_torch.engine import driver  # noqa
    except ImportError as e:
        err(f"benchmark: the port is not importable here: {e}")
        return 2
    marks.append(("port", time.perf_counter()))
    err("set-up marks [s]: " + " ".join(
        f"{b[0]} {b[1] - a[1]:.4f}" for a, b in zip(marks, marks[1:])))
    line, checked = run_cell(cell, args, t0 - age, "cuda")
    err(f"card: {card_line()}; workload {args.workload}; seed {args.seed}")
    bad = guard.forbidden_loaded()
    if bad:
        err("benchmark: forbidden modules loaded: " + ", ".join(bad))
        return 3
    print(json.dumps(line), flush=True)
    for k, v in checked.items():
        err(f"check {k}: {v['value']!r} limit {v['limit']!r}")
    return 0


def run_cell(cell: dict, args, t_start: float, device: str):
    """Set-up, window and check of one run of `cell`; `t_start` is the
    process's start on the perf_counter clock.  Returns (the result
    line, the numbers checked).  `device` "cpu" runs the same on the
    CPU, for tests: no trace, and no device reading."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine import driver
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    p_dtype = cell["traffic"]["p_dtype"]
    dtype = getattr(torch, p_dtype)
    cfg = load_config(cell["toml"])
    out_dir = os.path.join(WORK, "out", cell["workload"]["name"])
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)

    torch.set_num_threads(THREADS)
    max_helix = int(os.environ.get("MCS_MAX_HELIX_STEPS", "10000"))
    capture = lanes.Capture(args.seed)
    capture.install()
    t_warm = time.perf_counter()
    warm = copy.deepcopy(cfg)
    warm.n_itrs = 1
    warm.random_seed = run_seed(args.seed, 0)
    driver.run(warm, device=device, out_dir=out_dir, p_dtype=dtype)
    shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    sync()

    runs, last, failed = [], None, 0
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    span = (torch.profiler.record_function("benchmark.window")
            if args.trace else contextlib.nullcontext())
    with span:
        while True:
            c = copy.deepcopy(cfg)
            c.random_seed = run_seed(args.seed, len(runs))
            capture.start_run(len(runs))
            r0 = time.perf_counter()
            try:
                res = driver.run(c, device=device, out_dir=out_dir,
                                 p_dtype=dtype)
                sync()
            except Exception:      # a run that fails is counted, not hidden
                traceback.print_exc()
                failed += 1
                break
            r1 = time.perf_counter()
            runs.append(Run(seed=c.random_seed, wall_s=r1 - r0,
                            pushes=int(res.n_pushes),
                            timers=dict(res.timers.totals)))
            last = res
            if r1 - w0 >= args.seconds:
                break
    w1 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    mem = torch.cuda.max_memory_allocated() if cuda else 0

    written = sum(os.path.getsize(os.path.join(out_dir, f))
                  for f in os.listdir(out_dir))
    err(f"setup {setup_s:.4f} s (to the warm-up {t_warm - t_start:.4f} s, "
        f"the warm-up iteration {w0 - t_warm:.4f} s); window "
        f"{w1 - w0:.4f} s, {len(runs)} runs; {written} bytes written a run")
    for r in runs:
        phases = " ".join(f"{k} {v:.4f}" for k, v in sorted(r.timers.items()))
        err(f"run seed {r.seed}: {r.wall_s:.4f} s, {r.pushes} pushes; "
            f"phases [s] {phases}")

    ctx = Context(p_dtype=p_dtype, setup_s=setup_s, window_s=w1 - w0,
                  runs=runs)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["workload"]["chips"], "memory_peak_bytes": int(mem)}
    out = {}
    if args.trace:
        from . import trace
        ctx.trace = trace.collect(prof, os.path.join(WORK, "trace.json"))
        prof = None
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                            "idle_gaps": ctx.trace.idle_gaps()}
    metrics = {}
    for m in cell["per_layer" if args.trace else "end_to_end"]:
        v = manifest.reader(m["name"]).read(ctx) if runs else None
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    capture.remove()
    limits = check.cell_limits(cell)
    own = cell["check"]
    if last is not None:
        t_check = time.perf_counter()
        numbers, seen = check.judge(
            capture, last, out_dir, device, max_helix, own=own,
            own_names=own.LIMITS[p_dtype] if own else ())
        err(f"check {time.perf_counter() - t_check:.4f} s: {seen}")
    else:
        numbers = {k: check.MISSING for k in limits}
    checked, ok = check.verdict(numbers, limits)
    line = {"correct": bool(ok and failed == 0 and runs),
            "attempted": len(runs) + failed, "failed": failed,
            "metrics": metrics, "device": dev, **out, "checked": checked}
    return line, checked
