"""Profile one driven run of the port on a CUDA card: where the device
time goes, how much of the wall the device idles, and how often the host
waits for it.

    python montecarloscattering_jl_tpu_torch/scripts/profile_run.py \\
        [--root DIR] f32|f64|science|shipped

``f32`` is chip_smoke.py's flagship slice (tests/data/dsa_nonrel.toml,
65,536 particles per pcut, smoothing on, 2 iterations, float32 momenta
on K1); ``f64`` its float64 flagship (the same at float64 with two
x_spec detectors at -/+0.5 r_g0, 1 iteration, its first 4 pcuts: the
XLA engine, one K5 drain a segment); ``science`` its baseline science
variant (configs/baseline.toml with scattering, DSA and smoothing on, 4
pcuts per decade, 4x the particles, a 200,000-step helix cap, 1
iteration, float32 on K1), all as scripts/workloads.py builds them;
``shipped`` configs/baseline.toml as shipped (no-scatter, no-DSA) at
float64, 1 iteration (K5's drain).
With ``--root`` the package of that checkout is measured (run this
file by path), so that two checkouts compare in one call.

The run is made once unprofiled (warm-up: kernels built, allocator
filled), once more unprofiled (its wall and transport phase are the
run's), then once under ``torch.profiler`` (CPU and CUDA activities).
Printed: the profiled run's wall, pushes and phase timers; the device's
busy time (the sum of every kernel's and copy's device time) and its
idle share of the wall; the kernels by device time; K1's and K5's
launches; and the host's waits: calls of cudaStreamSynchronize,
cudaDeviceSynchronize and cudaEventSynchronize, and device-to-host
copies (each of which waits for the stream).  The profiler slows the
host, so the idle share is an upper bound.  The last line is the
numbers as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
TOP = 12
F64_PCUTS = 4


def config(which: str):
    """(config, helix cap or 0, momentum dtype) of a run."""
    import torch

    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl
    from montecarloscattering_jl_tpu_torch.utils import load_config

    if which in ("f32", "f64"):
        cfg = load_config(wl.CFG)
        cfg.n_itrs = 2 if which == "f32" else 1
        cfg.do_smoothing = True
        cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = wl.LANES
        if which == "f32":
            return cfg, 0, torch.float32
        cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
        cfg.pcuts = cfg.pcuts[:F64_PCUTS]
        return cfg, 0, torch.float64
    if which == "science":
        cfg = wl.load_variant(wl.BASELINE, n_itrs=1)
        wl.science_variant(cfg)
        return cfg, wl.SCIENCE_CAP, torch.float32
    if which == "shipped":
        return wl.load_variant(wl.BASELINE, n_itrs=1), 0, torch.float64
    raise SystemExit(f"unknown run {which!r}: f32, f64, science or "
                     f"shipped")


def drive(cfg, dev, cap: int, p_dtype):
    """One run; (result, wall s, K1 launches, K5 launches)."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.ops import helix, mega
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    old = (mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS)
    if cap:
        mega.MAX_HELIX_STEPS = xla_step.MAX_HELIX_STEPS = cap
    try:
        with tempfile.TemporaryDirectory() as out:
            mega.LAUNCHES = helix.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(cfg, device=dev, out_dir=out, p_dtype=p_dtype)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS = old
    return res, wall, mega.LAUNCHES, helix.LAUNCHES


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here,
                    help="the checkout whose package is measured")
    ap.add_argument("run", choices=("f32", "f64", "science", "shipped"))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import montecarloscattering_jl_tpu_torch as pkg
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        ap.error(f"the package was imported from {pkg.__file__}, not from "
                 f"{root}: run this file by path")
    if not torch.cuda.is_available():
        print("profile_run: no CUDA device", file=sys.stderr)
        return 1
    cfg, cap, p_dtype = config(args.run)
    dev = torch.device("cuda:0")
    print(f"card: {wl.card_line()}; run: {args.run}; root: {root}")
    _, warm, _, _ = drive(cfg, dev, cap, p_dtype)
    plain, plain_wall, _, _ = drive(cfg, dev, cap, p_dtype)
    print(f"unprofiled runs: {warm:.3f} s (warm-up), {plain_wall:.3f} s "
          f"(transport {plain.timers.totals['transport']:.4f} s)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, wall, k1, k5 = drive(cfg, dev, cap, p_dtype)
    phases = {k: round(v, 4) for k, v in res.timers.totals.items()}
    print(f"profiled run: {wall:.3f} s wall, {res.n_pushes} pushes, K1 "
          f"launches {k1}, K5 launches {k5}; phases {json.dumps(phases)}")
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    every = prof.key_averages()
    # the device's own rows (kernels and copies): a host operator's row
    # repeats the device time of the kernels it launched
    rows = [e for e in every
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_time(e) for e in rows)
    if not busy_us > 0:
        raise RuntimeError("the profiler recorded no device time")
    idle = 1.0 - busy_us / 1e6 / wall
    print(f"device busy {busy_us / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall: "
          f"idle share {idle:.3f}")
    for e in sorted(rows, key=dev_time, reverse=True)[:TOP]:
        if dev_time(e) > 0:
            print(f"  {dev_time(e) / 1e3:10.2f} ms  {e.count:7d} x  "
                  f"{e.key[:90]}")
    calls = {e.key: e.count for e in every}
    syncs = {k: calls.get(k, 0) for k in SYNC_CALLS}
    d2h = sum(n for k, n in calls.items() if "Memcpy DtoH" in k)
    print(f"host waits: {json.dumps(syncs)}; device-to-host copies {d2h}")
    print(json.dumps(dict(
        run=args.run, root=root, warm_wall=warm, wall=plain_wall,
        transport=plain.timers.totals["transport"], profiled_wall=wall,
        profiled_transport=res.timers.totals["transport"],
        pushes=res.n_pushes, busy_ms=busy_us / 1e3, idle_share=idle,
        sync_every=os.environ.get("MCS_HYBRID_SYNC_EVERY", "8"),
        k1_launches=k1, k5_launches=k5, d2h_copies=d2h, **syncs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
