"""Profile one driven run of the port on a CUDA card: where the device
time goes, how much of the wall the device idles, and how often the host
waits for it.

    python -m montecarloscattering_jl_tpu_torch.scripts.profile_run f32
    python -m montecarloscattering_jl_tpu_torch.scripts.profile_run science

``f32`` is chip_smoke.py's flagship slice (tests/data/dsa_nonrel.toml,
65,536 particles per pcut, smoothing on, 2 iterations, float32 momenta
on K1); ``science`` its baseline science variant (configs/baseline.toml
with scattering, DSA and smoothing on, 4 pcuts per decade, 4x the
particles, a 200,000-step helix cap, 1 iteration, float32 on K1), both
as scripts/workloads.py builds them.

The run is made once unprofiled (warm-up: kernels built, allocator
filled), then once under ``torch.profiler`` (CPU and CUDA activities).
Printed: the profiled run's wall, pushes and phase timers; the device's
busy time (the sum of every kernel's and copy's device time) and its
idle share of the wall; the kernels by device time; K1's launches; and
the host's waits: calls of cudaStreamSynchronize, cudaDeviceSynchronize
and cudaEventSynchronize, and device-to-host copies (each of which
waits for the stream).  The profiler slows the host, so the idle share
is an upper bound.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
TOP = 12


def config(which: str):
    from montecarloscattering_jl_tpu_torch.utils import load_config

    from . import workloads as cs

    if which == "f32":
        cfg = load_config(cs.CFG)
        cfg.n_itrs = 2
        cfg.do_smoothing = True
        cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = cs.LANES
        return cfg, 0
    if which == "science":
        cfg = cs.load_variant(cs.BASELINE, n_itrs=1)
        cs.science_variant(cfg)
        return cfg, cs.SCIENCE_CAP
    raise SystemExit(f"unknown run {which!r}: f32 or science")


def drive(cfg, dev, cap: int):
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.ops import mega

    old = mega.MAX_HELIX_STEPS
    if cap:
        mega.MAX_HELIX_STEPS = cap
    try:
        with tempfile.TemporaryDirectory() as out:
            mega.LAUNCHES = mega.HOST_WAITS = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(cfg, device=dev, out_dir=out, p_dtype=torch.float32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        mega.MAX_HELIX_STEPS = old
    return res, wall, mega.LAUNCHES, mega.HOST_WAITS


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        print("profile_run: no CUDA device", file=sys.stderr)
        return 1
    from . import workloads as cs

    cfg, cap = config(sys.argv[1])
    dev = torch.device("cuda:0")
    print(f"card: {cs.card_line()}; run: {sys.argv[1]}")
    _, warm, _, _ = drive(cfg, dev, cap)
    print(f"unprofiled run: {warm:.3f} s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, wall, launches, waits = drive(cfg, dev, cap)
    phases = {k: round(v, 3) for k, v in res.timers.totals.items()}
    print(f"profiled run: {wall:.3f} s wall, {res.n_pushes} pushes, K1 "
          f"launches {launches}, host waits inside K1's drains {waits}; "
          f"phases {json.dumps(phases)}")
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
    print(f"device busy {busy_us / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall: "
          f"idle share {1.0 - busy_us / 1e6 / wall:.3f}")
    for e in sorted(rows, key=dev_time, reverse=True)[:TOP]:
        if dev_time(e) > 0:
            print(f"  {dev_time(e) / 1e3:10.2f} ms  {e.count:7d} x  "
                  f"{e.key[:90]}")
    calls = {e.key: e.count for e in every}
    syncs = {k: calls.get(k, 0) for k in SYNC_CALLS}
    d2h = sum(n for k, n in calls.items() if "Memcpy DtoH" in k)
    print(f"host waits: {json.dumps(syncs)}; device-to-host copies {d2h}; "
          f"K1 launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
