"""Driver-level measurements on a CUDA card.

* ``--spread N``: N uninterrupted runs of the nonlinear flagship
  (scripts/flagship_nonlinear.py: 65,536 a pcut, 10 iterations, float32
  on K1), each iteration's pushes, trajectories, escaping fractions and
  max pxx_norm, and per quantity the largest difference between two runs
  over iterations 1-4 and 5-10.  K1 sums its tallies with atomics in no
  fixed order, and from iteration 2 on the profile is smoothed from
  them, so two runs may part; chip_smoke.py's nonlinear phase holds a
  resumed run to 3 times this spread.  Then one more run with
  MCS_SUBTIMERS=1 for the transport's split.
* ``--overlap``: the baseline's science variant (1 iteration, K1) and
  the SED flagship (examples/04 at 16,384 a pcut, K1) with the
  per-species reductions overlapped (MCS_OVERLAP_REDUCE=1) and not (=0),
  in the order on, off, off, on, after a warm-up run: wall, and the
  transport, reductions and io phases.
* ``--compact LEVELS``: the f64 flagship of chip_smoke.py's phase f64
  (float64 on the XLA engine, two x_spec detectors, 1 iteration, its
  first 4 pcuts) at each compaction depth of the comma-separated list
  (-1 auto): wall, transport, pushes/s, the ladders' launches, the
  graph captures and their seconds, the device ms a step at each
  window size (CUDA events around every block: a K5 launch, or a graph
  replay of the plain step in a checkout from before K5) and each
  segment's device ms.  A checkout with K5's drain runs each depth as
  the drain (mode "drain": one launch a segment, its ms from CUDA
  events around it) and as the block loop of K5 windows (mode
  "blocks"), a checkout from before it as the block loop.  A checkout
  without the ladder (its ``run`` takes no compact_levels) runs once,
  as "none".
* ``--mesh-spread N``: chip_smoke.py phase f32's run (the flagship at
  65,536 a pcut, 2 iterations, float32 on K1) with N random seeds (the
  config's and the next N - 1), once in this process and once on the
  mesh hybrid ladder of two ranks sharing the card (gloo): each run's
  pushes, trajectories and every segment's new lanes; over the run and
  over iteration 1, the largest relative difference (over the smaller)
  between two one-process runs, and each seed's mesh run against its
  one-process run.  The split makes
  n_saved * (target // n_saved) new lanes, which halves where n_saved
  crosses target / 2, so runs that are statistically the same differ in
  their counts (PERF.md, PR 9: why the mesh phase of chip_smoke.py
  holds the hybrid's counts to a bound in iteration 1 only).
* ``--mesh-hybrid N``: chip_smoke.py phase mesh part hybrid (the f32
  flagship of phase f32 on the mesh hybrid ladder of two ranks sharing
  the card, gloo, rank 0 writing the output files) after a warm-up
  run, N timed runs and one counted run: each rank's wall (ending in a
  synchronize), transport phase, pushes, K1 launches, collectives and
  their seconds; in the counted run, the host waits of each species'
  ladder under torch's sync debug mode (``TransportEngine
  ._ladder_async``, and in a checkout whose hybrid ran a loop of its
  own, ``_ladder_per_segment``) and its sync points.
* ``--cold``: the science variant and then the SED flagship once each,
  the process's first runs, as a CLI run is (the reductions' pinned
  host buffers are allocated anew): wall and phases.  With ``--root``
  the package of that checkout is measured, so that two checkouts
  compare in one call (the parent in a directory .gitignore lists).

Prints the card's name and power limit first.  Run by path, so that
``--root`` decides which checkout is imported:

    python montecarloscattering_jl_tpu_torch/scripts/probe_driver.py \\
        [--root DIR] [--spread 3] [--overlap] [--cold] [--compact 0,2,-1]
        [--mesh-spread 6] [--mesh-hybrid 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def timed_run(cfg, p_dtype, cap: int = 0, run_kw=None, **env):
    """One ``engine.driver.run`` on the card with its outputs written to
    a temporary directory, the helix cap `cap` when given, `run_kw` to
    ``run`` and the environment variables `env` set for it; returns
    (result, wall s)."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.ops import mega
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    caps = (mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS)
    old = {k: os.environ.get(k) for k in env}
    if cap:
        mega.MAX_HELIX_STEPS = xla_step.MAX_HELIX_STEPS = cap
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory() as out:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(cfg, "cuda", out_dir=out, p_dtype=p_dtype,
                      **(run_kw or {}))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS = caps
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    return res, wall


def spread(n_runs: int) -> dict:
    import torch

    from montecarloscattering_jl_tpu_torch.scripts import (
        flagship_nonlinear as fn, workloads as wl)

    runs = []
    for i in range(n_runs):
        res, wall = timed_run(fn.nonlinear_config(wl.LANES, 10),
                              torch.float32)
        rows = fn.iteration_rows(res)
        runs.append(rows)
        print(f"spread run {i + 1}: wall {wall:.3f} s, {res.n_pushes} "
              f"pushes ({res.n_pushes / wall / 1e6:.1f} M pushes/s), "
              f"phases {json.dumps(res.timers.totals)}")
        for r in rows:
            print(f"  {json.dumps(r)}")
    out = {}
    for span, sl in (("1-4", slice(0, 4)), ("5-10", slice(4, 10))):
        out[span] = {
            key: max(abs(a[key] - b[key])
                     for i, ra in enumerate(runs) for rb in runs[i + 1:]
                     for a, b in zip(ra[sl], rb[sl]))
            for key in ("pushes", "trajectories", "px_esc_frac",
                        "en_esc_frac", "pxx_norm_max")}
        print(f"spread, iterations {span}, largest difference between "
              f"two runs: {json.dumps(out[span])}")
    res, wall = timed_run(fn.nonlinear_config(wl.LANES, 10), torch.float32,
                          MCS_SUBTIMERS="1")
    print(f"subtimed run: wall {wall:.3f} s, transport "
          f"{res.timers.totals['transport']:.3f} s, split "
          f"{json.dumps(res.subtimers)}, launches "
          f"{json.dumps(getattr(res, 'launches', None))}")
    return out


def f32_flagship(seed: int | None = None):
    """chip_smoke.py phase f32's config (2 iterations, smoothing on,
    wl.LANES a pcut), with another random seed where given."""
    from montecarloscattering_jl_tpu_torch.scripts import (
        flagship_nonlinear as fn, workloads as wl)

    cfg = fn.nonlinear_config(wl.LANES, 2)
    if seed is not None:
        cfg.random_seed = seed
    return cfg


def count_rows(res) -> list:
    """Per iteration: pushes, trajectories, each segment's new lanes."""
    return [dict(pushes=f.n_pushes, trajectories=f.n_trajectories,
                 n_new=f.n_new)
            for itr in res.iterations for f in itr.ion_finals]


def mesh_spread_rank(mesh, seeds) -> list:
    """One rank of --mesh-spread: the f32 flagship on the mesh hybrid
    ladder for each seed; (rows, wall s) a seed."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run

    out = []
    for seed in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(f32_flagship(seed), mesh.device, p_dtype=torch.float32,
                  mesh=mesh)
        torch.cuda.synchronize()
        out.append((count_rows(res), time.perf_counter() - t0))
    return out


def mesh_spread(n_seeds: int) -> dict:
    import torch

    from montecarloscattering_jl_tpu_torch.parallel import multihost

    seeds = [f32_flagship().random_seed + k for k in range(n_seeds)]
    total = lambda rows, key: sum(r[key] for r in rows)
    single = []
    for seed in seeds:
        res, wall = timed_run(f32_flagship(seed), torch.float32)
        single.append(count_rows(res))
        print(f"mesh-spread seed {seed}, one process: wall {wall:.3f} s, "
              f"{json.dumps(single[-1])}")
    mesh = multihost.spawn(mesh_spread_rank, 2, args=(seeds,),
                           backend="gloo", device="cuda", timeout=1800)[0]
    for seed, (rows, wall) in zip(seeds, mesh):
        print(f"mesh-spread seed {seed}, mesh hybrid (2 ranks sharing the "
              f"card, gloo): wall {wall:.3f} s, {json.dumps(rows)}")
    out = {}
    for span, sl in (("run", slice(None)), ("iteration 1", slice(0, 1))):
        out[span] = dict(single={}, mesh={})
        for key in ("pushes", "trajectories"):
            vals = [total(r[sl], key) for r in single]
            out[span]["single"][key] = max(
                abs(a - b) / min(a, b)
                for i, a in enumerate(vals) for b in vals[i + 1:])
            out[span]["mesh"][key] = [
                abs(total(m[sl], key) - v) / min(total(m[sl], key), v)
                for (m, _), v in zip(mesh, vals)]
        print(f"mesh-spread, {span}: largest relative difference between "
              f"two one-process runs {json.dumps(out[span]['single'])}; "
              f"each mesh run against its seed's one-process run "
              f"{json.dumps(out[span]['mesh'])}")
    return out


def counted_ladder_waits(engine_cls, rows: list):
    """Each fused or per-segment ladder method of `engine_cls` wrapped to
    run under torch's sync debug mode and append to `rows` its host waits
    and the engine's sync points it made; returns a function that
    restores them."""
    import functools
    import warnings

    import torch

    saved = {}
    for name in ("_ladder_async", "_ladder_per_segment"):
        base = getattr(engine_cls, name, None)
        if base is None:
            continue
        saved[name] = base

        @functools.wraps(base)
        def counted(self, *a, _base=base, _name=name, **kw):
            syncs = getattr(self, "sync_points", 0)
            with warnings.catch_warnings(record=True) as said:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return _base(self, *a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    rows.append(dict(
                        ladder=_name,
                        waits=sum("synchronizing CUDA operation"
                                  in str(w.message) for w in said),
                        sync_points=getattr(self, "sync_points", 0)
                        - syncs))

        setattr(engine_cls, name, counted)
    return lambda: [setattr(engine_cls, k, v) for k, v in saved.items()]


def mesh_hybrid_rank(mesh, n_runs: int) -> list:
    """One rank of --mesh-hybrid: a warm-up run, `n_runs` timed runs and
    one counted run of the f32 flagship on the mesh hybrid ladder."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine

    out = []
    for kind in ["warm-up"] + ["timed"] * n_runs + ["counted"]:
        ladders = []
        restore = (counted_ladder_waits(TransportEngine, ladders)
                   if kind == "counted" else lambda: None)
        c0, s0 = mesh.collectives, mesh.collective_s
        try:
            with tempfile.TemporaryDirectory() as d:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run(f32_flagship(), mesh.device, out_dir=d,
                          p_dtype=torch.float32, mesh=mesh)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            restore()
        out.append(dict(
            kind=kind, rank=mesh.rank, wall=wall,
            transport=res.timers.totals["transport"], pushes=res.n_pushes,
            k1=(getattr(res, "launches", None) or {}).get("k1"),
            collectives=mesh.collectives - c0,
            collective_s=mesh.collective_s - s0, ladders=ladders))
    return out


def mesh_hybrid(n_runs: int) -> None:
    from montecarloscattering_jl_tpu_torch.parallel import multihost

    ranks = multihost.spawn(mesh_hybrid_rank, 2, args=(n_runs,),
                            backend="gloo", device="cuda", timeout=1800)
    for runs in zip(*ranks):
        for r in runs:
            print(f"mesh-hybrid {json.dumps(r)}", flush=True)


def overlap() -> None:
    import torch

    from montecarloscattering_jl_tpu_torch.scripts import (
        flagship_sed, workloads as wl)

    def science():
        cfg = wl.load_variant(wl.BASELINE, n_itrs=1)
        wl.science_variant(cfg)
        return cfg

    cases = (("science", science, wl.SCIENCE_CAP),
             ("sed", lambda: flagship_sed.sed_config(16_384), 0))
    for tag, make, cap in cases:
        timed_run(make(), torch.float32, cap)          # warm-up
        for flag in ("1", "0", "0", "1"):
            res, wall = timed_run(make(), torch.float32, cap,
                                  MCS_OVERLAP_REDUCE=flag)
            t = res.timers.totals
            print(f"overlap {tag} MCS_OVERLAP_REDUCE={flag}: wall "
                  f"{wall:.3f} s, transport {t['transport']:.3f} s, "
                  f"reductions {t['reductions']:.3f} s, io "
                  f"{t.get('io', 0.0):.3f} s, {res.n_pushes} pushes")


def f64_flagship():
    """chip_smoke.py phase f64's config: the flagship at float64 with two
    x_spec detectors, 1 iteration, wl.LANES a pcut, its first 4 pcuts."""
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(wl.CFG)
    cfg.n_itrs = 1
    cfg.do_smoothing = True
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = wl.LANES
    cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    cfg.pcuts = cfg.pcuts[:4]
    return cfg


def compact(levels: list) -> None:
    import functools
    import inspect

    import torch

    from montecarloscattering_jl_tpu_torch.engine import driver
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    # a checkout with K5's drain runs each depth twice: the drain (the
    # engine's path) and the block loop of K5 windows (run_segment's
    # ``blocks`` keyword, patched in for the run)
    segment = xla_step.run_segment
    modes = ([("drain", segment),
              ("blocks", functools.partial(segment, blocks=True))]
             if "blocks" in inspect.signature(segment).parameters
             else [("blocks", segment)])
    if "compact_levels" not in inspect.signature(driver.run).parameters:
        levels = [None]
    else:
        xla_step.GraphCache.timing = True
    for lv in levels:
        for mode, fn in modes:
            kw = {} if lv is None else dict(compact_levels=lv)
            xla_step.run_segment = fn
            try:
                res, wall = timed_run(f64_flagship(), torch.float64,
                                      run_kw=kw)
            finally:
                xla_step.run_segment = segment
            t = res.timers.totals
            out = dict(levels="none" if lv is None else lv, mode=mode,
                       wall=wall, transport=t["transport"],
                       pushes=res.n_pushes,
                       pushes_per_s=res.n_pushes / wall,
                       trajectories=res.n_trajectories,
                       launches=getattr(res, "launches", None))
            g = getattr(res, "graphs", None)
            if g is not None:
                out.update(captures=g.captures, capture_s=g.capture_s,
                           step_ms={str(k): v
                                    for k, v in g.step_ms().items()})
                if hasattr(g, "segment_ms"):
                    out["segments"] = g.segment_ms()
            print(f"compact {json.dumps(out)}", flush=True)


def cold() -> None:
    import torch

    from montecarloscattering_jl_tpu_torch.scripts import (
        flagship_sed, workloads as wl)

    cfg = wl.load_variant(wl.BASELINE, n_itrs=1)
    wl.science_variant(cfg)
    for tag, c, cap in (("science", cfg, wl.SCIENCE_CAP),
                        ("sed", flagship_sed.sed_config(16_384), 0)):
        res, wall = timed_run(c, torch.float32, cap)
        t = res.timers.totals
        print(f"cold {tag} MCS_OVERLAP_REDUCE="
              f"{os.environ.get('MCS_OVERLAP_REDUCE', 'unset')}: wall "
              f"{wall:.3f} s, transport {t['transport']:.3f} s, reductions "
              f"{t['reductions']:.3f} s, io {t.get('io', 0.0):.3f} s, "
              f"{res.n_pushes} pushes")


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here,
                    help="the checkout whose package is measured")
    ap.add_argument("--spread", type=int, default=0,
                    help="uninterrupted nonlinear flagship runs (>= 2)")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--mesh-spread", type=int, default=0,
                    help="seeds of the f32 flagship, one process against "
                         "the mesh hybrid (>= 2)")
    ap.add_argument("--mesh-hybrid", type=int, default=0,
                    help="timed runs of the f32 flagship on the mesh "
                         "hybrid ladder of two ranks")
    ap.add_argument("--compact", default="",
                    help="comma-separated compaction depths of the f64 "
                         "flagship (-1 auto)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import montecarloscattering_jl_tpu_torch as pkg
    from montecarloscattering_jl_tpu_torch.ops import build
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        ap.error(f"the package was imported from {pkg.__file__}, not from "
                 f"{root}: run this file by path")
    if not torch.cuda.is_available():
        print("probe_driver: no CUDA device", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {wl.card_line()}; root: {root}")
    # the library sources (a checkout from before the f(r_g) build of K5
    # has a library of every csrc/*.cu)
    build.build_all(getattr(build, "LIBRARIES", None) or sorted(
        src.stem for src in build.CSRC.glob("*.cu")))
    if args.cold:
        cold()
    if args.spread >= 2:
        spread(args.spread)
    if args.overlap:
        overlap()
    if args.compact:
        compact([int(v) for v in args.compact.split(",")])
    if args.mesh_spread >= 2:
        mesh_spread(args.mesh_spread)
    if args.mesh_hybrid:
        mesh_hybrid(args.mesh_hybrid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
