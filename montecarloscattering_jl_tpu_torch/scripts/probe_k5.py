"""K5's compile-time variants on a CUDA card: its block size and the
blocks an SM must hold (``__launch_bounds__``; csrc/helix_step.cu
K5_BLOCK, K5_MIN_BLOCKS), each built by ops/build.py into a library of
its own, all builds started together:

    python -m montecarloscattering_jl_tpu_torch.scripts.probe_k5 \
        [--variants 0,3,3,0]

For each variant of VARIANTS (or of the indices given, in their order;
by default all, the engine's build first and last, so that drift
shows):

* what ``-Xptxas -v`` says of the float64 instances' drain and window
  kernels (registers, stack frame, spill bytes), and the drain's blocks
  an SM from the CUDA runtime;
* the drain of the f64 flagship's 69,632 injected lanes at pcut 0 (the
  segment of chip_smoke.py phase k5, at the engine's helix cap) on the
  flagship's own instance and on the float64 run-time instance: device
  ms by CUDA events around the one launch, the mean of REPS after a
  warm-up; its lanes must equal the engine build's bit for bit;
* K5's block loop on the same lanes at the auto compaction depth
  (``run_segment(..., blocks=True)``): device ms a step at each window
  size, the last (2,176 lanes) the segment's tail;
* the f64 flagship (probe_driver.py ``f64_flagship``, 4 pcuts) through
  ``engine.driver.run``: wall, transport and each segment's drain ms.

Prints the card's name and power limit first, then a JSON line a
variant; exits 1 if a variant's lanes differ.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import sys

# the engine's build first and last; __launch_bounds__ at 2, 3 and 4
# blocks of 128 an SM (registers capped at 256, 170, 128 a thread);
# blocks of 64 (4 an SM by registers, like 2 of 128), at 6 and 8 an SM
VARIANTS = ({}, {"K5_MIN_BLOCKS": 2}, {"K5_MIN_BLOCKS": 3},
            {"K5_MIN_BLOCKS": 4}, {"K5_BLOCK": 64},
            {"K5_BLOCK": 64, "K5_MIN_BLOCKS": 6},
            {"K5_BLOCK": 64, "K5_MIN_BLOCKS": 8}, {})
REPS = 3


def ptxas(log: str) -> dict:
    """The float64 kernels of a build's ``-Xptxas -v`` log: "window -1",
    "drain 4096", ... -> registers, stack frame and spill bytes."""
    from montecarloscattering_jl_tpu_torch.ops import helix

    return {f"{kind} {word}": v
            for (f64, word), kinds in helix.ptxas_report(log).items() if f64
            for kind, v in kinds.items()}


def build_variants(order: list) -> dict:
    """The variants of `order` built at once (one nvcc each); their
    ptxas reports by variant index."""
    from montecarloscattering_jl_tpu_torch.ops import build

    keys = {k: build.log_key("helix_step", VARIANTS[k] or None)
            for k in order}
    targets = {keys[k]: ("helix_step", VARIANTS[k] or None, None)
               for k in order}
    with contextlib.redirect_stdout(io.StringIO()):
        build.build_all(list(targets.values()), verbose=True)
    return {k: ptxas(build.LOGS.get(key, "")) for k, key in keys.items()}


@contextlib.contextmanager
def variant_build(defines: dict):
    """Inside the block, K5's default build is the build with `defines`
    (built by ops/build.py, bound by ops/helix.py ``bind``): it takes
    the default build's place in ops/helix.py's cache of loaded
    libraries, so the engine's own launches run it; the cache is
    restored after."""
    from montecarloscattering_jl_tpu_torch.ops import build, helix

    lib = helix.bind(build.library("helix_step", defines or None))
    saved = helix._LIBS.pop(False, None)
    helix._LIBS[False] = lib
    try:
        yield lib
    finally:
        del helix._LIBS[False]
        if saved is not None:
            helix._LIBS[False] = saved


def flagship_segment(dev):
    """The f64 flagship's injected lanes at pcut 0 with its tables, a
    maker of fresh tallies and the engine's auto compaction depth."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl
    from montecarloscattering_jl_tpu_torch.scripts.probe_driver import (
        f64_flagship)

    cfg = f64_flagship()
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=dev, p_dtype=torch.float64)
    ss = eng.step_static(0)
    tb = xla_step.step_tables(eng.segment_grids(setup.profile),
                              eng.segment_scalars(0, 0, setup.profile.bmag2),
                              ss, dev)
    st0 = wl.flagship_population(setup, cfg, dev, lanes=eng.batch_size,
                                 p_dtype=torch.float64)
    b = setup.bins
    fresh = lambda: stt.make_tallies(setup.nb, b.n_mom, b.n_theta, dev,
                                     n_xspec=ss.n_xspec)
    return tb, st0, fresh, eng.compact_levels


def time_drain(tb, st0, fresh, instance: int):
    """Mean device ms of REPS drains of `st0` on K5's `instance` (after a
    warm-up), and the lanes of the last."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import helix
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    p = dataclasses.replace(helix.pack(tb), instance=instance)
    total = 0.0
    for r in range(REPS + 1):
        st, tl = stt.clone(st0), fresh()
        d = helix.HelixDrain(st, tl, p)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        d.enqueue(xla_step.MAX_HELIX_STEPS, xla_step.SYNC_EVERY)
        ev[1].record()
        d.finish()
        if r:
            total += ev[0].elapsed_time(ev[1])
    return total / REPS, st


def measure(k: int, defines: dict, said: dict, seg, ref) -> dict:
    import torch

    from montecarloscattering_jl_tpu_torch.ops import helix
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step
    from montecarloscattering_jl_tpu_torch.scripts.probe_driver import (
        f64_flagship, timed_run)

    tb, st0, fresh, levels = seg
    p = helix.pack(tb)
    rt = helix.instance_of(True, helix.CT_RUNTIME)
    out = dict(variant=k, defines=defines, ptxas=said,
               runtime=helix.instance_attrs(p.instance, tb.ss.nb + 1))
    ms, lanes = time_drain(tb, st0, fresh, p.instance)
    out["drain_ms"] = ms
    out["drain_ms_runtime_instance"] = time_drain(tb, st0, fresh, rt)[0]
    out["lanes_identical"] = ref is None or all(
        torch.equal(getattr(lanes, f.name), getattr(ref, f.name))
        for f in dataclasses.fields(st0))
    g = xla_step.GraphCache()
    g.timing = True
    xla_step.run_segment(stt.clone(st0), fresh(), tb, compact_levels=levels,
                         graphs=g, blocks=True)
    out["block_loop"] = dict(
        ms=g.segment_ms()[0]["ms"],
        step_ms={str(s): v[1] for s, v in g.step_ms().items()})
    xla_step.GraphCache.timing = True
    try:
        res, wall = timed_run(f64_flagship(), torch.float64)
    finally:
        xla_step.GraphCache.timing = False
    out["flagship"] = dict(
        wall=wall, transport=res.timers.totals["transport"],
        pushes=res.n_pushes, segments_ms=[
            s["ms"] for s in res.graphs.segment_ms()])
    return out, lanes


def main(argv=None) -> int:
    import argparse

    import torch

    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(
        str(k) for k in range(len(VARIANTS))),
        help="comma-separated indices into VARIANTS, in the order run")
    order = [int(k) for k in ap.parse_args(argv).variants.split(",")]
    if not torch.cuda.is_available():
        print("probe_k5: no CUDA device", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {wl.card_line()}")
    said = build_variants(order)
    seg = flagship_segment(torch.device("cuda:0"))
    ref, bad = None, []
    for k in order:
        with variant_build(VARIANTS[k]):
            out, lanes = measure(k, VARIANTS[k], said[k], seg, ref)
        ref = lanes if ref is None else ref
        if not out["lanes_identical"]:
            bad.append(k)
        print(f"probe_k5 {json.dumps(out)}", flush=True)
    if bad:
        print(f"probe_k5: the lanes of variants {bad} differ from the "
              f"engine build's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
