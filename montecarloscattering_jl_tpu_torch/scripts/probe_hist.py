"""Micro-benchmark of the PSD histogram kernels on a CUDA card.

Counterpart of scripts/probe_hist.py of the JAX package, on its
synthetic records (``synth``: seed 42, R = 2^21 records, cells in a
band, zones near the shock, crossing rate 0.25).  Each kernel runs
beside its plain version (ops/hist.py) on the same records:

  K2        psd_scatter (csrc/psd_hist.cu psd_scatter_kernel) at the
            transport path's shape (one record per lane of the
            flagship's 69,632-lane batch) and at R records; its plain
            version is P0's counterpart
  K3        psd_scatter_band at bands 1,024 and 2,048 (P3's counterpart;
            records outside the band contribute nothing), and on the
            edge cases of its contract (``k3_edge_cases``: the band at
            cell 0, a band past the array's end, all weights zero,
            boundary indices outside [0, nzc), every record on one
            address)
  K4 = K2   K2 at P4's 2^16 records (P4's one-record-at-a-time scatter
            is K2's function)

and K2 on more inputs at the path's record count: every record on one
address (the worst case of same-address atomics); the synthetic records
as the helix step hands them over (int64 zones, float64 weights); and,
when run as a script, the float64 helix step's own records
(``step_records``): the flagship's injected population, 69,632 lanes,
stepped eagerly, its (cell, lo, hi, w) kept at steps STEP_RECORDS, early
(every lane at the shock) and late in the segment.

For each it reports ms and ns/record of the kernel and of the plain
version, the kernel's max abs error against the plain version, the
largest entry, and both against the float64 NumPy reference
``ref_result`` (``band_ref`` for K3).  Beside them: the bound,
the least time an H100 SXM could take (the records read once, and each
PSD entry that a nonzero record -- within the band, for K3 -- adds to
read and written once, 4 B each way, at 3.35 TB/s; the entries no
record touches need no traffic, and the two adds a record are far below
the compute rate), and for K2/K4 the time of one ``index_add_``
of the records' (lo, +w) and (hi + 1, -w) entries into the flat PSD
(the library call; K3's band filter has none, and the port never calls
it).

Every kernel, and K2's ``index_add_``, is timed two ways.  ``ms`` and
``library_ms`` are device time a launch under CUDA-graph replay
(``graph_ms``: GRAPH_LAUNCHES launches captured into one graph, CUDA
events around its replays), which is how the transport path launches K2
(ops/step.py replays 64-step blocks) and leaves the host out.
``eager_ms`` and ``library_eager_ms`` are CUDA events around eager calls
from Python (``time_ms``; K2 through its prepared ``ScatterLaunch``):
where the host needs longer to make a call than the card to run it,
they read the host.

Usage, by path:

    python montecarloscattering_jl_tpu_torch/scripts/probe_hist.py \\
        [--root DIR [--narrow] [--eager-k3]] [--k3-only]

``--root`` is the root of the checkout whose wrappers and engine are
imported (default: the one this file lies in); an older commit unpacked
with ``git archive`` serves as the parent of a comparison, timed by this
file.  ``--narrow`` is for a checkout whose K2 takes int32 zones and
float32 weights only and has no prepared launch: it is called through
``psd_scatter``, and the int64 / float64 case is left out.
``--eager-k3`` is for a checkout whose K3 cannot be captured into a
graph (one whose K3 wrapper copies 2^30 from the host on every call,
as the slab kernel's did): K3 is timed eagerly only there.
``--k3-only`` runs K3's cases alone.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

R = 2 ** 21
BAND = 2048              # the cell span synth draws from (probe's BAND)
N_CELLS = 4428           # the flagship's 2 * (n_mom + 1) * (n_theta + 1)
NZC = 102                # nb + 1
CROSS_RATE = 0.25
R4 = 2 ** 16             # P4's record count
RECORD_BYTES = 16        # cell, lo, hi (int32) and w (float32)
HBM_BYTES_S = 3.35e12    # H100 SXM
GRAPH_LAUNCHES = 64      # launches captured into one graph (graph_ms)
PATH_RECORDS = 69_632    # the flagship batch: one record a lane a step
STEP_RECORDS = (2, 256, 2048)   # helix steps whose records are kept


def synth(r: int, rng: np.random.Generator):
    """Synthetic records (probe_hist.py:43-51): cells in a band, zones
    near the shock, a quarter of them crossing (w != 0)."""
    cell = rng.integers(1200, 1200 + int(BAND * 0.9), r).astype(np.int32)
    lo = rng.integers(20, 60, r).astype(np.int32)
    hi = lo + rng.integers(0, 3, r).astype(np.int32)
    w = (rng.random(r, np.float32) + 0.1) * (
        rng.random(r) < CROSS_RATE).astype(np.float32)
    return cell, lo, hi, w


def ref_result(cell, lo, hi, w) -> np.ndarray:
    """The float64 NumPy histogram (probe_hist.py:220-225)."""
    flat = np.zeros((N_CELLS * NZC,), np.float64)
    base = np.asarray(cell, np.int64) * NZC
    np.add.at(flat, base + np.asarray(lo), np.asarray(w, np.float64))
    np.add.at(flat, base + np.asarray(hi) + 1, -np.asarray(w, np.float64))
    return flat.reshape(N_CELLS, NZC)


def band_ref(cell, lo, hi, w, band: int) -> np.ndarray:
    """K3's contract in float64 NumPy: ref_result of the records with
    w != 0 and blo <= cell < blo + band, blo the least cell of a nonzero
    record (2^30 when there is none), cell inside the array, each
    boundary index outside [0, NZC) dropped."""
    flat = np.zeros((N_CELLS * NZC,), np.float64)
    for idx, v in _band_entries(cell, lo, hi, w, band):
        np.add.at(flat, idx, v)
    return flat.reshape(N_CELLS, NZC)


def _band_entries(cell, lo, hi, w, band: int):
    """[(flat index, value)] of the +w and the -w side of K3's records,
    a dropped entry as +0.0 at index 0 (adding it changes no sum)."""
    cell = np.asarray(cell, np.int64)
    w = np.asarray(w, np.float64)
    blo = int(np.min(np.where(w != 0, cell, 2 ** 30), initial=2 ** 30))
    keep = ((w != 0) & (cell >= blo) & (cell < blo + band) & (cell >= 0)
            & (cell < N_CELLS))
    out = []
    for z, v in ((np.asarray(lo, np.int64), w),
                 (np.asarray(hi, np.int64) + 1, -w)):
        ok = keep & (z >= 0) & (z < NZC)
        out.append((np.where(ok, cell * NZC + z, 0), np.where(ok, v, 0.0)))
    return out


def k3_edge_cases(r: int, rng: np.random.Generator) -> dict:
    """{name: ((cell, lo, hi, w), band)}: the edge cases of K3's
    contract, each on r synth records but "empty", which has none."""
    cell, lo, hi, w = synth(r, rng)
    at0 = cell - cell.min()
    at0[0], w_at0 = 0, w.copy()
    w_at0[0] = np.float32(1.0)
    wild_lo = rng.integers(-6, NZC + 4, r).astype(np.int32)
    one = (np.full(r, 2000, np.int32), np.full(r, 40, np.int32),
           np.full(r, 41, np.int32), w + np.float32(0.5))
    e = np.zeros(0, np.int32)
    return {
        "band at cell 0": ((at0, lo, hi, w_at0), 1024),
        "band past the array's end": (
            (cell + np.int32(N_CELLS - 1200 - int(BAND * 0.9)), lo, hi, w),
            2048),
        "all weights zero": ((cell, lo, hi, np.zeros_like(w)), 2048),
        "wild lo / hi": ((cell, wild_lo, wild_lo + (hi - lo), w), 1024),
        "one address": (one, 1024),
        "empty": ((e, e, e, np.zeros(0, np.float32)), 1024),
    }


def touched_entries(cell, lo, hi, w, band: int = 0) -> int:
    """The distinct PSD entries the nonzero records add to (K3's, by
    its contract, when `band` is given)."""
    if band:
        idx = [i[v != 0] for i, v in _band_entries(cell, lo, hi, w, band)]
        return int(np.unique(np.concatenate(idx)).size)
    keep = w != 0
    base = np.asarray(cell[keep], np.int64) * NZC
    return int(np.unique(np.concatenate([base + lo[keep],
                                         base + hi[keep] + 1])).size)


def max_rel_err(got: torch.Tensor, want: np.ndarray) -> float:
    g = got.double().cpu().numpy()
    return float(np.abs(g - want).max() / max(np.abs(want).max(), 1e-30))


def time_ms(fn, n: int = 20) -> float:
    """Mean ms of fn() over n calls after a warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int = GRAPH_LAUNCHES, replays: int = 10) -> float:
    """Mean device ms of one fn() among n captured into one CUDA graph,
    by CUDA events around `replays` replays after a warm-up replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def _case(dev, records, want, kernel, plain, library: bool,
          touched: int, narrow: bool = False, graph: bool = True) -> dict:
    """One kernel on one record set: its result against the plain
    version's and `want` (float64), and its times.  `library`: K2, timed
    through its prepared launch beside one index_add_; `graph`: the
    kernel is timed under graph replay as well as eagerly."""
    from montecarloscattering_jl_tpu_torch.ops import hist

    args = [torch.from_numpy(a).to(dev) for a in records]
    new = lambda: torch.zeros(N_CELLS, NZC, dtype=torch.float32,
                              device=dev)
    got, ref = new(), new()
    kernel(got, *args)
    plain(ref, *args)
    torch.cuda.synchronize()
    psd = new()
    n = len(records[0])
    plain_ms = time_ms(lambda: plain(psd, *args))
    library_ms = library_eager_ms = None
    launch = lambda: kernel(psd, *args)
    if library and not narrow:
        # K2 through its prepared launch
        launch = hist.ScatterLaunch(psd, *args).launch
    eager_ms = time_ms(launch)
    ms = graph_ms(launch) if graph else eager_ms
    if library:
        # one index_add_ of the same entries, the same two ways
        cell, lo, hi, w = args
        base = cell.long() * NZC
        idx = torch.cat([base + lo.long(), base + hi.long() + 1])
        vals = torch.cat([w, -w]).to(torch.float32)
        flat = psd.view(-1)
        library_eager_ms = time_ms(lambda: flat.index_add_(0, idx, vals))
        library_ms = graph_ms(lambda: flat.index_add_(0, idx, vals))
    bound_ms = (n * RECORD_BYTES + 2 * touched * 4) / HBM_BYTES_S * 1e3
    return dict(records=n, touched_entries=touched, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, eager_ms=eager_ms,
                library_eager_ms=library_eager_ms,
                bound_ms=bound_ms, bound_by="bytes",
                bound_share=bound_ms / ms,
                ns_per_record=ms * 1e6 / n,
                plain_ns_per_record=plain_ms * 1e6 / n,
                max_abs_err=float((got - ref).abs().max()),
                max_abs_psd=float(ref.abs().max()),
                rel_err_f64=max_rel_err(got, want),
                plain_rel_err_f64=max_rel_err(ref, want))


def step_records(dev, workloads, steps=STEP_RECORDS) -> dict:
    """{step: (cell, lo, hi, w)} as int32 / float32 NumPy arrays: what
    the float64 helix step (ops/step.py helix_step) hands K2 at those
    step numbers, from the flagship's injected population at
    PATH_RECORDS lanes stepped eagerly (`workloads`: the
    scripts/workloads.py module)."""
    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import hist, rng, step
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(workloads.CFG)
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=dev)
    prof = setup.profile
    tb = step.step_tables(eng.segment_grids(prof),
                          eng.segment_scalars(0, 2, prof.bmag2),
                          eng.step_static(0), dev)
    st = workloads.flagship_population(setup, cfg, dev, PATH_RECORDS,
                                       p_dtype=torch.float64)
    tl = stt.make_tallies(setup.nb, setup.bins.n_mom, setup.bins.n_theta,
                          dev)
    kept, now = {}, [0]
    k2 = hist.psd_scatter

    def keeping(psd, cell, lo, hi, w):
        if now[0] in steps:
            kept[now[0]] = tuple(
                a.to(dt).cpu().numpy() for a, dt in zip(
                    (cell, lo, hi, w), (torch.int32,) * 3 + (torch.float32,)))
        k2(psd, cell, lo, hi, w)

    hist.psd_scatter = keeping
    try:
        for now[0] in range(1, max(steps) + 1):
            step.helix_step(st, tl, tb, rng.lane_uniforms_xla(
                st.key0, st.key1, st.nsteps), step.MAX_HELIX_STEPS)
    finally:
        hist.psd_scatter = k2
    return kept


def run(device, narrow: bool = False, extra: dict | None = None,
        eager_k3: bool = False, k3_only: bool = False) -> dict:
    """Time and check every kernel against its plain version on `device`
    (a CUDA device); returns {name: numbers}.  `extra`: more K2 cases,
    {name: (cell, lo, hi, w)} of int32 / float32 NumPy records.
    `narrow`, `eager_k3`, `k3_only`: see the module's text."""
    from montecarloscattering_jl_tpu_torch.ops import hist

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("probe_hist measures the kernels on a CUDA card")
    rng = np.random.default_rng(42)
    recs = synth(R, rng)
    recs4 = synth(R4, rng)
    path = synth(PATH_RECORDS, rng)
    k2 = lambda records: (records, ref_result(*records), hist.psd_scatter,
                          hist.psd_scatter_plain, True,
                          touched_entries(*records))

    def k3(records, band):
        return (records, band_ref(*records, band),
                lambda p, *a: hist.psd_scatter_band(p, *a, band),
                lambda p, *a: hist.psd_scatter_band_plain(p, *a, band),
                False, touched_entries(*records, band))

    cases = {} if k3_only else {"K2 (69,632 records)": k2(path),
                                "K2 (2^21 records)": k2(recs)}
    for band in (1024, 2048):
        cases[f"K3 band={band}"] = k3(recs, band)
    for name, (records, band) in k3_edge_cases(R, rng).items():
        if len(records[0]):
            cases[f"K3 {name} (band={band})"] = k3(records, band)
    if not k3_only:
        # the worst case of same-address atomics: every record of the
        # path's batch on one (cell, lo, hi)
        n = PATH_RECORDS
        one = (np.full(n, 2000, np.int32), np.full(n, 40, np.int32),
               np.full(n, 41, np.int32), path[3] + np.float32(0.5))
        cases["K2 (69,632 records on one address)"] = k2(one)
        for name, records in (extra or {}).items():
            cases[name] = k2(records)
        if not narrow:
            # the synthetic records as the helix step hands them over,
            # against the plain version on the same tensors
            wide = (path[0], path[1].astype(np.int64),
                    path[2].astype(np.int64), path[3].astype(np.float64))
            cases["K2 (69,632 records, int64 zones, float64 weights)"] = (
                wide,) + k2(path)[1:]
        cases["K4 = K2 (2^16 records)"] = k2(recs4)
    out = {}
    for name, (records, want, kernel, plain, lib, touched) in cases.items():
        graph = lib or not eager_k3
        r = out[name] = _case(dev, records, want, kernel, plain, lib,
                              touched, narrow, graph)
        lib_txt = ("none" if r["library_ms"] is None else
                   f"{r['library_ms']:8.4f} ms under graph replay (eager "
                   f"{r['library_eager_ms']:.4f} ms)")
        print(f"{name:24s} kernel {r['ms']:8.4f} ms "
              f"{'under graph replay' if graph else 'eager'} "
              f"({r['ns_per_record']:6.3f} ns/record; eager "
              f"{r['eager_ms']:.4f} ms), plain "
              f"{r['plain_ms']:8.4f} ms ({r['plain_ns_per_record']:6.3f} "
              f"ns/record); kernel vs plain max abs err "
              f"{r['max_abs_err']:.3e} (max |psd| {r['max_abs_psd']:.3e}); "
              f"max rel err vs f64: kernel {r['rel_err_f64']:.2e}, plain "
              f"{r['plain_rel_err_f64']:.2e}; bound {r['bound_ms']:.6f} ms "
              f"(bytes; {r['touched_entries']} PSD entries touched; "
              f"{r['bound_share']:.1%} of it reached); index_add_ {lib_txt}")
    return out


def main() -> int:
    import argparse
    import importlib.util
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--narrow", action="store_true")
    ap.add_argument("--eager-k3", action="store_true")
    ap.add_argument("--k3-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_hist: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from montecarloscattering_jl_tpu_torch.ops import hist
    spec = importlib.util.spec_from_file_location(
        "workloads", os.path.join(here, "workloads.py"))
    workloads = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(workloads)
    print(f"card: {workloads.card_line()}; wrappers from {hist.__file__}")
    dev = torch.device("cuda:0")
    kept = {} if args.k3_only else step_records(dev, workloads)
    for k, (_, _, _, w) in kept.items():
        print(f"helix step {k}: {int((w != 0).sum())} nonzero records of "
              f"{w.size}")
    run(dev, args.narrow,
        {f"K2 (helix step {k}'s records)": v for k, v in kept.items()},
        args.eager_k3, args.k3_only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
