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
            records outside the band contribute nothing)
  K4 = K2   K2 at P4's 2^16 records (P4's one-record-at-a-time scatter
            is K2's function)

For each it reports ms and ns/record of the kernel and of the plain
version, the kernel's max abs error against the plain version, the
largest entry, and both against the float64 NumPy reference
``ref_result`` (restricted to the band for K3).  Beside them: the bound,
the least time an H100 SXM could take (the records read once, and each
PSD entry that a nonzero record -- within the band, for K3 -- adds to
read and written once, 4 B each way, at 3.35 TB/s; the entries no
record touches need no traffic, and the two adds a record are far below
the compute rate), and for K2/K4 the time of one ``index_add_``
of the records' (lo, +w) and (hi + 1, -w) entries into the flat PSD
(the library call; K3's band filter has none, and the port never calls
it).

Usage: python -m montecarloscattering_jl_tpu_torch.scripts.probe_hist
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import hist

R = 2 ** 21
BAND = 2048              # the cell span synth draws from (probe's BAND)
N_CELLS = 4428           # the flagship's 2 * (n_mom + 1) * (n_theta + 1)
NZC = 102                # nb + 1
CROSS_RATE = 0.25
R4 = 2 ** 16             # P4's record count
RECORD_BYTES = 16        # cell, lo, hi (int32) and w (float32)
HBM_BYTES_S = 3.35e12    # H100 SXM


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
    """ref_result of the records in [blo, blo + band), blo the least
    cell of a nonzero record."""
    blo = int(np.min(np.where(w != 0, cell, 2 ** 30)))
    keep = (cell >= blo) & (cell < blo + band)
    return ref_result(cell, lo, hi, np.where(keep, w, np.float32(0)))


def touched_entries(cell, lo, hi, w, band: int = 0) -> int:
    """The distinct PSD entries the nonzero records add to (those in
    band_ref's band when `band` is given)."""
    keep = w != 0
    if band:
        blo = int(np.min(np.where(keep, cell, 2 ** 30)))
        keep &= (cell >= blo) & (cell < blo + band)
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


def _case(dev, records, want, kernel, plain, library: bool,
          touched: int) -> dict:
    args = [torch.from_numpy(a).to(dev) for a in records]
    new = lambda: torch.zeros(N_CELLS, NZC, dtype=torch.float32,
                              device=dev)
    got, ref = new(), new()
    kernel(got, *args)
    plain(ref, *args)
    torch.cuda.synchronize()
    psd = new()
    n = len(records[0])
    ms = time_ms(lambda: kernel(psd, *args))
    plain_ms = time_ms(lambda: plain(psd, *args))
    library_ms = None
    if library:
        cell, lo, hi, w = args
        base = cell.long() * NZC
        idx = torch.cat([base + lo.long(), base + hi.long() + 1])
        vals = torch.cat([w, -w])
        flat = psd.view(-1)
        library_ms = time_ms(lambda: flat.index_add_(0, idx, vals))
    bound_ms = (n * RECORD_BYTES + 2 * touched * 4) / HBM_BYTES_S * 1e3
    return dict(records=n, touched_entries=touched, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="bytes",
                ns_per_record=ms * 1e6 / n,
                plain_ns_per_record=plain_ms * 1e6 / n,
                max_abs_err=float((got - ref).abs().max()),
                max_abs_psd=float(ref.abs().max()),
                rel_err_f64=max_rel_err(got, want),
                plain_rel_err_f64=max_rel_err(ref, want))


def run(device) -> dict:
    """Time and check every kernel against its plain version on `device`
    (a CUDA device); returns {name: numbers}."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("probe_hist measures the kernels on a CUDA card")
    rng = np.random.default_rng(42)
    recs = synth(R, rng)
    recs4 = synth(R4, rng)
    path = synth(69_632, rng)
    cases = {
        "K2 (69,632 records)": (path, ref_result(*path), hist.psd_scatter,
                                hist.psd_scatter_plain, True,
                                touched_entries(*path)),
        "K2 (2^21 records)": (recs, ref_result(*recs), hist.psd_scatter,
                              hist.psd_scatter_plain, True,
                              touched_entries(*recs))}
    for band in (1024, 2048):
        cases[f"K3 band={band}"] = (
            recs, band_ref(*recs, band),
            lambda p, *a, _b=band: hist.psd_scatter_band(p, *a, _b),
            lambda p, *a, _b=band: hist.psd_scatter_band_plain(p, *a, _b),
            False, touched_entries(*recs, band))
    cases["K4 = K2 (2^16 records)"] = (recs4, ref_result(*recs4),
                                        hist.psd_scatter,
                                        hist.psd_scatter_plain, True,
                                        touched_entries(*recs4))
    out = {}
    for name, (records, want, kernel, plain, lib, touched) in cases.items():
        r = out[name] = _case(dev, records, want, kernel, plain, lib,
                              touched)
        lib_txt = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:8.4f} ms")
        print(f"{name:24s} kernel {r['ms']:8.4f} ms "
              f"({r['ns_per_record']:6.3f} ns/record), plain "
              f"{r['plain_ms']:8.4f} ms ({r['plain_ns_per_record']:6.3f} "
              f"ns/record); kernel vs plain max abs err "
              f"{r['max_abs_err']:.3e} (max |psd| {r['max_abs_psd']:.3e}); "
              f"max rel err vs f64: kernel {r['rel_err_f64']:.2e}, plain "
              f"{r['plain_rel_err_f64']:.2e}; bound {r['bound_ms']:.6f} ms "
              f"(bytes; {r['touched_entries']} PSD entries touched); "
              f"index_add_ {lib_txt}")
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("probe_hist: no CUDA device")
    print("device:", torch.cuda.get_device_name(0))
    run("cuda:0")
