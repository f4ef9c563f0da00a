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
``ref_result`` (restricted to the band for K3).

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


def _case(dev, records, want, kernel, plain) -> dict:
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
    return dict(records=n, ms=ms, plain_ms=plain_ms,
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
                                hist.psd_scatter_plain),
        "K2 (2^21 records)": (recs, ref_result(*recs), hist.psd_scatter,
                              hist.psd_scatter_plain)}
    for band in (1024, 2048):
        cases[f"K3 band={band}"] = (
            recs, band_ref(*recs, band),
            lambda p, *a, _b=band: hist.psd_scatter_band(p, *a, _b),
            lambda p, *a, _b=band: hist.psd_scatter_band_plain(p, *a, _b))
    cases["K4 = K2 (2^16 records)"] = (recs4, ref_result(*recs4),
                                        hist.psd_scatter,
                                        hist.psd_scatter_plain)
    out = {}
    for name, (records, want, kernel, plain) in cases.items():
        r = out[name] = _case(dev, records, want, kernel, plain)
        print(f"{name:24s} kernel {r['ms']:8.4f} ms "
              f"({r['ns_per_record']:6.3f} ns/record), plain "
              f"{r['plain_ms']:8.4f} ms ({r['plain_ns_per_record']:6.3f} "
              f"ns/record); kernel vs plain max abs err "
              f"{r['max_abs_err']:.3e} (max |psd| {r['max_abs_psd']:.3e}); "
              f"max rel err vs f64: kernel {r['rel_err_f64']:.2e}, plain "
              f"{r['plain_rel_err_f64']:.2e}")
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("probe_hist: no CUDA device")
    print("device:", torch.cuda.get_device_name(0))
    run("cuda:0")
