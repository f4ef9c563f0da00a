"""The PSD crossing histogram: K2 (every record) and K3 (a band of cells).

Replaces montecarloscattering_jl_tpu/ops/pallas_hist.py::_band_kernel
(psd_accumulate, the XLA engine's tally flush) and the probe kernels of
scripts/probe_hist.py (_band_kernel, P3; _scalar_kernel, P4) on an NVIDIA
Hopper card.  A record (cell, lo, hi, w) adds w at psd[cell, lo] and -w
at psd[cell, hi + 1] of the difference-array histogram psd[n_cells,
nzc], in place.

* ``psd_scatter`` (K2): every record, with the semantics of the JAX
  engine's exact scatter (pallas_hist.py:297-302): flat indices
  cell * nzc + lo and cell * nzc + hi + 1, an index outside the array
  dropped.  A PSD on the CPU takes ``psd_scatter_plain``; one on a CUDA
  device launches K2 (csrc/psd_hist.cu) or raises.  lo and hi may be
  int32 or int64 and w float32 or float64 (rounded to float32 as a cast
  does), so the helix step passes its own tensors.  ``ScatterLaunch``
  is the prepared form: it validates the tensors and builds the kernel's
  arguments once, and each ``launch()`` after that is one foreign call
  (what a caller that adds into the same tensors again and again, or
  times the kernel, wants).
* ``psd_scatter_band`` (K3): only records whose cell lies in [blo,
  blo + band) and in the array, blo the least cell of a nonzero record
  (P3's contract; 2^30, and nothing added, when there is none), and
  whose boundary index lies in [0, nzc).  On a CUDA device it is one
  cooperative launch (the least cell into a device word, a grid barrier,
  then K2's deposit with the band's filter) and no host wait.  The plain
  version is ``psd_scatter_band_plain``.

Neither kernel has the TPU's band window, bf16 operands or stochastic
rounding: f32 atomics add every record into the full array.  The plain
versions add in a fixed order, the kernels in the order the atomics
land, so the two agree to f32 rounding of the sums.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# kernel launches (K2, K3) and plain calls of the wrappers since the last
# reset (plain counters: chip_smoke.py zeroes them around the main path)
LAUNCHES = 0
BAND_LAUNCHES = 0
PLAIN_CALLS = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.library("psd_hist")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mcs_psd_scatter.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.mcs_psd_scatter.restype = i
        lib.mcs_psd_scatter_band.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.mcs_psd_scatter_band.restype = i
        _LIB = lib
    return _LIB


_ZONE_DTYPES = (torch.int32, torch.int64)
_WEIGHT_DTYPES = (torch.float32, torch.float64)


def _check(psd, cell, lo, hi, w, wide: bool = False) -> None:
    """Raise ValueError on what the kernels do not take.  With `wide`
    (K2), lo and hi may be int64 (both) and w float64."""
    if psd.dim() != 2 or psd.dtype != torch.float32 \
            or not psd.is_contiguous():
        raise ValueError(f"psd: want a contiguous float32 [n_cells, nzc] "
                         f"array, got {psd.dtype} {tuple(psd.shape)}")
    n = w.shape[0]
    zone = (lo.dtype,) if wide and lo.dtype in _ZONE_DTYPES \
        else (torch.int32,)
    weight = _WEIGHT_DTYPES if wide else (torch.float32,)
    for name, a, dts in (("cell", cell, (torch.int32,)), ("lo", lo, zone),
                         ("hi", hi, zone), ("w", w, weight)):
        if a.dtype not in dts or a.shape != (n,) or a.device != psd.device \
                or not a.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dts[0]} [{n}] on "
                             f"{psd.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")


def _ptr(a: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.data_ptr())


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _add_entries(psd, flat_idx, vals, ok) -> None:
    """psd.view(-1)[flat_idx] += vals where ok; other entries add 0 at
    index 0, so the call never waits on the host."""
    flat = psd.view(-1)
    idx = torch.where(ok, flat_idx, 0)
    flat.index_add_(0, idx, torch.where(ok, vals, 0.0))


def psd_scatter_plain(psd, cell, lo, hi, w) -> None:
    """K2's plain version: two masked index_add_s on the flat PSD (w
    rounded to float32 first, lo and hi of either integer width)."""
    n_flat = psd.numel()
    w = w.to(torch.float32)
    base = cell.long() * psd.shape[1]
    nz = w != 0
    for idx, v in ((base + lo.long(), w), (base + hi.long() + 1, -w)):
        _add_entries(psd, idx, v, nz & (idx >= 0) & (idx < n_flat))


def band_low(cell, w) -> torch.Tensor:
    """P3's band offset: the least cell of a nonzero record (2^30 when
    there is none, an empty record set included), a 0-dim int32 tensor
    on the records' device."""
    big = torch.full((1,), 2 ** 30, dtype=torch.int32, device=cell.device)
    return torch.cat([torch.where(w != 0, cell, big), big]).min()


def psd_scatter_band_plain(psd, cell, lo, hi, w, band: int) -> None:
    """K3's plain version: the records of the band [blo, blo + band)
    whose boundary index lies in [0, nzc)."""
    n_cells, nzc = psd.shape
    blo = band_low(cell, w)
    c = cell.long()
    keep = ((w != 0) & (c >= blo) & (c < blo + band) & (c >= 0)
            & (c < n_cells))
    for z, v in ((lo.long(), w), (hi.long() + 1, -w)):
        _add_entries(psd, c * nzc + z, v, keep & (z >= 0) & (z < nzc))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

class ScatterLaunch:
    """K2 on one set of tensors, validated once: ``launch()`` adds the
    records as they stand then into `psd` in place (the plain version
    for a PSD on the CPU, K2 on the current stream for one on a CUDA
    device).  The tensors must outlive the object."""

    def __init__(self, psd, cell, lo, hi, w):
        _check(psd, cell, lo, hi, w, wide=True)
        self.tensors = (psd, cell, lo, hi, w)
        self.device = psd.device
        if self.device.type == "cpu":
            return
        if psd.numel() >= 2 ** 31:
            raise ValueError(f"psd: K2 indexes fewer than 2^31 entries, got "
                             f"{tuple(psd.shape)}")
        if self.device.type != "cuda":
            raise ValueError(f"no histogram kernel for device {self.device}")
        n_cells, nzc = psd.shape
        i = ctypes.c_int
        self._fn = _lib().mcs_psd_scatter
        self._args = (_ptr(cell), _ptr(lo), _ptr(hi), _ptr(w), _ptr(psd),
                      i(w.shape[0]), i(n_cells), i(nzc),
                      i(lo.dtype == torch.int64),
                      i(w.dtype == torch.float64))

    def launch(self) -> None:
        global LAUNCHES, PLAIN_CALLS
        if self.device.type == "cpu":
            PLAIN_CALLS += 1
            psd_scatter_plain(*self.tensors)
            return
        err = self._fn(*self._args, _stream(self.device))
        if err != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")
        LAUNCHES += 1


def psd_scatter(psd, cell, lo, hi, w) -> None:
    """Add the records into `psd` in place: the plain version for a PSD
    on the CPU, K2 for one on a CUDA device."""
    ScatterLaunch(psd, cell, lo, hi, w).launch()


def psd_scatter_band(psd, cell, lo, hi, w, band: int) -> None:
    """Add the band's records into `psd` in place: the plain version for
    a PSD on the CPU, K3 for one on a CUDA device."""
    global BAND_LAUNCHES, PLAIN_CALLS
    _check(psd, cell, lo, hi, w)
    if band <= 0:
        raise ValueError(f"band = {band}")
    dev = psd.device
    if dev.type == "cpu":
        PLAIN_CALLS += 1
        psd_scatter_band_plain(psd, cell, lo, hi, w, band)
        return
    if dev.type != "cuda":
        raise ValueError(f"no histogram kernel for device {dev}")
    if psd.numel() >= 2 ** 31:
        raise ValueError(f"psd: K3 indexes fewer than 2^31 entries, got "
                         f"{tuple(psd.shape)}")
    n_cells, nzc = psd.shape
    key = torch.empty(1, dtype=torch.int32, device=dev)  # blo, on the card
    err = _lib().mcs_psd_scatter_band(
        _ptr(cell), _ptr(lo), _ptr(hi), _ptr(w), _ptr(key), _ptr(psd),
        ctypes.c_int(w.shape[0]), ctypes.c_int(n_cells), ctypes.c_int(nzc),
        ctypes.c_int(band), _stream(dev))
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    BAND_LAUNCHES += 1
