"""The PSD histogram's plain versions (montecarloscattering_jl_tpu_torch/
ops/hist.py) against the JAX package, on the CPU.

* K2's plain version against the XLA engine's flush
  (``step._flush_records`` with ``hist_band = 0``: the exact float32
  scatter) and against the Pallas band kernel in interpret mode
  (``psd_accumulate(..., interpret=True, mode="comp")``), on the record
  shapes of tests/test_pallas_hist.py.  Tolerances: against the exact
  scatter, float32 sums in another order (rtol 2e-6, atol 1e-6 of the
  largest entry, the JAX test's bound for that branch); against "comp",
  its compensated-bf16 bound (2e-5 of the largest entry).
* K3's plain version against the probe's float64 reference
  (scripts/probe_hist.py ``ref_result``) restricted to the band, on the
  probe's own synthetic records (fewer of them), and on the edge cases
  of its contract against the probe's ``band_ref``: 1e-6 of the largest
  entry (float32 sums of a few records per entry).
* The wrappers: a PSD on the CPU takes the plain version and is
  counted; malformed inputs raise.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.ops import pallas_hist as ph
from montecarloscattering_jl_tpu.ops import state as jst
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu_torch.ops import build, hist
from montecarloscattering_jl_tpu_torch.scripts import probe_hist as tprobe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_pallas_hist.py's geometry: 300 cells = 15 momenta x 2 kinds x 10
# angles, 50 boundaries
N_MOM, N_THETA, NZC = 14, 9, 50
N_CELLS = (N_MOM + 1) * 2 * (N_THETA + 1)
BAND = 256


def _records(r, rng, cell_lo, cell_hi, rate=0.3, max_span=3):
    """tests/test_pallas_hist.py:35-41."""
    cell = rng.integers(cell_lo, cell_hi, r).astype(np.int32)
    lo = rng.integers(0, NZC - max_span - 1, r).astype(np.int32)
    hi = lo + rng.integers(0, max_span, r).astype(np.int32)
    w = (rng.random(r, np.float32) + 0.1) * (
        rng.random(r) < rate).astype(np.float32)
    return cell, lo, hi, w


def _case(name):
    """The record sets of test_pallas_hist.py:60-168 (and an initial
    PSD where the case accumulates into one)."""
    rng = np.random.default_rng(
        {"band": 0, "existing": 1, "padding": 2, "overflow": 3,
         "wild": 4, "sparse": 6, "wide": 7, "mixed": 8,
         "all_padding": 9}[name])
    psd0 = None
    if name == "band":
        recs = _records(4096, rng, 30, 30 + BAND - 1)
    elif name == "existing":
        recs = _records(4096, rng, 10, 90)
        psd0 = rng.random((N_CELLS, NZC)).astype(np.float32)
    elif name == "padding":
        recs = _records(4096 + 257, rng, 0, BAND - 1)
    elif name == "overflow":
        recs = _records(4096, rng, 0, N_CELLS)
    elif name == "wild":
        cell, lo, hi, w = _records(4096, rng, 44, N_CELLS)
        recs = (np.where(w == 0, np.int32(0), cell), lo, hi, w)
    elif name == "sparse":
        recs = _records(2 * 4096, rng, 30, 30 + BAND - 1, rate=0.08)
    elif name == "wide":
        recs = _records(4096, rng, 0, BAND - 1, rate=0.08,
                        max_span=NZC - 2)
    elif name == "mixed":
        a = _records(4096, rng, 10, 10 + BAND - 1, rate=0.9)
        b = _records(4096, rng, 10, 10 + BAND - 1, rate=0.05)
        recs = tuple(np.concatenate([x, y]) for x, y in zip(a, b))
    else:                                   # all padding
        z = np.zeros(4096, np.int32)
        recs = (z, z, z, np.zeros(4096, np.float32))
    if psd0 is None:
        psd0 = np.zeros((N_CELLS, NZC), np.float32)
    return psd0, recs


CASES = ("band", "existing", "padding", "overflow", "wild", "sparse",
         "wide", "mixed", "all_padding")


def _port(psd0, recs):
    psd = torch.from_numpy(psd0.copy())
    hist.psd_scatter(psd, *(torch.from_numpy(a) for a in recs))
    return psd.numpy().astype(np.float64)


def _flush_ref(psd0, recs):
    """The XLA engine's flush with hist_band = 0 (the exact scatter)."""
    cell, lo, hi, w = recs
    r = len(w)
    ss = stp.StepStatic(
        eta_mfp=1.0, xn_per_coarse=50.0, xn_per_fine=50.0,
        dont_scatter=False, dont_dsa=False, do_rad_losses=False,
        do_retro=False, do_tcuts=False, use_custom_eps_b=False,
        is_electron=False, do_energy_transfer=False,
        electron_weight_fac=0.0, n_xspec=0, i_grid_feb=0, i_shock=3,
        nb=NZC - 1, psd_mom_min=1e-22, bins_per_dec_mom=10, n_mom=N_MOM,
        cos_fine=0.5, dcos=0.01, theta_min=1e-4, bins_per_dec_theta=10,
        n_theta=N_THETA)
    assert ss.hist_band == 0
    tal = jst.make_tallies(NZC - 1, N_MOM, N_THETA, 0, 0, jnp.float32,
                           batch=r, chunk=1)
    rec = np.zeros((1, 8, r), np.float64)
    rec[0, 4], rec[0, 5], rec[0, 6], rec[0, 7] = w, lo, hi, cell
    tal = tal._replace(rec=jnp.asarray(rec),
                       psd_diff=jnp.asarray(psd0))
    return np.asarray(stp._flush_records(tal, ss).psd_diff, np.float64)


def _comp_ref(psd0, recs):
    """The Pallas band kernel in interpret mode, compensated rounding."""
    return np.asarray(ph.psd_accumulate(
        jnp.asarray(psd0), *(jnp.asarray(a) for a in recs), BAND,
        seed=jnp.int32(0), mode="comp", interpret=True), np.float64)


@pytest.mark.parametrize("case", CASES)
def test_k2_plain_matches_exact_flush(case):
    psd0, recs = _case(case)
    want = _flush_ref(psd0, recs)
    got = _port(psd0, recs)
    np.testing.assert_allclose(got, want, rtol=2e-6,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_k2_plain_matches_band_kernel_comp(case):
    psd0, recs = _case(case)
    want = _comp_ref(psd0, recs)
    got = _port(psd0, recs)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * max(np.abs(want).max(), 1e-30))


def test_k2_plain_drops_out_of_range_indices():
    """Indices outside the flat array are dropped, as JAX's scatter
    drops them; zero weights add nothing anywhere."""
    psd = torch.zeros(4, 5)
    cell = torch.tensor([0, 3, 9, -2, 1], dtype=torch.int32)
    lo = torch.tensor([1, 4, 0, 0, 0], dtype=torch.int32)
    hi = torch.tensor([2, 4, 0, 0, 1], dtype=torch.int32)
    w = torch.tensor([1.0, 2.0, 5.0, 7.0, 0.0])
    hist.psd_scatter(psd, cell, lo, hi, w)
    want = torch.zeros(4, 5)
    want[0, 1] += 1.0
    want[0, 3] -= 1.0
    want[3, 4] += 2.0          # (3, 4 + 1) lies past the array: dropped
    assert torch.equal(psd, want)


@pytest.fixture(scope="module")
def jax_probe():
    """scripts/probe_hist.py of the JAX package (it reads sys.argv when
    imported, so it is loaded with a bare argv)."""
    spec = importlib.util.spec_from_file_location(
        "jax_probe_hist", os.path.join(ROOT, "scripts", "probe_hist.py"))
    mod = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [spec.origin]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


def test_probe_records_match(jax_probe):
    r = 1 << 14
    want = jax_probe.synth(r, np.random.default_rng(42))
    got = tprobe.synth(r, np.random.default_rng(42))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(
        jax_probe.ref_result(*want), tprobe.ref_result(*got))


def test_k2_plain_matches_probe_reference(jax_probe):
    recs = tprobe.synth(1 << 16, np.random.default_rng(42))
    want = jax_probe.ref_result(*recs)
    psd = torch.zeros(tprobe.N_CELLS, tprobe.NZC)
    hist.psd_scatter(psd, *(torch.from_numpy(a) for a in recs))
    assert np.abs(psd.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("band", [1024, 2048])
def test_k3_plain_matches_probe_reference_in_band(jax_probe, band):
    recs = tprobe.synth(1 << 16, np.random.default_rng(42))
    cell, lo, hi, w = recs
    blo = int(cell[w != 0].min())
    in_band = (cell >= blo) & (cell < blo + band)
    want = jax_probe.ref_result(cell, lo, hi,
                                np.where(in_band, w, np.float32(0)))
    psd = torch.zeros(tprobe.N_CELLS, tprobe.NZC)
    before = hist.PLAIN_CALLS
    hist.psd_scatter_band(psd, *(torch.from_numpy(a) for a in recs), band)
    assert hist.PLAIN_CALLS == before + 1
    got = psd.numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # rows outside the band stayed exactly zero
    assert not got[:blo].any() and not got[blo + band:].any()
    if band == 1024:
        assert (in_band | (w == 0)).sum() < len(w)   # the band cut bites
    np.testing.assert_array_equal(
        tprobe.band_ref(*recs, band), want)


K3_EDGES = tuple(tprobe.k3_edge_cases(1, np.random.default_rng(0)))


@pytest.mark.parametrize("case", K3_EDGES)
def test_k3_wrapper_contract(case):
    """The edge cases of K3's contract (the probe's ``k3_edge_cases``:
    blo at cell 0, a band past the array's end, all weights zero, wild
    boundary indices, one address, no records) through the wrapper on
    the CPU (its plain version) against the probe's float64
    ``band_ref``: 1e-6 of the largest entry, and exactly zero where no
    record is in the band.  ``band_ref`` itself equals the JAX probe's
    ``ref_result`` of the in-band records where every index is in
    range."""
    recs, band = tprobe.k3_edge_cases(
        1 << 12, np.random.default_rng(3))[case]
    want = tprobe.band_ref(*recs, band)
    psd = torch.zeros(tprobe.N_CELLS, tprobe.NZC)
    hist.psd_scatter_band(psd, *(torch.from_numpy(a) for a in recs), band)
    got = psd.numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    cell, lo, hi, w = recs
    blo = int(np.min(np.where(w != 0, cell, 2 ** 30), initial=2 ** 30))
    if case in ("all weights zero", "empty"):
        assert blo == 2 ** 30 and not got.any()
    elif case == "band at cell 0":
        assert blo == 0 and got[:band].any() and not got[band:].any()
    elif case == "band past the array's end":
        assert blo + band > tprobe.N_CELLS and got[-100:].any()
    elif case == "wild lo / hi":
        assert ((lo < 0) | (hi + 1 >= tprobe.NZC))[w != 0].any()
    else:
        assert np.count_nonzero(got) == 2


def test_wrappers_count_and_check():
    psd = torch.zeros(N_CELLS, NZC)
    recs = [torch.from_numpy(a) for a in _case("band")[1]]
    before = (hist.PLAIN_CALLS, hist.LAUNCHES, hist.BAND_LAUNCHES)
    hist.psd_scatter(psd, *recs)
    hist.psd_scatter_band(psd, *recs, BAND)
    assert (hist.PLAIN_CALLS, hist.LAUNCHES, hist.BAND_LAUNCHES) == (
        before[0] + 2, before[1], before[2])
    cell, lo, hi, w = recs
    with pytest.raises(ValueError):
        hist.psd_scatter(psd.double(), cell, lo, hi, w)
    with pytest.raises(ValueError):
        hist.psd_scatter(psd, cell.long(), lo, hi, w)
    with pytest.raises(ValueError):
        hist.psd_scatter(psd, cell, lo, hi[:-1], w)
    with pytest.raises(ValueError):
        hist.psd_scatter_band(psd, cell, lo, hi, w, 0)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """The kernels build from the package's sources with nvcc; without
    one the build raises instead of giving way to anything else."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all(["psd_hist"])
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == [
        "finish.cu", "helix_pow.cu", "helix_step.cu", "mega_step.cu",
        "psd_hist.cu", "rebin.cu"]
    assert build.LIBRARIES == ("finish", "helix_step", "mega_step",
                               "psd_hist", "rebin")


# ---------------------------------------------------------------------------
# K2 on the helix step's own tensors: int64 zones, float64 weights
# ---------------------------------------------------------------------------

def _wide_case(name):
    """Records that stress the wide entry: as _case, plus every record
    on one address, and float64 weights that are not float32 values."""
    if name == "one_address":
        n = 4096
        recs = (np.full(n, 77, np.int32), np.full(n, 40, np.int32),
                np.full(n, 41, np.int32),
                np.linspace(0.5, 1.5, n).astype(np.float32))
        return np.zeros((N_CELLS, NZC), np.float32), recs
    return _case(name)


@pytest.mark.parametrize("w_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("z_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", ["existing", "overflow", "wild", "sparse",
                                  "all_padding", "one_address"])
def test_k2_wide_entry_matches_plain_on_casts(name, z_dtype, w_dtype):
    """int64 lo / hi and float64 w through the wrapper give, bit for bit,
    what the plain version gives on their int32 / float32 casts (zero
    weights, duplicates and out-of-range indices included): on the CPU
    the wrapper rounds w to float32 as the cast does and adds in the
    same order, so the tolerance is 0."""
    psd0, (cell, lo, hi, w) = _wide_case(name)
    # float64 weights between float32 values: the rounding must happen
    w_wide = w.astype(w_dtype)
    if w_dtype == np.float64:
        w_wide = w_wide * (1.0 + 2.0 ** -30)
    got = torch.from_numpy(psd0.copy())
    hist.psd_scatter(got, torch.from_numpy(cell),
                     torch.from_numpy(lo.astype(z_dtype)),
                     torch.from_numpy(hi.astype(z_dtype)),
                     torch.from_numpy(w_wide))
    want = torch.from_numpy(psd0.copy())
    hist.psd_scatter_plain(want, torch.from_numpy(cell),
                           torch.from_numpy(lo), torch.from_numpy(hi),
                           torch.from_numpy(w_wide.astype(np.float32)))
    assert torch.equal(got, want)
    if name != "all_padding":
        assert not torch.equal(got, torch.from_numpy(psd0))


@pytest.mark.parametrize("bad", ["mixed_zones", "half_weights",
                                 "int64_cell", "short_lo", "strided_w"])
def test_k2_wide_entry_raises(bad):
    psd = torch.zeros(N_CELLS, NZC)
    cell, lo, hi, w = (torch.from_numpy(a) for a in _case("band")[1])
    args = {"mixed_zones": (cell, lo.long(), hi, w),
            "half_weights": (cell, lo, hi, w.half()),
            "int64_cell": (cell.long(), lo.long(), hi.long(), w),
            "short_lo": (cell, lo[:-1], hi, w),
            "strided_w": (cell, lo, hi, w.repeat(2)[::2])}[bad]
    with pytest.raises(ValueError):
        hist.psd_scatter(psd, *args)


def test_scatter_launch_validates_once_and_reads_live_tensors():
    """A prepared launch adds the records as they stand at each launch
    (two launches add twice; a weight changed in between counts), takes
    the plain version on the CPU and counts it."""
    psd0, recs = _case("band")
    cell, lo, hi, w = (torch.from_numpy(a.copy()) for a in recs)
    psd = torch.from_numpy(psd0.copy())
    prepared = hist.ScatterLaunch(psd, cell, lo.long(), hi.long(),
                                  w.double())
    before = (hist.PLAIN_CALLS, hist.LAUNCHES)
    prepared.launch()
    once = psd.clone()
    prepared.launch()
    assert (hist.PLAIN_CALLS, hist.LAUNCHES) == (before[0] + 2, before[1])
    np.testing.assert_allclose(psd.numpy(), 2.0 * once.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = torch.from_numpy(psd0.copy())
    hist.psd_scatter_plain(want, cell, lo, hi, w)
    assert torch.equal(once, want)


@pytest.mark.parametrize("n_cells,ok", [(2 ** 16 - 1, True), (2 ** 16, False)])
def test_k2_refuses_a_psd_its_int_index_cannot_span(n_cells, ok):
    """K2 forms flat indices as int32 after its range test, so the
    wrapper refuses a PSD of 2^31 entries or more off the CPU (shown on
    meta tensors, which allocate nothing); one entry fewer passes on to
    the device check."""
    meta = dict(device="meta")
    psd = torch.empty(n_cells, 2 ** 15, **meta)
    recs = (torch.empty(8, dtype=torch.int32, **meta),) * 3 + (
        torch.empty(8, **meta),)
    with pytest.raises(ValueError,
                       match="device meta" if ok else r"2\^31 entries"):
        hist.ScatterLaunch(psd, *recs)
