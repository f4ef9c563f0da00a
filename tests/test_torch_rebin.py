"""The dN/dp rebinning kernel (csrc/rebin.cu, ops/reduce.py
``rebin_dndp``) and what surrounds it.

On the CPU (no card needed):

* the wrapper refuses, before any launch, a PSD or a boost grid of the
  wrong dtype, shape or layout, and tensors off a CUDA device;
* the bins' tables are made once per bins and device; the frames'
  speeds are the corner transform's; ``_dn_frames`` on the CPU is the
  plain version, bit for bit.

On a CUDA card (marker ``cuda``, skipped without one; run with
``python -m pytest tests/test_torch_rebin.py -m cuda --noconftest -q``):

* the kernel against the plain version on the CPU (``_dn_frames_plain``)
  for i_approx 0, 1, 2, 3 and 7, on three shapes: the examples/01
  binning with 8 zones boosted by gamma 1 to 2 (ISM 1.3); the benchmark
  configuration's 101 zones with its own profile; and the baseline's
  binning with 199 angle bins, whose corner table (278 KB) does not fit
  in a block's 227 KB of shared memory, with 6 zones boosted by gamma 1
  to 5 (ISM 5).  Each output within 1e-12 of its largest entry (the
  same float64 arithmetic, summed in another order; the card's hypot
  and log10 may differ by an ulp from the CPU's);
* two launches on one input give the same bits (no atomics);
* ``ion_reduce_device(..., fetch=False)`` enqueues without a host wait
  (``torch.cuda.set_sync_debug_mode("error")``) and runs no
  ``corner_logp``, ``rebin_matrix`` or ``torch.matmul``;
* a driven run counts one ``rebin`` launch a species and iteration.
"""

import gc
import os

import numpy as np
import pytest
import torch

from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
from montecarloscattering_jl_tpu_torch.ops import reduce as red
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl
from montecarloscattering_jl_tpu_torch.utils import constants as K
from montecarloscattering_jl_tpu_torch.utils import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE01 = os.path.join(ROOT, "examples", "01_test_particle.toml")
CELL = os.path.join(ROOT, "benchmark", "configs", "nonrel_nonlinear.toml")
BASELINE = os.path.join(ROOT, "configs", "baseline.toml")
MODES = (0, 1, 2, 3, 7)
RTOL = 1e-12
E0 = K.MP_C * K.C_CGS


def _psds(bins, nb, seed=5):
    """Spectrum-like sparse CR and thermal PSDs [n_mom+1, n_theta+1, nb]
    (as tests/test_torch_iapprox.py makes them)."""
    g = np.random.default_rng(seed)
    shape = (bins.n_mom + 1, bins.n_theta + 1, nb)
    p_fac = 10.0 ** (-0.3 * np.arange(bins.n_mom + 1))[:, None, None]
    psd = g.random(shape) * p_fac * (g.random(shape) < 0.7)
    therm = g.random(shape) * p_fac * (g.random(shape) < 0.3)
    return psd, therm


def _shape(name):
    """(bins, the zones' gammas, their flow speeds [cm/s], gamma0)."""
    if name == "examples01":
        bins = build_setup(load_config(EXAMPLE01)).bins
        gamma, gamma0 = np.linspace(1.0, 2.0, 8), 1.3
    elif name == "cell101":
        setup = build_setup(load_config(CELL))
        bins, gamma0 = setup.bins, setup.cfg.gamma0
        gamma = np.asarray(setup.profile.gamma_sf, np.float64)
    else:
        cfg = wl.load_variant(BASELINE, [("psd-linear-cosine-bins = 119",
                                          "psd-linear-cosine-bins = 159")])
        bins, gamma0 = build_setup(cfg).bins, 5.0
        gamma = np.linspace(1.0, 5.0, 6)
        assert (bins.n_mom + 2) * (bins.n_theta + 2) * 8 > 227 * 1024
    ux = K.C_CGS * np.sqrt(1.0 - 1.0 / gamma ** 2)
    return bins, gamma, ux, gamma0


SHAPES = ("examples01", "cell101", "wide")


# ---------------------------------------------------------------------------
# CPU: the wrapper's checks, the tables, the plain path
# ---------------------------------------------------------------------------

def _wrapper_args(bins, nb=3):
    tab = red.bin_tables(bins, "cpu")
    psd = torch.zeros(bins.n_mom + 1, bins.n_theta + 1, nb,
                      dtype=torch.float64)
    gammas, betas = (torch.as_tensor(a) for a in
                     red.frame_grids(np.ones(nb), 1.3))
    return dict(psds=[psd, psd.clone()], tab=tab, gammas=gammas,
                betas=betas)


def _spoil(case, a):
    psd = a["psds"][0]
    if case == "psd_dtype":
        a["psds"][0] = psd.float()
    elif case == "gamma_dtype":
        a["gammas"] = a["gammas"].float()
    elif case == "psd_shape":
        a["psds"][0] = psd[:-1]
    elif case == "psd_rank":
        a["psds"][0] = psd[..., 0]
    elif case == "second_psd_shape":
        a["psds"][1] = psd[..., :-1].contiguous()
    elif case == "beta_shape":
        a["betas"] = a["betas"][:-1]
    elif case == "psd_layout":
        a["psds"][0] = psd.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "gamma_layout":
        a["gammas"] = torch.stack([a["gammas"]] * 2, 1)[:, 0]
    elif case == "three_psds":
        a["psds"] = [psd] * 3
    return a


@pytest.mark.parametrize("case,match", [
    ("psd_dtype", "dtype"), ("gamma_dtype", "dtype"),
    ("psd_shape", "shape"), ("psd_rank", "shape"),
    ("second_psd_shape", "shape"), ("beta_shape", "shape"),
    ("psd_layout", "contiguous"), ("gamma_layout", "contiguous"),
    ("three_psds", "one or two"), ("cpu_device", "CUDA device")])
def test_rebin_wrapper_refuses(case, match):
    """Each of dtype, shape, layout and device raises ValueError before
    the kernel's library is loaded: on the CPU every other check passes,
    so a good call fails on the device alone."""
    bins = build_setup(load_config(EXAMPLE01)).bins
    a = _spoil(case, _wrapper_args(bins))
    before = red.LAUNCHES
    with pytest.raises(ValueError, match=match):
        red.rebin_dndp(a["psds"], a["tab"], a["gammas"], a["betas"], E0, 2)
    assert red.LAUNCHES == before


def test_bin_tables_made_once_per_bins():
    """The tables are cached per bins and device, their values are the
    bins' own, and the entry of a collected bins goes."""
    bins = build_setup(load_config(EXAMPLE01)).bins
    tab = red.bin_tables(bins, "cpu")
    assert red.bin_tables(bins, torch.device("cpu")) is tab
    for name, want in (("mom_edges", bins.mom_edges),
                       ("cos_bounds", bins.cos_bounds()),
                       ("edges_log", bins.mom_bounds_log),
                       ("mom_centers", bins.mom_centers),
                       ("cos_centers", bins.cos_centers()),
                       ("dp", np.diff(bins.mom_edges))):
        got = getattr(tab, name)
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy(), want), name
    other = build_setup(load_config(EXAMPLE01)).bins
    assert red.bin_tables(other, "cpu") is not tab
    del other
    gc.collect()
    third = build_setup(load_config(EXAMPLE01)).bins
    red.bin_tables(third, "cpu")
    assert all(ref() is not None for ref, _ in red._TABLES.values())


def test_frame_grids_are_the_corner_transform_boosts():
    """frame_grids: the zones' gammas then gamma0, each frame's speed as
    corner_logp takes it (0 below gamma 1.000001)."""
    gam = np.array([1.0, 1.0000005, 1.000001, 1.5, 3.0])
    g, b = red.frame_grids(gam, 2.0)
    assert np.array_equal(g, np.append(gam, 2.0))
    assert b[0] == 0.0 and b[1] == 0.0 and b[2] > 0.0
    for gi, bi in zip(g, b):
        assert bi == red.boost_beta(float(gi))
    assert b[-1] == np.sqrt(1.0 - 1.0 / 4.0)


@pytest.mark.parametrize("i_approx", (2, 3))
def test_dn_frames_on_the_cpu_is_the_plain_version(i_approx):
    """On the CPU ``_dn_frames`` (and so ``dndp_cr`` and
    ``ion_reduce_device``) is the plain version, bit for bit."""
    bins, gamma, ux, gamma0 = _shape("examples01")
    psd, therm = (torch.from_numpy(a) for a in _psds(bins, len(gamma)))
    got = red._dn_frames([psd, therm], bins, E0, gamma, gamma0, i_approx)
    want = red._dn_frames_plain([psd, therm], bins, E0, gamma, gamma0,
                                i_approx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    one = red.dndp_cr(psd.numpy(), bins, E0, gamma, gamma0, i_approx)
    assert torch.equal(one, want[0])
    full = red.ion_reduce_device(psd, therm, bins, E0, gamma, ux, gamma0,
                                 i_approx=i_approx, fetch=False)
    assert torch.equal(full[0], want[0]) and torch.equal(full[1], want[1])


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    # decided in a fixture, not at import: every worker collects the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def shapes():
    cache = {}

    def get(name):
        if name not in cache:
            bins, gamma, ux, gamma0 = _shape(name)
            cache[name] = (bins, gamma, ux, gamma0,
                           _psds(bins, len(gamma)))
        return cache[name]
    return get


@pytest.mark.cuda
@pytest.mark.parametrize("i_approx", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(card, shapes, shape, i_approx):
    bins, gamma, ux, gamma0, (psd, therm) = shapes(shape)
    want = red._dn_frames_plain(
        [torch.from_numpy(psd), torch.from_numpy(therm)], bins, E0, gamma,
        gamma0, i_approx)
    before = red.LAUNCHES
    got = red._dn_frames([torch.from_numpy(psd).to(card),
                          torch.from_numpy(therm).to(card)], bins, E0,
                         gamma, gamma0, i_approx)
    assert red.LAUNCHES == before + 1
    one = red.dndp_cr(torch.from_numpy(therm).to(card), bins, E0, gamma,
                      gamma0, i_approx)
    for name, a, b in (("dn_cr", want[0], got[0]),
                       ("dn_th", want[1], got[1]),
                       ("dndp_cr", want[1], one)):
        b = b.cpu()
        assert a.shape == b.shape, name
        scale = float(a.abs().max())
        assert scale > 0, name
        err = float((a - b).abs().max())
        assert err <= RTOL * scale, (name, err / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("i_approx", (2, 3))
def test_kernel_gives_the_same_bits_twice(card, shapes, i_approx):
    bins, gamma, ux, gamma0, (psd, therm) = shapes("cell101")
    psds = [torch.from_numpy(psd).to(card), torch.from_numpy(therm).to(card)]
    tab = red.bin_tables(bins, card)
    frames = red.on_device(red.frame_grids(gamma, gamma0), card)
    a = red.rebin_dndp(psds, tab, *frames, E0, i_approx)
    b = red.rebin_dndp(psds, tab, *frames, E0, i_approx)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("want_ef", (False, True))
def test_ion_reduce_device_waits_for_nothing(card, shapes, monkeypatch,
                                            want_ef):
    """On a card the reduction enqueues with no host wait, and runs none
    of the plain version's per-zone pieces."""
    bins, gamma, ux, gamma0, (psd, therm) = shapes("cell101")
    psd_d = torch.from_numpy(psd).to(card)
    therm_d = torch.from_numpy(therm).to(card)
    torch.cuda.synchronize()

    def refuse(*a, **kw):
        raise AssertionError("the plain rebinning ran on the card")

    monkeypatch.setattr(red, "corner_logp", refuse)
    monkeypatch.setattr(red, "rebin_matrix", refuse)
    monkeypatch.setattr(torch, "matmul", refuse)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = red.ion_reduce_device(psd_d, therm_d, bins, E0, gamma, ux,
                                    gamma0, want_ef=want_ef, fetch=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (out[3] is not None) == want_ef
    monkeypatch.undo()
    want = red.ion_reduce_device(torch.from_numpy(psd),
                                 torch.from_numpy(therm), bins, E0, gamma,
                                 ux, gamma0, want_ef=want_ef)
    for a, b in zip(want[:2], out[:2]):      # the rebinned dN/dp
        scale = np.abs(a).max()
        np.testing.assert_allclose(b.cpu().numpy(), a, rtol=0,
                                   atol=RTOL * scale)


@pytest.mark.cuda
def test_run_counts_one_rebin_a_species_and_iteration(card):
    from montecarloscattering_jl_tpu_torch.engine.driver import run

    cfg = wl.load_variant(EXAMPLE01, [("num-iterations = 1",
                                       "num-iterations = 2")])
    res = run(cfg, card)
    assert res.launches["rebin"] == cfg.n_itrs * cfg.n_ions == 2
