"""The port's kernels against their plain PyTorch versions on a CUDA
card: K1 (csrc/mega_step.cu) against its twin (the custom f(r_g) law
on and off), K2 and K3
(csrc/psd_hist.cu) against ops/hist.py's plain versions (K2 also on
one address and on int64 / float64 records), every compiled instance of
K1 on lanes that reach its branches, a drain in one launch, K5
(csrc/helix_step.cu) against the plain step's block (ops/step.py
_block) on every flag case, on the flagship at float64 and at float32
with detectors, and its uniforms against rng.lane_uniforms_xla; the XLA
engine's float64 segment (ops/step.py, one K5 drain) against the same
segment on the CPU, the plain step on the card against the CPU's lane
by lane over two steps, K5's block loop and its compaction ladder lane
for lane against the uncompacted loop and the drain, and the oblique
step's graphs replayed across segments; and the batched emission
functions (models/emission/device.py) on the card against the per-zone
NumPy oracles; and the mesh (parallel/): two ranks sharing the card
under gloo against one process (counts exact, lanes bit for bit), two
cards under NCCL where there are two, and NCCL's one card a rank where
there is one; and the finish kernel (csrc/finish.cu) against its twin
(ops/finish.py tally_twin) bit for bit, on itself a second time, and
against index_put_ within tests/torch_finish_cases.TOL of each cell, on
the cases of tests/test_torch_finish_kernel.py and a drained K5
population.  Every test here needs the
card: it carries the ``cuda`` marker and skips without one.  Run on the
card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(tests/conftest.py sets JAX up; these tests need none of it).

Bounds: K1 is built with -fmad=false and calls the CUDA libm functions
the twin's torch ops call, so per-lane state agrees to 16 f32 ulp
relative (momenta relative to the lane's |p|) on all but at most 0.1% of
lanes, and tally totals to 1e-4 (f32 atomics in another order).  K2 and
K3 agree with their plain versions to 1e-4 of the largest PSD entry
(f32 sums in another order).  K5 is built as K1 is and follows the
plain step operation by operation: per lane within 1e-12 relative on
all but 0.1% of the lanes (measured: bit for bit), float64 tallies
within 1e-9 of their largest entry and the PSD within 1e-4 (atomics in
another order), the uniforms bit for bit.  The float64 segment on the card agrees
with the CPU's on all but 0.1% of lanes' integer fields; the card's
float32 cos of the scattering phase may differ from the CPU's by an ulp,
which moves momenta by ~1e-7 a step, so float fields agree to 1e-4
relative and the tallies to 1e-4 of their largest entry.  The emission
functions agree with the NumPy oracles to rtol 1e-5 on every bin above
1e-90 (the oracle floors each term at 1e-60 before it sums, the batched
IC kernel after; float64 atomics sum in any order)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
from montecarloscattering_jl_tpu_torch.models.injection import init_pop
from montecarloscattering_jl_tpu_torch.ops import mega, rng
from montecarloscattering_jl_tpu_torch.ops import state as stt
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl
from montecarloscattering_jl_tpu_torch.utils import load_config

pytestmark = pytest.mark.cuda
LANES = 4096
CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data", "dsa_nonrel.toml")


@pytest.fixture(scope="module")
def card():
    # decided in a fixture, not at import: every worker collects the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def population(card):
    cfg = load_config(CFG)
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=card)
    prof = setup.profile
    pop = init_pop(np.random.default_rng(0), cfg.species, 0, 1,
                   cfg.energy_inj, True, cfg.n_pts_inj, setup.x_grid_start,
                   cfg.rg0, 1.0, True, -1.0, cfg.beta0, cfg.gamma0, cfg.u0,
                   setup.x_grid_rg, prof.ux_sk, prof.gamma_sf)
    reps = LANES // len(pop.ptot_pf) + 1
    t = lambda a: np.tile(a, reps)[:LANES]
    st = stt.init_state(
        t(pop.weight), t(pop.ptot_pf), t(pop.pb_pf), t(pop.x_cm),
        t(pop.i_grid).astype(np.int32), t(prof.ux_sk[pop.i_grid]),
        cfg.xn_per_fine, setup.x_grid_stop, rng.key(0), card)
    ss = eng.step_static(0)
    frg = dict(frg_alpha=1.5, frg_rg0_cm=2.0 * cfg.rg0)
    tabs = {kind + law: mega.mega_tables(
        eng.segment_grids(prof), eng.segment_scalars(0, 2, prof.bmag2),
        dataclasses.replace(ss, is_electron=kind == "electron",
                            **(frg if law else {})), card)
        for kind in ("ion", "electron") for law in ("", "-frg")}
    fresh = lambda: stt.make_tallies(setup.nb, setup.bins.n_mom,
                                     setup.bins.n_theta, card)
    return st, tabs, fresh


def _clone(st):
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)})


@pytest.mark.parametrize("kind", ["ion", "electron", "ion-frg",
                                  "electron-frg"])
@pytest.mark.parametrize("n_steps", [1, 64, 256])
def test_k1_matches_twin(population, n_steps, kind):
    st0, tabs, fresh = population
    tabs = tabs[kind]
    assert tabs.on(mega.FLAG_CUSTOM_FRG) == kind.endswith("-frg")
    s_k, t_k, s_t, t_t = _clone(st0), fresh(), _clone(st0), fresh()
    before = mega.LAUNCHES
    mega.launch(s_k, tabs, t_k, n_steps=n_steps)
    assert mega.LAUNCHES == before + 1
    mega.step_twin(s_t, tabs, t_t, n_steps, mega.MAX_HELIX_STEPS)
    torch.cuda.synchronize()
    same = torch.ones(LANES, dtype=torch.bool, device=st0.device)
    for name in ("status", "reason", "nsteps", "flags"):
        same &= getattr(s_k, name) == getattr(s_t, name)
    assert int((~same).sum()) <= 1e-3 * LANES
    ptot = torch.hypot(s_t.pb.double(), s_t.pperp.double())
    for name in ("pb", "pperp", "phi", "x", "prp_x", "acctime", "t_step"):
        a = getattr(s_k, name).double()[same]
        b = getattr(s_t, name).double()[same]
        scale = (ptot[same] if name in ("pb", "pperp") else b.abs())
        over = (a - b).abs() > 16 * 2.0 ** -23 * scale
        assert int(over.sum()) <= 1e-3 * LANES, name
    for name in ("psd_diff", "flux_diff", "esc"):
        a = getattr(t_k, name).double().abs().sum()
        b = getattr(t_t, name).double().abs().sum()
        assert abs(float(a - b)) <= 1e-4 * float(b) + 1e-300, name


# every instance of K1 (ops/mega.py INSTANCES) on lanes that reach its
# branches: scripts/workloads.py's flag cases, plus the two words they leave out
@pytest.mark.parametrize("tag,word", [
    ("protons", 120), ("electrons", 380), ("protons-shipped", -1),
    ("protons-frg", 248), ("electrons-frg", 508), ("flagship", 0),
    ("flagship-frg", 128), ("electrons-rad", 260)])
def test_k1_instance_matches_twin(card, population, tag, word):
    """The instance compiled for the case's flag word is the one that
    runs (no config falls silently to the run-time instance where a
    specialised one exists), and it gives the twin's lanes: integer
    fields equal on every lane, float fields bit for bit, tally totals to
    1e-4 (sums in another order)."""
    from montecarloscattering_jl_tpu_torch.scripts import workloads as cs
    if tag.startswith("flagship"):
        st0, tabs, fresh = population
        tabs = tabs["ion-frg" if tag.endswith("frg") else "ion"]
    else:
        base = "electrons" if tag == "electrons-rad" else tag
        case = next(c for c in cs.FLAG_CASES if c[0] == base)
        c = cs.flag_case(case, card, LANES)
        st0, tabs, fresh = c["st0"], c["tabs"], c["fresh_tal"]
        if tag == "electrons-rad":
            # the electrons of examples/03 and 04: radiative losses only
            only = dataclasses.replace(
                c["ss"], do_retro=False, do_tcuts=False,
                do_energy_transfer=False, use_custom_eps_b=False)
            tabs = mega.mega_tables(c["grids"], c["sc"], only, card)
    prepared = mega.K1Launch(_clone(st0), tabs, fresh())
    assert mega.INSTANCES[prepared.instance] == word
    s_k, t_k, s_t, t_t = _clone(st0), fresh(), _clone(st0), fresh()
    mega.launch(s_k, tabs, t_k, n_steps=48)
    mega.step_twin(s_t, tabs, t_t, 48, mega.MAX_HELIX_STEPS)
    torch.cuda.synchronize()
    assert int((s_t.nsteps - st0.nsteps).sum()) > LANES
    for name in ("status", "reason", "nsteps", "flags", "tcut", "pb",
                 "pperp", "phi", "x", "prp_x", "acctime", "t_step",
                 "ux_prev", "xn_per"):
        assert torch.equal(getattr(s_k, name), getattr(s_t, name)), name
    for name in ("psd_diff", "flux_diff", "esc", "pool_diff",
                 "weight_coupled", "spectra_coupled", "counts"):
        a = getattr(t_k, name).double().abs().sum()
        b = getattr(t_t, name).double().abs().sum()
        assert abs(float(a - b)) <= 1e-4 * float(b) + 1e-300, name
    attrs = mega.instance_attrs(prepared.instance)
    assert attrs["word"] == word and 0 < attrs["registers"] <= 255
    assert attrs["resident_blocks"] > 0


def test_k1_drain_is_one_launch_without_a_host_wait(population):
    """A drain on the card: one K1 launch, no host wait, no lane left
    ACTIVE, the lanes the twin's drain gives."""
    st0, tabs, fresh = population
    tabs = tabs["ion"]
    s_k, t_k, s_t, t_t = _clone(st0), fresh(), _clone(st0), fresh()
    before = (mega.LAUNCHES, mega.HOST_WAITS, mega.TWIN_CALLS)
    mega.drain(s_k, tabs, t_k, max_helix=300)
    assert (mega.LAUNCHES, mega.HOST_WAITS, mega.TWIN_CALLS) == (
        before[0] + 1, before[1], before[2])
    while mega.step_twin(s_t, tabs, t_t, 100, 300):
        pass
    torch.cuda.synchronize()
    assert not bool((s_k.status == 0).any())
    for name in ("status", "reason", "nsteps", "flags", "pb", "pperp", "x"):
        assert torch.equal(getattr(s_k, name), getattr(s_t, name)), name


def test_wrapper_raises_on_bad_input(population):
    st0, tabs, fresh = population
    tabs = tabs["ion"]
    with pytest.raises(ValueError):
        mega.launch(dataclasses.replace(_clone(st0), x=st0.x.float()),
                    tabs, fresh(), n_steps=1)


# ---------------------------------------------------------------------------
# K2 / K3 and the XLA engine's segment
# ---------------------------------------------------------------------------

def _records(n, dev, seed=7):
    from montecarloscattering_jl_tpu_torch.scripts import probe_hist as ph
    return [torch.from_numpy(a).to(dev)
            for a in ph.synth(n, np.random.default_rng(seed))]


def _hist_pair(card, kernel, plain, recs):
    from montecarloscattering_jl_tpu_torch.scripts import probe_hist as ph
    got = torch.zeros(ph.N_CELLS, ph.NZC, device=card)
    want = torch.zeros_like(got)
    kernel(got, *recs)
    plain(want, *recs)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("n", [69_632, 1 << 21])
def test_k2_matches_plain(card, n):
    from montecarloscattering_jl_tpu_torch.ops import hist
    before = hist.LAUNCHES
    _hist_pair(card, hist.psd_scatter, hist.psd_scatter_plain,
               _records(n, card))
    assert hist.LAUNCHES == before + 1


@pytest.mark.parametrize("zones,weights", [
    (torch.int32, torch.float32), (torch.int64, torch.float32),
    (torch.int32, torch.float64), (torch.int64, torch.float64)])
@pytest.mark.parametrize("n", [1, 31, 69_632, (1 << 18) + 5])
def test_k2_one_address_and_wide_entry(card, n, zones, weights):
    """The adversarial input of the warp aggregation: every record on
    one (cell, lo, hi), so every warp folds to one atomic a side; and on
    random records with zero weights and out-of-range cells.  In each
    dtype the step hands over, within 1e-4 of the largest entry (f32
    sums in another order; float64 weights round to float32 first)."""
    from montecarloscattering_jl_tpu_torch.ops import hist
    g = np.random.default_rng(n)
    w = torch.from_numpy(g.uniform(0.5, 1.5, n)).to(card, weights)
    same = (torch.full((n,), 2000, dtype=torch.int32, device=card),
            torch.full((n,), 40, dtype=zones, device=card),
            torch.full((n,), 41, dtype=zones, device=card), w)
    cell, lo, hi, w32 = _records(n, card, seed=n)
    cell = torch.where(torch.arange(n, device=card) % 97 == 0,
                       cell + 100_000, cell)       # dropped, not wrapped
    mixed = (cell, lo.to(zones), hi.to(zones), w32.to(weights))
    _hist_pair(card, hist.psd_scatter, hist.psd_scatter_plain, same)
    if n > 1000:          # fewer records may all have zero weight
        _hist_pair(card, hist.psd_scatter, hist.psd_scatter_plain, mixed)
    got = torch.zeros(4428, 102, device=card)
    hist.psd_scatter(got, *same)
    torch.cuda.synchronize()
    total = float(w.to(torch.float32).double().sum())
    assert abs(float(got[2000, 40]) - total) <= 1e-4 * total
    assert abs(float(got[2000, 42]) + total) <= 1e-4 * total
    assert int(torch.count_nonzero(got)) == 2


K3_EDGES = ("band at cell 0", "band past the array's end",
            "all weights zero", "wild lo / hi", "one address", "empty")


@pytest.mark.parametrize("band", [1024, 2048, *K3_EDGES])
def test_k3_matches_plain(card, band):
    """K3 at 2^21 probe records (bands 1,024 and 2,048) and on the edge
    cases of its contract (scripts/probe_hist.py ``k3_edge_cases``),
    against its plain version within 1e-4 of the largest entry; where no
    record lies in the band the PSD stays exactly zero."""
    from montecarloscattering_jl_tpu_torch.ops import hist
    from montecarloscattering_jl_tpu_torch.scripts import probe_hist as ph
    if isinstance(band, int):
        recs = _records(1 << 21, card)
    else:
        recs, band = ph.k3_edge_cases(1 << 21, np.random.default_rng(5))[band]
        recs = [torch.from_numpy(a).to(card) for a in recs]
    got = torch.zeros(ph.N_CELLS, ph.NZC, device=card)
    want = torch.zeros_like(got)
    before = hist.BAND_LAUNCHES
    hist.psd_scatter_band(got, *recs, band)
    hist.psd_scatter_band_plain(want, *recs, band)
    torch.cuda.synchronize()
    assert hist.BAND_LAUNCHES == before + 1
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    if scale == 0:
        assert not bool(got.any())


def test_hist_wrapper_raises_on_bad_input(card):
    from montecarloscattering_jl_tpu_torch.ops import hist
    cell, lo, hi, w = _records(1024, card)
    psd = torch.zeros(4428, 102, device=card)
    with pytest.raises(ValueError):
        hist.psd_scatter(psd, cell.cpu(), lo, hi, w)
    with pytest.raises(ValueError):
        hist.psd_scatter(psd, cell, lo, hi, w.half())
    with pytest.raises(ValueError):
        hist.psd_scatter(psd, cell, lo.long(), hi, w)


def test_xla_segment_matches_cpu(card):
    from montecarloscattering_jl_tpu_torch.ops import helix, hist, step
    cfg = load_config(CFG)
    cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    setup = build_setup(cfg)
    prof = setup.profile
    pop = init_pop(np.random.default_rng(0), cfg.species, 0, 1,
                   cfg.energy_inj, True, cfg.n_pts_inj, setup.x_grid_start,
                   cfg.rg0, 1.0, True, -1.0, cfg.beta0, cfg.gamma0, cfg.u0,
                   setup.x_grid_rg, prof.ux_sk, prof.gamma_sf)
    t = lambda a: np.tile(a, LANES // len(a) + 1)[:LANES]
    out = {}
    for dev in (card, torch.device("cpu")):
        eng = TransportEngine(setup, device=dev)
        st = stt.init_state(
            t(pop.weight), t(pop.ptot_pf), t(pop.pb_pf), t(pop.x_cm),
            t(pop.i_grid).astype(np.int32), t(prof.ux_sk[pop.i_grid]),
            cfg.xn_per_fine, setup.x_grid_stop, rng.key(0), dev,
            p_dtype=torch.float64)
        tl = stt.make_tallies(setup.nb, setup.bins.n_mom,
                              setup.bins.n_theta, dev, n_xspec=2)
        tb = step.step_tables(eng.segment_grids(prof),
                              eng.segment_scalars(0, 2, prof.bmag2),
                              eng.step_static(0), dev)
        before = (hist.LAUNCHES, helix.DEPOSIT_STEPS, helix.PLAIN_CALLS,
                  helix.LAUNCHES, helix.HOST_READS)
        step.run_segment(st, tl, tb, max_helix=512)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            # one K5 drain, every push's deposits inside it: no K2
            # launch, no plain block, no host read inside the segment
            pushes = int(st.nsteps.sum(dtype=torch.int64))
            assert (hist.LAUNCHES, helix.DEPOSIT_STEPS - before[1],
                    helix.PLAIN_CALLS, helix.LAUNCHES - before[3],
                    helix.HOST_READS) == (before[0], pushes, before[2], 1,
                                          before[4])
        out[dev.type] = (st.to_numpy(), tl.to_numpy())
    (sg, tg), (sc, tc) = out["cuda"], out["cpu"]
    same = np.ones(LANES, bool)
    for name in ("status", "reason", "nsteps", "igrid", "downstream",
                 "inj"):
        same &= sg[name] == sc[name]
    assert (~same).sum() <= 1e-3 * LANES
    ptot = np.hypot(sc["pb"], sc["pperp"])[same]
    for name in ("pb", "pperp", "x", "prp_x", "acctime", "t_step"):
        a, b = sg[name][same], sc[name][same]
        scale = ptot if name in ("pb", "pperp") else np.abs(b)
        assert (np.abs(a - b) > 1e-4 * scale).sum() <= 1e-3 * LANES, name
    for name in ("flux_diff", "psd_diff", "spectra_sf", "spectra_pf"):
        a = np.asarray(tg[name], np.float64)
        b = np.asarray(tc[name], np.float64)
        assert np.abs(b).max() > 0, name
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name


# per lane, after each of STEPS_VS_CPU steps: torch on the card divides by
# a Python scalar through a reciprocal multiply, and its libm (cos, sin,
# acos, log10, pow) differs from the CPU's, each by a float64 ulp or two
# (~1e-16 relative); the float32 cosine of the scattering phase differs
# by up to 3 float32 ulps (2 on the card, 1 on the CPU: 1.8e-7 of
# cos phi), which moves pb and pperp by up to 1.8e-7 of |p| a step.  So
# after two steps every float field agrees to CPU_STEP_TOL (3.6e-7 and a
# margin for the float64 rounding; momenta relative to |p|, a position
# relative to the larger of |x| and the lane's path, the phase to 2 pi,
# the rest to their own size), integer fields equal on all but 0.1% of
# the lanes (a value within that much of a threshold), the float64 flux
# tallies to CPU_STEP_TOL of their largest entry and the float32 PSD to
# 1e-4
STEPS_VS_CPU, CPU_STEP_TOL = 2, 1e-6


def test_plain_step_on_the_card_matches_the_cpu_per_lane(card):
    """The plain step (ops/step.py helix_step, K5's spec, which K5 equals
    bit for bit on the card: chip_smoke.py phase k5) on the card against
    the same step on the CPU, lane by lane after each of two steps, on
    the f64 flagship population with two detectors: the short-horizon
    link between the CPU's hold on the JAX step (test_torch_step.py,
    1e-12) and the card (bounds above)."""
    from montecarloscattering_jl_tpu_torch.ops import step

    cfg = load_config(CFG)
    cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    setup = build_setup(cfg)
    cpu = torch.device("cpu")
    runs = {}
    for dev in (card, cpu):
        eng = TransportEngine(setup, device=dev)
        tb = step.step_tables(eng.segment_grids(setup.profile),
                              eng.segment_scalars(0, 0, setup.profile.bmag2),
                              eng.step_static(0), dev)
        st = wl.flagship_population(setup, cfg, dev, lanes=LANES,
                                    p_dtype=torch.float64)
        tl = stt.make_tallies(setup.nb, setup.bins.n_mom,
                              setup.bins.n_theta, dev, n_xspec=2)
        x0, seen = st.x.clone(), []
        for _ in range(STEPS_VS_CPU):
            step.helix_step(st, tl, tb, rng.lane_uniforms_xla(
                st.key0, st.key1, st.nsteps), 10_000)
            seen.append(stt.clone(st).to_numpy())
        runs[dev.type] = (seen, tl.to_numpy(), x0.cpu().numpy())
    (sg, tg, x0), (sc, tc, _) = runs["cuda"], runs["cpu"]
    for k in range(STEPS_VS_CPU):
        g, c = sg[k], sc[k]
        same = np.ones(LANES, bool)
        for name in ("status", "reason", "nsteps", "igrid", "tcut",
                     *(f for f, _ in stt._FLAG_FIELDS)):
            same &= g[name] == c[name]
        assert (~same).sum() <= 1e-3 * LANES, k
        assert int(c["nsteps"].sum()) > 0
        ptot = np.hypot(c["pb"], c["pperp"])
        path = np.maximum(np.abs(c["x"]), np.abs(c["x"] - x0))
        for name in ("pb", "pperp", "phi", "x", "prp_x", "acctime",
                     "t_step", "ux_prev", "xn_per"):
            scale = (ptot if name in ("pb", "pperp") else
                     path if name == "x" else np.full(LANES, 2 * np.pi)
                     if name == "phi" else np.abs(c[name]))
            err = np.abs(g[name] - c[name])[same]
            assert (err <= CPU_STEP_TOL * scale[same]).all(), (k, name,
                                                              err.max())
    for name in ("flux_diff", "spectra_sf", "spectra_pf", "psd_diff"):
        a = np.asarray(tg[name], np.float64)
        b = np.asarray(tc[name], np.float64)
        tol = 1e-4 if name == "psd_diff" else CPU_STEP_TOL
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), name


# ---------------------------------------------------------------------------
# emission on the card against the per-zone NumPy oracles
# ---------------------------------------------------------------------------

def test_emission_matches_numpy_oracle(card):
    from montecarloscattering_jl_tpu_torch.models.emission import (
        device as edev, driver as edrv, inverse_compton as eic, pion as epi,
        synchrotron as esy)
    from montecarloscattering_jl_tpu_torch.utils import constants as K

    g = np.random.default_rng(7)
    nz, n_p, n_th = 24, 96, 9
    counts = np.where(g.random((nz, n_p)) < 0.1, 0.0,
                      10.0 ** g.uniform(-99.0, 60.0, (nz, n_p)))
    d2n = 10.0 ** g.uniform(-99.0, 60.0, (n_p, n_th, nz))
    cos_bounds = np.linspace(-1.0, 1.0, n_th + 1)
    btot = 10.0 ** g.uniform(-6, -2, nz)
    target = 10.0 ** g.uniform(-2, 1, nz)
    me_c = K.ME_CGS * K.C_CGS
    pe = me_c * np.logspace(-2, 9, n_p + 1)
    pp = K.MP_C * np.logspace(-2, 6, n_p + 1)
    e_synch = esy.photon_energy_grid(1e-13, 180, 10)
    e_pion = 10.0 ** (np.log10(K.MEV_ERG) + np.arange(120) / 10)
    alpha = eic.ic_photon_energy_grid(1e-2, 140, 10)
    beta = g.uniform(0.05, 0.98, nz)
    gamma = 1.0 / np.sqrt(1.0 - beta ** 2)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=card)

    def close(got, ref):
        assert got.device.type == "cuda" and got.dtype == torch.float64
        np.testing.assert_allclose(np.maximum(got.cpu().numpy(), 1e-90),
                                   np.maximum(ref, 1e-90), rtol=1e-5)

    close(edev.synch_grid_device(t(counts), t(btot), t(pe), t(e_synch)),
          np.stack([esy.synch_emission(counts[z], pe, btot[z], e_synch)
                    for z in range(nz)], axis=1))
    a1, n_ph = eic.cmb_photon_field(0.2)
    ne = edev.cone_cut_counts(d2n, cos_bounds, 0.3)
    close(edev.ic_grid_device(t(ne), t(pe), t(alpha), (t(a1), t(n_ph)), me_c,
                              0.3, 3.0e27),
          np.stack([eic.ic_emission(d2n[:, :, z], pe, cos_bounds, alpha, 0.2,
                                    0.3, 3.0e27, me_c)
                    for z in range(nz)], axis=1))
    close(edev.pion_grid_device(t(counts), pp, e_pion, t(target), 1.0,
                                K.MP_C, 1.0),
          np.stack([epi.pion_emission(counts[z], pp, e_pion, target[z], 1.0,
                                      K.MP_C, [1.0], [1.0])
                    for z in range(nz)], axis=1))
    grid = 10.0 ** g.uniform(-60, -5, (180, nz))
    close(edev.doppler_shift_device(t(grid), t(e_synch), t(beta), t(gamma)),
          edrv.doppler_shift_to_ism(grid, e_synch, beta, gamma))


def _f64_segment(card, lanes):
    """The flagship's injected population (`lanes` lanes, float64) with
    the XLA engine's tables at pcut index 0 and fresh tallies."""
    from montecarloscattering_jl_tpu_torch.ops import step

    cfg = load_config(CFG)
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=card)
    tb = step.step_tables(eng.segment_grids(setup.profile),
                          eng.segment_scalars(0, 0, setup.profile.bmag2),
                          eng.step_static(0), card)
    st = wl.flagship_population(setup, cfg, card, lanes=lanes,
                                p_dtype=torch.float64)
    b = setup.bins
    return st, tb, lambda: stt.make_tallies(setup.nb, b.n_mom, b.n_theta,
                                            card)


def test_compaction_on_the_card_is_lane_for_lane(card):
    """The compaction ladder of K5's block loop (``blocks=True``, 8,192
    lanes, windows 8,192 to 1,024) leaves every lane bit-identical to the
    uncompacted loop, in its own slot, and so does K5's drain (one
    launch, no host read inside it, the loop's steps); counts exact, the
    PSDs within 1e-4 of their largest entry (float32 atomics in another
    order); one K5 launch a block, no graph capture, no plain block."""
    from montecarloscattering_jl_tpu_torch.ops import helix, step

    st0, tb, fresh = _f64_segment(card, 8192)
    out = {}
    for lv in (0, 3, "drain"):
        st, tl = stt.clone(st0), fresh()
        g = step.GraphCache()
        before = helix.LAUNCHES, helix.PLAIN_CALLS, helix.HOST_READS
        taken = step.run_segment(st, tl, tb, compact_levels=(
            5 if lv == "drain" else lv), graphs=g, blocks=lv != "drain")
        torch.cuda.synchronize()
        launches = 1 if lv == "drain" else taken // step.SYNC_EVERY
        assert (helix.LAUNCHES - before[0], helix.PLAIN_CALLS) == (
            launches, before[1])
        assert (helix.HOST_READS == before[2]) == (lv == "drain")
        out[lv] = (st, stt.finalize_tallies(tl), g, taken)
    for lv in (3, "drain"):
        assert out[lv][3] == out[0][3]
        for f in dataclasses.fields(st0):
            assert torch.equal(getattr(out[0][0], f.name),
                               getattr(out[lv][0], f.name)), (lv, f.name)
        assert torch.equal(out[0][1].num_crossings, out[lv][1].num_crossings)
        a, c = out[0][1].psd, out[lv][1].psd
        assert float((a - c).abs().max()) <= 1e-4 * float(a.abs().max())
        assert out[lv][2].captures == 0


def test_graphs_replay_across_segments(card):
    """The oblique step (not in K5: its blocks replay CUDA graphs of the
    plain step): a second segment on the same buffers replays the graphs
    the first captured, no new capture, and the same lanes as a fresh
    cache."""
    from montecarloscattering_jl_tpu_torch.ops import step

    st0, tb, fresh = _f64_segment(card, 4096)
    tb = dataclasses.replace(tb, ss=dataclasses.replace(tb.ss,
                                                        parallel=False))
    g = step.GraphCache()
    st, tl = stt.clone(st0), fresh()
    step.run_segment(st, tl, tb, compact_levels=2, graphs=g)
    captured = g.captures
    assert captured >= 1
    stt.copy_into(st, st0)
    step.run_segment(st, tl, tb, compact_levels=2, graphs=g)
    assert g.captures == captured
    ref = stt.clone(st0)
    step.run_segment(ref, fresh(), tb, compact_levels=2)
    torch.cuda.synchronize()
    for f in dataclasses.fields(st0):
        assert torch.equal(getattr(st, f.name), getattr(ref, f.name)), \
            f.name


# ---- K5 against the plain step's block ------------------------------------

def _hold_k5(tb, st0, fresh, n_steps=64):
    """One K5 launch against the plain block from the same lanes: per
    lane and in every tally (the module's bounds)."""
    from montecarloscattering_jl_tpu_torch.ops import helix, step

    n = st0.weight.shape[0]
    s_k, t_k, s_p, t_p = stt.clone(st0), fresh(), stt.clone(st0), fresh()
    before = helix.LAUNCHES
    helix.block(s_k, t_k, tb, n_steps, 10_000)
    assert helix.LAUNCHES == before + 1
    step._block(s_p, t_p, tb, n_steps, 10_000)
    torch.cuda.synchronize()
    same = torch.ones(n, dtype=torch.bool, device=st0.device)
    for name in ("status", "reason", "nsteps", "igrid", "tcut", "flags"):
        same &= getattr(s_k, name) == getattr(s_p, name)
    assert int((~same).sum()) <= 1e-3 * n
    ptot = torch.hypot(s_p.pb.double(), s_p.pperp.double())
    for name in ("pb", "pperp", "phi", "x", "prp_x", "acctime", "t_step",
                 "ux_prev", "xn_per"):
        a = getattr(s_k, name).double()[same]
        b = getattr(s_p, name).double()[same]
        scale = ptot[same] if name in ("pb", "pperp") else b.abs()
        over = (a - b).abs() > 1e-12 * scale
        assert int(over.sum()) <= 1e-3 * n, name
    for f in dataclasses.fields(t_p):
        b = getattr(t_p, f.name)
        if not isinstance(b, torch.Tensor):
            continue
        a, b = getattr(t_k, f.name).double(), b.double()
        tol = 1e-4 if f.name == "psd_diff" else 1e-9
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), \
            f.name
    return s_p, t_p


@pytest.mark.parametrize("case", wl.FLAG_CASES, ids=lambda c: c[0])
def test_k5_matches_plain_step_flags(card, case):
    """A 64-step window of each flag case (4,096 of scripts/workloads.py
    flag_population's lanes at float64) through K5 against the plain
    block."""
    c = wl.helix_flag_case(case, card, lanes=LANES)
    _, t_p = _hold_k5(c["tb"], c["st0"], c["fresh_tal"])
    assert float(t_p.flux_diff.abs().sum()) > 0


@pytest.mark.parametrize("pdt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k5_matches_plain_step_flagship(card, pdt):
    """The flagship's injected lanes with two x_spec detectors, at
    float64 (its own instance) and float32 (the float32 instance)."""
    from montecarloscattering_jl_tpu_torch.ops import helix, step

    cfg = load_config(CFG)
    cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=card, p_dtype=pdt)
    ss = eng.step_static(0)
    tb = step.step_tables(eng.segment_grids(setup.profile),
                          eng.segment_scalars(0, 0, setup.profile.bmag2),
                          ss, card)
    assert helix.INSTANCES[helix.pack(tb).instance] == (
        pdt == torch.float64, helix.FLAG_XSPEC if pdt == torch.float64
        else helix.CT_RUNTIME)
    st0 = wl.flagship_population(setup, cfg, card, lanes=LANES, p_dtype=pdt)
    b = setup.bins
    _, t_p = _hold_k5(tb, st0, lambda: stt.make_tallies(
        setup.nb, b.n_mom, b.n_theta, card, n_xspec=2))
    assert float(t_p.spectra_sf.sum()) > 0


@pytest.mark.parametrize("ctr", [0, 1, 63, 1000, 2 ** 31 - 1, -1])
def test_k5_uniforms_are_the_xla_stream(card, ctr):
    """K5's in-kernel uniforms (its debug entry) bit for bit against
    rng.lane_uniforms_xla at one counter for every lane (-1: a random
    counter a lane)."""
    from montecarloscattering_jl_tpu_torch.ops import helix

    k0, k1 = rng.fold_in_lanes(rng.key(11), 69_632, card)
    if ctr < 0:
        ns = torch.randint(0, 2 ** 31 - 1, (69_632,),
                           generator=torch.Generator().manual_seed(4),
                           dtype=torch.int32).to(card)
    else:
        ns = torch.full((69_632,), ctr, dtype=torch.int32, device=card)
    assert torch.equal(helix.uniforms(k0, k1, ns),
                       rng.lane_uniforms_xla(k0, k1, ns))


def test_k5_wrapper_raises_on_bad_input(card):
    from montecarloscattering_jl_tpu_torch.ops import helix

    st0, tb, fresh = _f64_segment(card, 256)
    p = helix.pack(tb)
    with pytest.raises(ValueError):
        helix.HelixLaunch(dataclasses.replace(st0, pb=st0.pb.float()),
                          fresh(), p)
    with pytest.raises(ValueError):
        helix.HelixLaunch(st0, dataclasses.replace(
            fresh(), flux_diff=torch.zeros(3, device=card)), p)


# ---- the mesh: ranks on the card (tests/torch_mesh_cases.py) --------------


def test_two_ranks_share_one_card_with_gloo(card):
    """Two ranks on cuda:0 joined by gloo (two processes sharing the
    card): the XLA engine (float64, under fused=True, so the host split)
    and K1 (float32, fused=False) give the single-process counts and
    exit reasons exactly, and every lane handed to the host split bit
    for bit, on tests/test_parallel.py's small config."""
    import torch_mesh_cases as mc
    from montecarloscattering_jl_tpu_torch.parallel import multihost

    cases = [("xla-f64", False), ("k1-f32-host", False)]
    ranks = multihost.spawn(mc.engine_cases, 2, args=(cases,),
                            backend="gloo", device="cuda", timeout=600)
    for i, ref_case in enumerate(("xla-f64-host", "k1-f32-host")):
        ref = mc.engine_case(None, ref_case, device=card)
        for rank in ranks:
            got = rank[i]
            assert got["mesh"]["device"] == "cuda:0"
            assert (got["pushes"], got["trajectories"], got["n_new"]) == (
                ref["pushes"], ref["trajectories"], ref["n_new"])
            np.testing.assert_array_equal(got["reasons"][1:],
                                          ref["reasons"][1:])
        for a, b in zip(ref["split_inputs"], ranks[0][i]["split_inputs"]):
            n = len(a["weight"])
            for k in a:
                np.testing.assert_array_equal(b[k][:n], a[k], err_msg=k)


def test_mesh_hybrid_on_one_card_at_every_cadence(card):
    """Two ranks sharing cuda:0 (gloo) on the mesh hybrid ladder, K1 on
    each, with a chain that dies off a sync point: at
    MCS_HYBRID_SYNC_EVERY 8, 1 and 0 every rank's new lanes, pushes,
    trajectories, splits' integers and exit reasons are the same, the
    lanes each split made up to the death bit for bit, the ranks agree,
    and each makes a gather a sync point and one at the end besides the
    17 reductions."""
    import torch_mesh_cases as mc
    from montecarloscattering_jl_tpu_torch.parallel import multihost

    cases = [("k1-f32-tail", False, s) for s in (None, "1", "0")]
    ranks = multihost.spawn(mc.engine_cases, 2, args=(cases,),
                            backend="gloo", device="cuda", timeout=600)
    ref = ranks[0][0]
    assert ref["n_new"][0] > 0 and ref["n_new"][-1] == 0
    for rank in ranks:
        for got in rank:
            assert got["mesh"]["device"] == "cuda:0"
            assert (got["pushes"], got["trajectories"], got["n_new"]) == (
                ref["pushes"], ref["trajectories"], ref["n_new"])
            np.testing.assert_array_equal(got["reasons"], ref["reasons"])
            for sa, sb in zip(ref["splits"], got["splits"]):
                for k in ("n_saved", "target", "n_new", "nsteps"):
                    np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
            assert got["collectives"] == got["sync_points"] + 1 + 17
            assert got["split_lanes"]      # K1's drains split on the card
        for got in rank[1:]:
            for a, b in zip(rank[0]["split_lanes"][:len(ref["n_new"])],
                            got["split_lanes"]):
                for k in a:
                    np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_two_cards_with_nccl(card):
    """A rank a card under NCCL: the same counts as one process."""
    import torch_mesh_cases as mc
    from montecarloscattering_jl_tpu_torch.parallel import multihost

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    ranks = multihost.spawn(mc.engine_cases, 2,
                            args=([("xla-f64", False)],), backend="nccl",
                            device="cuda", timeout=600)
    ref = mc.engine_case(None, "xla-f64-host", device=card)
    assert [r[0]["mesh"]["device"] for r in ranks] == ["cuda:0", "cuda:1"]
    for r in ranks:
        assert (r[0]["pushes"], r[0]["trajectories"]) == (
            ref["pushes"], ref["trajectories"])


def test_nccl_takes_one_card_a_rank(card, tmp_path):
    """With one card, two NCCL ranks are refused: by NCCL itself when
    both use card 0, by make_mesh before that, and by the CLI's
    --devices 2 before any rank starts."""
    import torch_mesh_cases as mc
    from montecarloscattering_jl_tpu_torch.__main__ import main as cli_main
    from montecarloscattering_jl_tpu_torch.parallel import multihost

    if torch.cuda.device_count() != 1:
        pytest.skip("needs exactly one CUDA card")
    with pytest.raises((RuntimeError, TimeoutError)):
        multihost.spawn(mc.nccl_all_reduce_on_card_0, 2, backend="nccl",
                        device="cpu", timeout=120)
    with pytest.raises(RuntimeError, match="gloo"):
        multihost.spawn(mc.engine_cases, 2, args=([],), backend="nccl",
                        device="cuda", timeout=120)
    with pytest.raises(RuntimeError, match="NCCL"):
        cli_main([CFG, "-o", str(tmp_path), "--devices", "2"])


# ---------------------------------------------------------------------------
# the finish kernel (csrc/finish.cu) against its twin and index_put_
# ---------------------------------------------------------------------------

def _finish_on_card(card, x, start=None):
    """The kernel's four binned tallies after `x` (on the CPU) was added
    into tests/torch_finish_cases.tallies(start) on the card, one
    launch."""
    import torch_finish_cases as fc
    from montecarloscattering_jl_tpu_torch.ops import finish as fin

    acc = fc.tallies(start)
    for f in fc.BINNED:
        setattr(acc, f, getattr(acc, f).to(card))
    before = fin.LAUNCHES
    fin.tally_escapes(acc, **{k: v.to(card) for k, v in x.items()},
                      scratch=fin.FinishScratch.for_lanes(len(x["ip"]), card))
    torch.cuda.synchronize()
    assert fin.LAUNCHES == before + 1
    return {f: getattr(acc, f).cpu() for f in fc.BINNED}


def _hold_finish(card, x, start=None):
    """The kernel bit for bit against its twin, twice in the same bits,
    and within TOL of each cell against index_put_ (both on the CPU)."""
    import torch_finish_cases as fc
    from montecarloscattering_jl_tpu_torch.ops import finish as fin

    got = _finish_on_card(card, x, start)
    assert fc.same_bits(got, fc.run(fin.tally_twin, x, start))
    assert fc.same_bits(got, _finish_on_card(card, x, start))
    fc.assert_close(got, fc.run(fin.tally_index_put, x, start))
    return got


@pytest.mark.parametrize("start", [None, 3], ids=["fresh", "holding"])
@pytest.mark.parametrize("case", ["few", "hot_cells", "mixed", "one_cell",
                                  "one_cell_upstream", "one_d", "ragged"])
def test_finish_kernel_matches_twin(card, case, start):
    import torch_finish_cases as fc

    kw = dict(fc.CASES[case])
    _hold_finish(card, fc.lanes(kw.pop("n"), seed=len(case), **kw), start)


def test_finish_kernel_skips_zero_addends(card):
    """A dead segment's lanes (every addend 0) leave the bits; the
    zero-addend lanes moved to one cell and flagged upstream give the
    same bits."""
    import torch_finish_cases as fc

    x = fc.lanes(fc.LANES, seed=11)
    dead = dict(x, **{k: torch.zeros_like(x[k]) for k in ("wwf", "we", "wd")})
    assert fc.same_bits(_finish_on_card(card, dead, 3),
                        fc.run(lambda acc, **_: None, dead, 3))
    zero = x["wd"] == 0
    moved = dict(x, ip=torch.where(zero, 0, x["ip"]),
                 jt=torch.where(zero, 0, x["jt"]),
                 is_up=torch.where(zero, True, x["is_up"]))
    assert fc.same_bits(_hold_finish(card, moved), _hold_finish(card, x))


def test_finish_kernel_on_a_drained_k5_population(card):
    """The flagship's 4,096 injected lanes drained by K5 at pcut index 0:
    the lanes' finish_lanes on the card through the kernel, held as
    above; finish_particles launches it once and gives its bits."""
    from montecarloscattering_jl_tpu_torch.ops import finish as fin
    from montecarloscattering_jl_tpu_torch.ops import step

    st, tb, fresh = _f64_segment(card, LANES)
    step.run_segment(st, fresh(), tb, compact_levels=5)
    cfg = load_config(CFG)
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=card)
    args = (eng.segment_grids(setup.profile),
            eng.segment_scalars(0, 0, setup.profile.bmag2),
            eng.step_static(0))
    x = fin.finish_lanes(st, *args)
    x.pop("px")
    x = {k: v.cpu() for k, v in x.items()}
    assert int((x["is_dw"] | x["is_up"]).sum()) > 0
    got = _hold_finish(card, x)
    b = setup.bins
    acc = fin.EscapeTallies.zeros(b.n_mom, b.n_theta, card)
    before = fin.LAUNCHES
    fin.finish_particles(st, acc, *args, scratch=fin.FinishScratch.for_lanes(
        st.weight.shape[0], card))
    assert fin.LAUNCHES == before + 1
    assert all(torch.equal(getattr(acc, f).cpu(), got[f]) for f in got)
