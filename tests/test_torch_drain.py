"""What K1's persistent launch and its one-launch drain rest on, shown
on the CPU with the plain version (ops/mega.py step_twin), and the
choice of K1's compiled instance.

K1 hands lanes to threads in whatever order threads fall free, runs a
lane for as many steps as a launch is given, and on a CUDA device a
drain is one launch that runs every lane to its end.  That is legal
because a lane's result depends on nothing but the lane: its uniforms
are keyed by its own key and step count.  Here:

* a state run in place, as a permuted copy and as a compacted copy (only
  the lanes still ACTIVE) gives every lane the same bits in every field
  (tolerance 0), and the same tally totals: float64 tallies to 1e-12
  relative (the same values summed in another order), the float32 PSD
  to 1e-5;
* a drain cut into launches of 16, 64 or all of the cap's steps gives
  identical states and tallies (tolerance 0: the same operations in the
  same order), and a launch on a state with no ACTIVE lane changes no
  byte of state or tallies;
* ``instance_of`` picks the instance compiled for exactly a flag word
  and the run-time one for every other word, and the configs the port
  ships map to the instances named for them.

Populations: scripts/workloads.py's flagship lanes
(tests/data/dsa_nonrel.toml) and its ``flag_population`` lanes, which
reach every static-flag branch within a few steps, at 256 lanes on the
CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from montecarloscattering_jl_tpu_torch.ops import mega
from montecarloscattering_jl_tpu_torch.ops import state as stt
from montecarloscattering_jl_tpu_torch.scripts import workloads as cs

LANES = 256
FIRST, SECOND = 6, 10      # steps before and after the compaction
CAP = 96                   # helix cap of the drains
KINDS = ("flagship", "protons", "electrons", "protons-shipped",
         "protons-frg")
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(stt.ParticleState))
F64_TALLIES = ("flux_diff", "esc", "pool_diff", "weight_coupled",
               "spectra_coupled", "counts")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind):
    """(tables, state, maker of fresh tallies) of one population."""
    if kind == "flagship":
        c = cs.flagship_case(CPU, LANES)
    else:
        case = next(c for c in cs.FLAG_CASES if c[0] == kind)
        c = cs.flag_case(case, CPU, LANES)
    return c["tabs"], c["st0"], c["fresh_tal"]


def _take(st, idx):
    return dataclasses.replace(st, **{
        n: getattr(st, n)[idx].clone() for n in STATE_FIELDS})


@pytest.fixture(scope="module", params=KINDS)
def runs(request):
    """One population stepped FIRST + SECOND steps three ways: in place;
    as a permuted copy; and, after the FIRST steps in place, as a copy
    of the ACTIVE lanes only."""
    tabs, st0, fresh = _inputs(request.param)
    g = np.random.default_rng(11)
    perm = torch.from_numpy(g.permutation(LANES))
    big = 10_000

    ref, t_ref = cs.clone_state(st0), fresh()
    mega.launch(ref, tabs, t_ref, FIRST, big)
    live = torch.nonzero(ref.status == stt.ACTIVE)[:, 0]
    compact = _take(ref, live)
    t_ref2 = fresh()
    mega.launch(ref, tabs, t_ref2, SECOND, big)
    t_compact = fresh()
    mega.launch(compact, tabs, t_compact, SECOND, big)

    shuffled, t_shuf = _take(st0, perm), fresh()
    mega.launch(shuffled, tabs, t_shuf, FIRST, big)
    t_shuf2 = fresh()
    mega.launch(shuffled, tabs, t_shuf2, SECOND, big)
    return dict(ref=ref, perm=perm, shuffled=shuffled, live=live,
                compact=compact, st0=st0,
                tallies=dict(permuted=((t_ref, t_shuf), (t_ref2, t_shuf2)),
                             compacted=((t_ref2, t_compact),)))


def test_populations_step_and_thin_out(runs):
    """The comparison is not vacuous: lanes stepped, some ended in the
    first stage, some were still ACTIVE for the second."""
    assert runs["live"].numel() > 0
    assert int((runs["ref"].nsteps - runs["st0"].nsteps).sum()) > LANES
    assert int((runs["compact"].nsteps
                - runs["st0"].nsteps[runs["live"]]).sum()) > 0


@pytest.mark.parametrize("field", STATE_FIELDS)
def test_permuted_lanes_get_the_same_bits(runs, field):
    a = getattr(runs["ref"], field)[runs["perm"]]
    b = getattr(runs["shuffled"], field)
    assert torch.equal(a, b), field


@pytest.mark.parametrize("field", STATE_FIELDS)
def test_compacted_lanes_get_the_same_bits(runs, field):
    a = getattr(runs["ref"], field)[runs["live"]]
    b = getattr(runs["compact"], field)
    assert torch.equal(a, b), field


@pytest.mark.parametrize("how", ["permuted", "compacted"])
@pytest.mark.parametrize("name", F64_TALLIES + ("psd_diff",))
def test_tallies_do_not_depend_on_lane_order(runs, name, how):
    rtol = 1e-5 if name == "psd_diff" else 1e-12
    for t_a, t_b in runs["tallies"][how]:
        a = getattr(t_a, name).double()
        b = getattr(t_b, name).double()
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= rtol * scale + 1e-300, name


# ---------------------------------------------------------------------------
# the drain: where launches begin and end changes nothing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["flagship", "protons"])
def drained(request):
    tabs, st0, fresh = _inputs(request.param)
    out = {}
    for n_steps in (16, 64, CAP):
        s, t = cs.clone_state(st0), fresh()
        before = mega.TWIN_CALLS
        mega.drain(s, tabs, t, n_steps=n_steps, max_helix=CAP)
        out[n_steps] = (s, t, mega.TWIN_CALLS - before)
    return tabs, st0, out


@pytest.mark.parametrize("n_steps", [16, 64])
def test_drain_in_one_launch_equals_many(drained, n_steps):
    """One launch of the cap's steps (what a CUDA device runs) against
    launches of n_steps: every byte equal."""
    _, st0, out = drained
    s1, t1, calls1 = out[CAP]
    s2, t2, calls2 = out[n_steps]
    assert calls1 == 1 and calls2 > 1
    assert not bool((s1.status == stt.ACTIVE).any())
    assert int((s1.nsteps - st0.nsteps).sum()) > LANES
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    for f in F64_TALLIES + ("psd_diff",):
        assert torch.equal(getattr(t1, f), getattr(t2, f)), f


def test_launch_on_drained_state_changes_no_byte(drained):
    tabs, _, out = drained
    s, t, _ = out[CAP]
    s0, t0 = cs.clone_state(s), dataclasses.replace(t, **{
        f: getattr(t, f).clone() for f in F64_TALLIES + ("psd_diff",)})
    assert mega.launch(s, tabs, t, n_steps=32, max_helix=CAP) == 0
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s, f), getattr(s0, f)), f
    for f in F64_TALLIES + ("psd_diff",):
        assert torch.equal(getattr(t, f), getattr(t0, f)), f


def test_prepared_k1_launch_refuses_the_cpu(drained):
    """K1Launch is the card's path only: no quiet fallback to the twin."""
    tabs, st0, out = drained
    with pytest.raises(ValueError, match="no transport kernel"):
        mega.K1Launch(st0, tabs, out[CAP][1])


# ---------------------------------------------------------------------------
# the compiled instances
# ---------------------------------------------------------------------------

_SCI = mega.CT_SCIENCE
_RAD, _FRG = mega.FLAG_RAD_LOSSES, mega.FLAG_CUSTOM_FRG


@pytest.mark.parametrize("flags,is_electron,word", [
    (0, False, 0), (_RAD, False, 0),                  # the flagship
    (_RAD, True, mega.CT_ELECTRON | _RAD),            # examples/03, 04
    (_SCI, False, _SCI), (_SCI | _RAD, False, _SCI),  # science protons
    (_SCI | _RAD, True, mega.CT_ELECTRON | _SCI | _RAD),
    (_FRG, False, _FRG), (_FRG | _RAD, False, _FRG),
    (_SCI | _FRG | _RAD, False, _SCI | _FRG),
    (_SCI | _FRG | _RAD, True, mega.CT_ELECTRON | _SCI | _FRG | _RAD),
    # no instance of their own: the run-time one
    (0, True, mega.CT_RUNTIME), (_SCI, True, mega.CT_RUNTIME),
    (mega.FLAG_DONT_SCATTER | mega.FLAG_DONT_DSA | mega.FLAG_TCUTS
     | mega.FLAG_RETRO | _RAD, False, mega.CT_RUNTIME),
    (mega.FLAG_TCUTS, False, mega.CT_RUNTIME),
    (_FRG | _RAD, True, mega.CT_RUNTIME)])
def test_instance_of(flags, is_electron, word):
    i = mega.instance_of(flags, is_electron)
    assert mega.INSTANCES[i] == word
    if word != mega.CT_RUNTIME:
        # a specialised instance runs exactly its word
        assert mega.flag_word(flags, is_electron) == word


def test_instances_are_distinct_and_end_with_the_runtime_one():
    assert len(set(mega.INSTANCES)) == len(mega.INSTANCES)
    assert mega.INSTANCES[-1] == mega.CT_RUNTIME
    assert all(w >= 0 for w in mega.INSTANCES[:-1])
    # a proton word never carries the loss bit; an electron word may
    for w in mega.INSTANCES[:-1]:
        if not w & mega.CT_ELECTRON:
            assert not w & _RAD


@pytest.mark.parametrize("bit", [b for _, b in mega._FLAG_NAMES]
                         + [mega.FLAG_CUSTOM_FRG])
@pytest.mark.parametrize("is_electron", [False, True])
def test_every_single_flag_has_an_instance_that_runs_it(bit, is_electron):
    """Whatever the flag word, some instance takes it: its own or the
    run-time one."""
    i = mega.instance_of(bit, is_electron)
    w = mega.INSTANCES[i]
    assert w == mega.CT_RUNTIME or w == mega.flag_word(bit, is_electron)


@pytest.mark.parametrize("kind,word", [
    ("flagship", 0), ("protons", 120), ("electrons", 380),
    ("protons-shipped", -1), ("protons-frg", 248)])
def test_populations_run_the_instance_named_for_them(kind, word):
    tabs, _, _ = _inputs(kind)
    assert mega.INSTANCES[mega.instance_of(tabs.flags,
                                           tabs.is_electron)] == word
