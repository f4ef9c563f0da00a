"""The XLA engine's live-lane compaction ladder
(montecarloscattering_jl_tpu_torch/ops/step.py run_segment's
``compact_levels``) against the uncompacted drain and against the JAX
package's ``run_segment_jit(..., compact_levels)``, on the CPU at
float64.

The JAX test's construction (tests/test_compaction.py): the flagship
population at pcut index 2, B = 2,048 lanes, every helix counter seeded
1,200 steps below the cap, so that a drain ends within 1,200 steps with
the cap firing as in production.  Levels 0, 1 and 2 (windows 2,048,
1,024 and 512).

Contract (the JAX package's): every lane ends bit-identical to level 0,
in its original slot, because a lane's uniforms are keyed by its own key
and step count; counts are exact; the shared tallies differ only in the
order of their sums (here: within 1e-12 of their largest entry).

Against the JAX ladder at level 2, with the reference's float32 cosine
of the scattering phase substituted (tests/test_torch_step.py): integer
fields on all but 0.1% of the lanes, float fields to 1e-12 relative
(momenta relative to the lane's |p|) on all but 0.5% of them and every
lane to 1e-6, the float64 flux tallies to 1e-6 of their largest entry
and the float32 PSD to 1e-5.  XLA contracts a*b+c into fused
multiply-adds; over up to 1,200 steps a few lanes amplify that rounding
(measured: every integer field equal, 5 of 2,048 lanes beyond 1e-12,
the worst 6.6e-8).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as ge
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu_torch.engine.run import (
    COMPACT_FLOOR, auto_compact_levels)
from montecarloscattering_jl_tpu_torch.ops import helix
from montecarloscattering_jl_tpu_torch.ops import state as tst
from montecarloscattering_jl_tpu_torch.ops import step as tstep

B = 2048
STEP_BUDGET = 1200
LEVELS = (0, 1, 2)
INT_FIELDS = ("status", "reason", "nsteps", "igrid", "downstream", "inj",
              "just_returned", "tcut")
FLOAT_FIELDS = ("pb", "pperp", "phi", "x", "prp_x", "acctime", "ux_prev",
                "xn_per", "t_step", "weight")


def _np(nt):
    d = {k: np.asarray(v) for k, v in nt._asdict().items() if k != "key"}
    if "key" in nt._fields:
        d["key"] = np.asarray(jax.random.key_data(nt.key))
    return d


def _xla_cos(x):
    """The reference's float32 cos (XLA's), for float32 arguments."""
    if x.dtype == torch.float32:
        return torch.from_numpy(np.array(jnp.cos(jnp.asarray(x.numpy()))))
    return _torch_cos(x)


_torch_cos = torch.cos


def _build(batch=B, budget=STEP_BUDGET):
    _, state, tal, grids, sc, ss = ge._build(batch=batch)
    state = state._replace(nsteps=jnp.full(
        batch, stp.MAX_HELIX_STEPS - budget, jnp.int32))
    return state, tal, grids, sc, ss


def _port(state, tal, grids, sc, ss):
    st = tst.ParticleState.from_jax_numpy(_np(state))
    tl = tst.Tallies.from_jax_numpy(_np(tal))
    tb = tstep.step_tables(
        tst.SegmentGrids.from_jax_numpy(_np(grids), "cpu", torch.float64),
        tst.SegmentScalars.from_jax_numpy(_np(sc)),
        tst.StepStatic.from_jax(ss), "cpu")
    return st, tl, tb


@pytest.fixture(scope="module")
def drains():
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    state, tal, grids, sc, ss = _build()
    out = {}
    for lv in LEVELS:
        st, tl, tb = _port(state, tal, grids, sc, ss)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "cos", _xla_cos)
            taken = tstep.run_segment(st, tl, tb, compact_levels=lv)
        out[lv] = (st, tl, taken)
    # K5's drain, its plain version on the CPU (ops/helix.py drain_plain)
    st, tl, tb = _port(state, tal, grids, sc, ss)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "cos", _xla_cos)
        taken = helix.drain(st, tl, tb, tstep.MAX_HELIX_STEPS,
                            tstep.SYNC_EVERY)
    out["drain"] = (st, tl, taken)
    s, t = stp.run_segment_jit(state, tal, grids, sc, ss, 2)
    out["jax"] = (_np(s), _np(t))
    torch.set_num_threads(n_thr)
    return out


def test_window_sizes():
    assert tstep.window_sizes(B, 0) == [B]
    assert tstep.window_sizes(B, 2) == [2048, 1024, 512]
    assert tstep.window_sizes(B, 5) == [2048, 1024, 512]   # 512 floor
    assert tstep.window_sizes(69_632, 5) == [69_632, 34_816, 17_408,
                                             8_704, 4_352, 2_176]
    assert tstep.window_sizes(69_632 + 64, 3) == [69_696]  # not 128-aligned


def test_every_lane_ended(drains):
    for lv in LEVELS:
        st, _, taken = drains[lv]
        assert not bool((st.status == tst.ACTIVE).any())
        assert STEP_BUDGET <= taken <= STEP_BUDGET + tstep.SYNC_EVERY
    # the drain is not vacuous: lanes end at many step counts
    st = drains[0][0]
    assert len(torch.unique(st.nsteps)) > 50


@pytest.mark.parametrize("lv", LEVELS[1:])
def test_lanes_bit_identical_in_their_slots(drains, lv):
    ref, got = drains[0][0], drains[lv][0]
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), \
            f.name


@pytest.mark.parametrize("lv", LEVELS)
def test_drain_takes_the_block_loops_steps(drains, lv):
    """K5's drain (its plain version) returns the steps the block loop
    takes at every compaction depth: whole 64-step blocks up to the
    longest lane's steps, which the budget bounds."""
    assert drains["drain"][2] == drains[lv][2]
    steps = drains["drain"][0].nsteps - (stp.MAX_HELIX_STEPS - STEP_BUDGET)
    assert drains["drain"][2] == helix.block_loop_steps(
        int(steps.max()), stp.MAX_HELIX_STEPS, tstep.SYNC_EVERY)


def test_drain_lanes_bit_identical(drains):
    """The drain's lanes are level 0's, every field, FL_JRET included."""
    ref, got = drains[0][0], drains["drain"][0]
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ref, f.name), getattr(got, f.name)), \
            f.name


@pytest.mark.parametrize("lv", LEVELS[1:])
def test_counts_exact_tallies_to_rounding(drains, lv):
    f0 = tst.finalize_tallies(drains[0][1])
    f1 = tst.finalize_tallies(drains[lv][1])
    assert torch.equal(f0.num_crossings, f1.num_crossings)
    for name in ("pxx_flux", "pxz_flux", "energy_flux", "psd", "therm_psd",
                 "px_esc_up", "en_esc_up", "sum_p_dw", "sum_ke_dw"):
        a = getattr(f0, name).double()
        b = getattr(f1, name).double()
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * scale, name


def test_ladder_matches_the_jax_ladder(drains):
    ref = drains["jax"][0]
    got = drains[2][0].to_numpy()
    same = np.ones(B, bool)
    for f in INT_FIELDS:
        same &= ref[f] == got[f]
    assert (~same).sum() <= 1e-3 * B, (~same).sum()
    np.testing.assert_array_equal(got["key"], ref["key"])
    p = np.hypot(ref["pb"], ref["pperp"])[same]
    worst = np.zeros(int(same.sum()))
    for f in FLOAT_FIELDS:
        a, b = ref[f][same], got[f][same]
        scale = p if f in ("pb", "pperp") else np.abs(a)
        worst = np.maximum(worst, np.abs(b - a) / np.maximum(scale, 1e-300))
    assert (worst > 1e-12).sum() <= 5e-3 * B, np.sort(worst)[-20:]
    assert worst.max() <= 1e-6, worst.max()


@pytest.mark.parametrize("field,tol", [("flux_diff", 1e-6),
                                       ("psd_diff", 1e-5),
                                       ("sum_p_dw", 1e-6),
                                       ("sum_ke_dw", 1e-6)])
def test_ladder_tallies_match_the_jax_ladder(drains, field, tol):
    a = np.asarray(drains["jax"][1][field], np.float64)
    b = np.asarray(drains[2][1].to_numpy()[field], np.float64)
    scale = np.abs(a).max()
    assert scale > 0
    assert np.abs(b - a).max() <= tol * scale


@pytest.fixture()
def one_thread():
    # the plain step is ~300 small ops a step: one torch thread, as the
    # drains fixture runs it (many threads a worker crowd the cores)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_small_batch_skips_the_ladder(one_thread):
    """Windows below the 512-lane floor never form: levels on a 256-lane
    batch run the plain drain, lane for lane."""
    state, tal, grids, sc, ss = _build(batch=256, budget=200)
    out = []
    for lv in (0, 4):
        st, tl, tb = _port(state, tal, grids, sc, ss)
        tstep.run_segment(st, tl, tb, compact_levels=lv)
        assert not bool((st.status == tst.ACTIVE).any())
        out.append((st, tl))
    for f in dataclasses.fields(out[0][0]):
        assert torch.equal(getattr(out[0][0], f.name),
                           getattr(out[1][0], f.name)), f.name
    assert torch.equal(out[0][1].psd_diff, out[1][1].psd_diff)


@pytest.mark.parametrize("lanes,levels", [(69_632, 5), (8_192, 1),
                                          (4_096, 0)])
def test_auto_depth(lanes, levels):
    """The JAX package's auto rule (run.py:131-142): halve while the
    lanes number more than 4,096 and are a multiple of 256."""
    from montecarloscattering_jl_tpu.engine.run import TransportEngine
    assert COMPACT_FLOOR == 4096
    assert auto_compact_levels(lanes) == levels
    eng = TransportEngine.__new__(TransportEngine)
    eng.batch_size, eng.mesh = lanes, None
    assert eng._auto_compact_levels() == levels


def test_engine_defaults_to_auto():
    """TransportEngine, driver.run and the CLI default to -1 (auto), as
    the JAX package's do."""
    import inspect

    from montecarloscattering_jl_tpu_torch.engine import driver
    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config("tests/data/dsa_nonrel.toml")
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = 65_536
    eng = TransportEngine(build_setup(cfg), device="cpu")
    assert eng.batch_size == 69_632 and eng.compact_levels == 5
    assert TransportEngine(build_setup(cfg), device="cpu",
                           compact_levels=0).compact_levels == 0
    assert inspect.signature(driver.run).parameters[
        "compact_levels"].default == -1
