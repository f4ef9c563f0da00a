"""The port's mesh (parallel/shard.py, parallel/multihost.py and the
mesh paths of engine/run.py) on the CPU: ranks are processes started by
``parallel.multihost.spawn`` (spawn, joined by gloo, each with a time
limit), running tests/torch_mesh_cases.py, which imports torch and the
port only.

tests/test_parallel.py's small config (48 injected, 64 a pcut, 3 pcuts)
at a helix cap of 128 in every engine:

* the XLA engine (float64) at world 2 and 3, under ``fused=True``,
  which a mesh runs with the host split as the JAX package does, against
  the port's single-process ``fused=False`` run: pushes, trajectories,
  each segment's new lanes and the exit reasons exactly, every tally
  within 1e-12 of its value (and of its largest entry, for entries near
  0), and every lane handed to the host split bit for bit;
* K1's plain version (float32) with ``fused=False`` at world 2: the same;
* the mesh hybrid ladder (K1, fused) at world 2 with every pcut above
  pmax and the helix cap at 24 (tests/test_mesh_hybrid.py's trick: no
  lane is split, so the mesh cannot change a trajectory): push totals
  exactly, the one dead segment's ``n_new == 0`` on every rank, the
  escape PSDs within 1e-12 bin by bin; and on the real ladder, the
  ranks' counts agree and add up, every segment's split keeps its
  contract (each rank's share of the target n_target // 2, one more on
  rank 0 for an odd target; n_saved * max(share // n_saved, 1) new
  lanes a rank, summing to the segment's n_new; each rank's new lanes'
  weight its saved lanes' within 2^-23 of it: a new lane's weight is one
  float32 rounding of its saved lane's over the multiplicity, 2^-24),
  and, with 192 injected lanes so that both ranks hold some, no two
  lanes of the ranks' new populations share a key;
* the mesh hybrid ladder on ops/mega.py ``drive_ladder_async``, each of
  its cases (and k1-f32-tail, whose chain dies at its third of 5
  segments, off a sync point at 8, so that dead segments are
  dispatched) at MCS_HYBRID_SYNC_EVERY 8, 1 and 0: every rank's lanes
  after each split, new lanes, pushes, trajectories, the splits'
  integer fields, exit reasons and tallies bit for bit the same at the
  three cadences, the weights within 1e-12; one gather a sync point and
  one at the end besides the species' reductions; and the JAX package's
  scheduler, replaying the chain's summed new lanes and pushes,
  dispatches what each rank dispatched and returns the same arrays;
* the world-2 XLA engine against the JAX package's
  ``TransportEngine(setup, mesh=make_mesh(2))`` on the suite's 8-device
  CPU mesh: pushes and trajectories exactly, the float64 tallies within
  1e-6 and the float32 PSDs within 1e-5 of their largest entry (the
  tolerances of tests/test_torch_xla_slice.py: the two packages' float32
  cosines differ by an ulp).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (the suite's CPU mesh, tests/conftest.py)
import jax.numpy as jnp

from montecarloscattering_jl_tpu.engine.run import TransportEngine as JEngine
from montecarloscattering_jl_tpu.engine.setup import build_setup as jsetup
from montecarloscattering_jl_tpu.ops import fused_ion as jfused
from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu.parallel import make_mesh as jmesh
from montecarloscattering_jl_tpu.utils import load_config as jload
from montecarloscattering_jl_tpu_torch.parallel import multihost

import torch_mesh_cases as mc

TIMEOUT = 300
# the accumulators summed once a species: one all_reduce of each of the
# 9 tally, 7 escape and 1 exit-reason fields
REDUCTIONS = 17
TALLIES = ("psd", "therm_psd", "num_crossings", "pxx_flux",
           "pxz_flux", "energy_flux")
# the mesh hybrid's runs, (case, dead), each at the default
# MCS_HYBRID_SYNC_EVERY (8) and at every cadence of CADENCES; a run at a
# cadence is keyed "<case>@<cadence>"
HYBRID_RUNS = [("k1-f32", False), ("k1-f32-wide", False),
               ("k1-f32", True), ("k1-f32-tail", False)]
CADENCES = ("1", "0")


def _key(case, dead, sync_every=None):
    return (case + ("-dead" if dead else "")
            + (f"@{sync_every}" if sync_every else ""))


@pytest.fixture(scope="module")
def worlds():
    """{world: [per rank: {case: result}]} of the spawned runs."""
    cases = {2: [("xla-f64", False, None), ("k1-f32-host", False, None)]
             + [(c, d, s) for c, d in HYBRID_RUNS
                for s in (None,) + CADENCES],
             3: [("xla-f64", False, None)]}
    out = {}
    for world, cs in cases.items():
        ranks = multihost.spawn(mc.engine_cases, world, args=(cs,),
                                device="cpu", timeout=TIMEOUT)
        out[world] = [{_key(*c): r for c, r in zip(cs, rank)}
                      for rank in ranks]
    return out


@pytest.fixture(scope="module")
def single():
    """The single-process references, in this process."""
    return {"xla-f64": mc.engine_case(None, "xla-f64-host"),
            "k1-f32-host": mc.engine_case(None, "k1-f32-host"),
            "k1-f32-dead": mc.engine_case(None, "k1-f32", dead=True)}


def _close(a, b, tol, err):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(b, a, rtol=tol,
                               atol=tol * np.abs(a).max(), err_msg=err)


HOST_CASES = [(2, "xla-f64"), (3, "xla-f64"), (2, "k1-f32-host")]


@pytest.mark.parametrize("world,case", HOST_CASES)
def test_host_split_counts_match_single_process(worlds, single, world,
                                                case):
    ref = single[case]
    for got in (rank[case] for rank in worlds[world]):
        assert got["batch"] % (128 * world) == 0
        assert (got["pushes"], got["trajectories"], got["n_new"]) == (
            ref["pushes"], ref["trajectories"], ref["n_new"])
        assert ref["trajectories"] > 48        # the chain split
        # index 0 counts the padding, which grows with the batch
        np.testing.assert_array_equal(got["reasons"][1:],
                                      ref["reasons"][1:])


@pytest.mark.parametrize("world,case", HOST_CASES)
def test_host_split_tallies_match_single_process(worlds, single, world,
                                                 case):
    ref, got = single[case], worlds[world][0][case]
    for name in TALLIES:
        assert np.abs(ref[name]).max() > 0, name
        _close(ref[name], got[name], 1e-12, name)
    for name, a in ref["esc"].items():
        _close(a, got["esc"][name], 1e-12, name)


@pytest.mark.parametrize("world,case", HOST_CASES)
def test_host_split_lanes_bit_for_bit(worlds, single, world, case):
    """Every population the split was handed: the single process's
    lanes, then zero-weight FINISHED padding up to the mesh's batch."""
    ref, got = single[case], worlds[world][0][case]
    assert len(got["split_inputs"]) == len(ref["split_inputs"]) == 3
    for a, b in zip(ref["split_inputs"], got["split_inputs"]):
        n = len(a["weight"])
        for k in a:
            np.testing.assert_array_equal(b[k][:n], a[k], err_msg=k)
        assert not b["weight"][n:].any()
        assert (b["status"][n:] == 2).all()


def test_mesh_hybrid_dead_ladder(worlds, single):
    ref = single["k1-f32-dead"]
    for got in (rank["k1-f32-dead"] for rank in worlds[2]):
        assert got["pushes"] == ref["pushes"] == 48 * 24
        assert got["trajectories"] == ref["trajectories"] == 48
        assert got["n_new"] == ref["n_new"] == [0]
        # no sync point in 3 segments: the gather at the end, then the
        # species' reductions
        assert got["collectives"] == 1 + REDUCTIONS
    got = worlds[2][0]["k1-f32-dead"]
    checked = 0
    for name in ("esc_psd_dw", "esc_psd_up", "esc_energy_eff",
                 "esc_num_eff"):
        a = ref["esc"][name]
        np.testing.assert_allclose(got["esc"][name], a, rtol=1e-12, atol=0,
                                   err_msg=name)
        checked += int(a.sum() != 0)
    assert checked > 0


def test_mesh_hybrid_ranks_agree(worlds):
    """The real ladder: each rank splits its own lanes, so the counts are
    the mesh's own (statistically the single process's), the same on
    every rank and consistent."""
    a, b = (rank["k1-f32"] for rank in worlds[2])
    for k in ("pushes", "trajectories", "n_new"):
        assert a[k] == b[k], k
    assert a["trajectories"] == 48 + sum(a["n_new"]) > 48
    np.testing.assert_array_equal(a["reasons"][1:], b["reasons"][1:])
    # a gather a sync point and one at the end, then the reductions
    assert a["collectives"] == (a["sync_points"] + 1) + REDUCTIONS


HYBRID_CASES = ["k1-f32", "k1-f32-wide", "k1-f32-tail"]


def _real_splits(rank, case):
    return [sp for sp in rank[case]["splits"] if sp["n_saved"].sum() > 0]


@pytest.mark.parametrize("case", HYBRID_CASES)
def test_mesh_hybrid_split_shares_and_lanes(worlds, case):
    """Each segment's split: every rank's share of the target and the
    new lanes it made from its saved lanes (tests/test_mesh_hybrid.py
    holds the JAX package's sharded split to the same shares)."""
    a, b = worlds[2]
    splits = a[case]["splits"]
    assert len(splits) == len(a[case]["n_new"])
    assert _real_splits(a, case)
    for sp, n_new in zip(splits, a[case]["n_new"]):
        nt = sp["n_target"]
        share = [nt // 2 + (nt % 2), nt // 2]
        assert sp["target"].tolist() == share
        made = [s * max(t // s, 1) if s else 0
                for s, t in zip(sp["n_saved"].tolist(), share)]
        assert sp["n_new"].tolist() == made
        assert sum(made) == n_new
    for sa, sb in zip(splits, b[case]["splits"]):
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("case", HYBRID_CASES)
def test_mesh_hybrid_split_keeps_weight(worlds, case):
    """Each rank's new lanes carry its saved lanes' weight."""
    for sp in _real_splits(worlds[2][0], case):
        for ws, wn, s in zip(sp["w_saved"], sp["w_new"], sp["n_saved"]):
            assert (ws > 0) == (s > 0)
            assert abs(wn - ws) <= 2.0 ** -23 * ws, (wn, ws)


def test_mesh_hybrid_both_ranks_split(worlds):
    """With 192 injected lanes both ranks save lanes in a segment, and
    the counts stay the same on both ranks."""
    a, b = (rank["k1-f32-wide"] for rank in worlds[2])
    assert any((sp["n_saved"] > 0).all() for sp in a["splits"])
    for k in ("pushes", "trajectories", "n_new"):
        assert a[k] == b[k], k


def test_mesh_hybrid_split_keys_disjoint(worlds):
    """No two new lanes of the ranks share a key: each rank's keys are
    offset by its first lane."""
    a, b = (rank["k1-f32-wide"] for rank in worlds[2])
    ka, kb = a["split_keys"], b["split_keys"]
    assert len(ka) == len(kb) == len(a["n_new"])
    checked = 0
    for x, y, n_new in zip(ka, kb, a["n_new"]):
        keys = np.concatenate([x, y])
        assert len(keys) == n_new
        assert len(np.unique(keys)) == len(keys)
        checked += int(len(x) > 0 and len(y) > 0)
    assert checked > 0


def test_mesh_hybrid_dead_ladder_splits(worlds):
    for rank in worlds[2]:
        (sp,) = rank["k1-f32-dead"]["splits"]
        assert sp["n_saved"].tolist() == sp["n_new"].tolist() == [0, 0]
        assert sp["w_saved"].tolist() == sp["w_new"].tolist() == [0.0, 0.0]


HYBRID_KEYS = [_key(c, d) for c, d in HYBRID_RUNS]
SPLIT_INTS = ("n_saved", "target", "n_new", "nsteps")


def _same_lanes(a, b, err):
    """Two populations of a split: every field bit for bit, the weights
    within 1e-12."""
    for k in a:
        if k == "weight":
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=0,
                                       err_msg=err)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{err} {k}")


@pytest.mark.parametrize("sync_every", CADENCES)
@pytest.mark.parametrize("key", HYBRID_KEYS)
def test_mesh_hybrid_same_bits_at_every_cadence(worlds, key, sync_every):
    """Every rank at MCS_HYBRID_SYNC_EVERY 1 and 0 against the default 8:
    the lanes each split made up to the chain's death, the counts, the
    splits, the exit reasons and the tallies."""
    for r, rank in enumerate(worlds[2]):
        ref, got = rank[key], rank[f"{key}@{sync_every}"]
        for k in ("pushes", "trajectories", "n_new"):
            assert got[k] == ref[k], (r, k)
        np.testing.assert_array_equal(got["reasons"], ref["reasons"])
        assert len(got["splits"]) == len(ref["splits"]) == len(ref["n_new"])
        for sa, sb in zip(ref["splits"], got["splits"]):
            assert sa["n_target"] == sb["n_target"]
            for k in SPLIT_INTS:
                np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
            for k in ("w_saved", "w_new"):
                np.testing.assert_allclose(sb[k], sa[k], rtol=1e-12,
                                           atol=0, err_msg=k)
        n = len(ref["n_new"])
        for i in range(n):
            _same_lanes(ref["split_lanes"][i], got["split_lanes"][i],
                        f"rank {r} segment {i}")
        for name in TALLIES:
            np.testing.assert_array_equal(got[name], ref[name],
                                          err_msg=name)
        for name, v in ref["esc"].items():
            np.testing.assert_array_equal(got["esc"][name], v,
                                          err_msg=name)


@pytest.mark.parametrize("key", ["k1-f32-tail", "k1-f32-dead"])
def test_mesh_hybrid_dead_segments_are_no_ops(worlds, key):
    """A chain that dies off a sync point: at 8 and 0 a sync every rank
    dispatches the segments after the death (their splits make nothing),
    at 1 none, and the counts are cadence 1's (the test above)."""
    for rank in worlds[2]:
        n = len(rank[key]["n_new"])
        assert rank[key]["n_new"][-1] == 0 and n < rank[key]["n_seg"]
        assert len(rank[f"{key}@1"]["split_lanes"]) == n
        for k in (key, f"{key}@0"):
            lanes = rank[k]["split_lanes"]
            assert len(lanes) == rank[k]["n_seg"] > n
            for pop in lanes[n - 1:]:
                assert (pop["status"] == 2).all() and not pop["weight"].any()
    assert worlds[2][0]["k1-f32-tail"]["n_new"][0] > 0


@pytest.mark.parametrize("sync_every", (None,) + CADENCES)
@pytest.mark.parametrize("key", HYBRID_KEYS)
def test_mesh_hybrid_collectives_at_the_sync_points(worlds, key,
                                                    sync_every):
    """A gather a sync point and one at the end, then the species'
    reductions; the ranks make the same ones."""
    runs = [rank[_key(key, False, sync_every)] for rank in worlds[2]]
    every = int(sync_every or 8)
    for got in runs:
        dispatched = len(got["split_lanes"])
        want = dispatched // every if every else 0
        assert got["sync_points"] == want
        assert got["collectives"] == (got["sync_points"] + 1) + REDUCTIONS
    assert runs[0]["collectives"] == runs[1]["collectives"]


@pytest.mark.parametrize("sync_every", ("8",) + CADENCES)
@pytest.mark.parametrize("key", HYBRID_KEYS)
def test_mesh_hybrid_dispatches_as_the_jax_scheduler(worlds, monkeypatch,
                                                     key, sync_every):
    """The chain's new lanes and pushes a segment, summed over the ranks,
    replayed through the JAX package's drive_ladder_async
    (ops/pallas_step.py): it dispatches as many segments as each rank
    did, and its arrays are the run's."""
    monkeypatch.setenv("MCS_HYBRID_SYNC_EVERY", sync_every)
    k = key if sync_every == "8" else f"{key}@{sync_every}"
    got = worlds[2][0][k]
    n_seg = got["n_seg"]
    n_new = np.zeros(n_seg, np.int64)
    nsteps = np.zeros(n_seg, np.int64)
    n_new[:len(got["n_new"])] = got["n_new"]
    for i, sp in enumerate(got["splits"]):
        nsteps[i] = sp["nsteps"].sum()
    ran = []

    def dispatch(i):
        ran.append(i)
        return (jnp.asarray(n_new[i], jnp.int32),
                jnp.asarray(nsteps[i], jnp.float64))

    ref_n, ref_s = ps.drive_ladder_async(dispatch, n_seg)
    for rank in worlds[2]:
        assert len(rank[k]["split_lanes"]) == len(ran)
    np.testing.assert_array_equal(np.asarray(ref_n), n_new)
    np.testing.assert_array_equal(np.asarray(ref_s), nsteps)
    assert int(np.asarray(ref_s).sum()) == got["pushes"]


def test_ranks_import_no_jax(worlds):
    assert not any(r["jax_loaded"] for w in worlds.values()
                   for rank in w for r in rank.values())


def test_host_split_collectives(worlds):
    """A gather a segment, then the species' reductions."""
    for world in (2, 3):
        got = worlds[world][0]["xla-f64"]
        assert got["collectives"] == len(got["n_new"]) + REDUCTIONS
        assert got["mesh"]["backend"] == "gloo"


def test_world_2_matches_the_jax_mesh(worlds, monkeypatch):
    """The JAX package's host-split loop under its 2-device mesh
    (sharded_run_segment, psum over the mesh) on the same config."""
    monkeypatch.setattr(stp, "MAX_HELIX_STEPS", mc.CAP)
    # the cap is a trace-time constant of the JAX segment
    for clear in (stp.run_segment_jit.clear_cache,
                  stp.run_segment_hjit.clear_cache,
                  jfused.run_ion_fused_jit.clear_cache,
                  jfused._XLA_HYBRID_CACHE.clear, ps._HYBRID_CACHE.clear):
        clear()
    cfg = jload(mc.CFG)
    cfg.n_pts_inj = 48
    cfg.n_pts_pcut = cfg.n_pts_pcut_hi = 64
    cfg.pcuts = cfg.pcuts[:3]
    setup = jsetup(cfg)
    eng = JEngine(setup, mesh=jmesh(2))
    it = eng.new_iteration_tallies()
    res = eng.run_ion(0, 0, setup.profile, it)
    got = worlds[2][0]["xla-f64"]
    assert eng.batch_size == got["batch"]
    assert (got["pushes"], got["trajectories"]) == (res.n_pushes,
                                                    res.n_trajectories)
    np.testing.assert_array_equal(got["num_crossings"], res.num_crossings)
    for name in ("psd", "therm_psd"):
        a = np.asarray(getattr(res, name), np.float64)
        assert got[name].shape == a.shape
        assert np.abs(got[name] - a).max() <= 1e-5 * np.abs(a).max(), name
    for name in ("pxx_flux", "pxz_flux", "energy_flux"):
        a = getattr(it, name)
        assert np.abs(got[name] - a).max() <= 1e-6 * np.abs(a).max(), name
    for name in ("esc_psd_dw", "esc_psd_up", "esc_flux"):
        a = np.asarray(getattr(res.esc, name), np.float64)
        assert (np.abs(got["esc"][name] - a).max()
                <= 1e-6 * np.abs(a).max()), name
