"""The fused pcut ladder without a host wait a segment, on the CPU.

* ``mega.drive_ladder_async`` against the JAX package's
  (ops/pallas_step.py ``drive_ladder_async``), driven by the same fake
  ``dispatch`` (jnp scalars for the JAX one, 0-dim torch tensors for the
  port's) replaying a fixed sequence of new lanes and pushes, at
  MCS_HYBRID_SYNC_EVERY 0, 1, 2, 3 and 8, from segment 0 and 2, with
  the chain dying on a sync point, off one, or never: the returned
  arrays are equal, and so are the calls of dispatch, check and capture
  with their arguments; the port's ``sync_at`` and ``stop`` keywords
  change no array, and with ``read`` (a mesh's: the chain's counts
  summed over the ranks, where dispatch returns a rank's that made no
  lane) the arrays and calls are the JAX one's, with a read a sync
  point and one at the end.
* ``split_on_device`` with nothing saved: a 0-dim int64 n_new of 0.
* ``TransportEngine.run_ion`` on shrunk tests/data/dsa_nonrel.toml (K1's
  twin at float32 and the XLA engine at float64; the chain dies at
  segment 2 or 3 of 6, which is no sync point at 8 a sync and leaves
  dead segments to dispatch), and on shrunk examples/03 with energy
  transfer on at float64 (the electrons read the ions' pool; its pcuts
  from the fourth on raised out of reach, so both species' chains die
  at segment 3 of 7), at
  MCS_HYBRID_SYNC_EVERY 1, 8 and 0: every IonResult field bit for bit
  the same at the three cadences.  A mid checkpoint every 2 segments at
  8 a sync: the same result, and the saves the cadence asks for.

One torch thread; the helix cap is 128 (ops/step.py and ops/mega.py).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
from montecarloscattering_jl_tpu_torch.ops import mega, split
from montecarloscattering_jl_tpu_torch.ops import state as stt
from montecarloscattering_jl_tpu_torch.parallel import checkpoint as ck
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

CAP = 128
N_SEG = 10
ELECTRONS = "examples/03_electron_synch_ic.toml"


def _sequence(die_at):
    """Each segment's (new lanes, pushes): the chain dies at `die_at`
    (its segment still pushes), and every later segment is a no-op."""
    n_new = [60 + 7 * i for i in range(N_SEG)]
    nsteps = [1_000 + 311 * i for i in range(N_SEG)]
    if die_at is not None:
        for i in range(die_at, N_SEG):
            n_new[i] = 0
            if i > die_at:
                nsteps[i] = 0
    return n_new, nsteps


def _drive(drive_fn, scalar, die_at, start):
    """`drive_fn` on the fake dispatch; (its result, its calls)."""
    n_new, nsteps = _sequence(die_at)
    calls = []

    def dispatch(i):
        calls.append(("dispatch", i))
        return scalar(n_new[i]), scalar(nsteps[i])

    def check(i):
        calls.append(("check", i))

    def capture(i, a, s):
        calls.append(("capture", i, a.dtype.name, a.tolist(),
                      s.dtype.name, s.tolist()))

    out = drive_fn(dispatch, N_SEG, check=check, capture=capture,
                   start=start)
    return out, calls


@pytest.mark.parametrize("die_at", [None, 3, 5, 7])
@pytest.mark.parametrize("start", [0, 2])
@pytest.mark.parametrize("sync_every", ["0", "1", "2", "3", "8"])
def test_drive_ladder_async_matches_jax(monkeypatch, sync_every, start,
                                        die_at):
    monkeypatch.setenv("MCS_HYBRID_SYNC_EVERY", sync_every)
    (ref_n, ref_s), ref_calls = _drive(
        ps.drive_ladder_async, lambda v: jnp.asarray(v, jnp.int32),
        die_at, start)
    (got_n, got_s), got_calls = _drive(
        mega.drive_ladder_async, lambda v: torch.tensor(v), die_at, start)
    assert got_calls == ref_calls
    assert got_n.dtype == np.int64 and got_s.dtype == np.uint64
    np.testing.assert_array_equal(got_n, np.asarray(ref_n))
    np.testing.assert_array_equal(got_s, np.asarray(ref_s))


@pytest.mark.parametrize("die_at", [None, 3, 5, 7])
@pytest.mark.parametrize("start", [0, 2])
@pytest.mark.parametrize("sync_every", ["0", "1", "2", "3", "8"])
def test_drive_ladder_async_read_matches_jax(monkeypatch, sync_every,
                                             start, die_at):
    """``read`` in place of what dispatch returns: dispatch gives a
    rank's own new lanes, 0 (its split made none while the chain lives),
    and ``read`` the chain's summed over the ranks.  The scheduler reads
    the segments since the last read at each sync point and every
    segment it ran at the end, and gives the JAX scheduler's arrays and
    calls."""
    monkeypatch.setenv("MCS_HYBRID_SYNC_EVERY", sync_every)
    (ref_n, ref_s), ref_calls = _drive(
        ps.drive_ladder_async, lambda v: jnp.asarray(v, jnp.int32),
        die_at, start)
    n_new, nsteps = _sequence(die_at)
    reads = []

    def read(i0, i1):
        reads.append((i0, i1))
        return np.array(n_new[i0:i1]), np.array(nsteps[i0:i1], np.float64)

    (got_n, got_s), got_calls = _drive(
        functools.partial(mega.drive_ladder_async, read=read),
        lambda v: torch.tensor(0), die_at, start)
    assert got_calls == ref_calls
    assert got_n.dtype == np.int64 and got_s.dtype == np.uint64
    np.testing.assert_array_equal(got_n, np.asarray(ref_n))
    np.testing.assert_array_equal(got_s, np.asarray(ref_s))
    syncs = [c[1] + 1 for c in ref_calls if c[0] == "check"]
    ran = max([c[1] for c in ref_calls if c[0] == "dispatch"]) + 1
    assert reads == ([(lo, hi) for lo, hi in zip([start] + syncs, syncs)]
                     + [(start, ran)])


def test_drive_ladder_async_sync_at(monkeypatch):
    """The port's extra sync points (a due mid checkpoint) add reads and
    captures where asked, and change nothing else."""
    monkeypatch.setenv("MCS_HYBRID_SYNC_EVERY", "0")
    n_new, nsteps = _sequence(None)
    seen = []
    out = mega.drive_ladder_async(
        lambda i: (torch.tensor(n_new[i]), torch.tensor(nsteps[i])), N_SEG,
        check=lambda i: seen.append(("check", i)),
        capture=lambda i, a, s: seen.append(("capture", i, len(a))),
        sync_at=lambda i: i in (1, 4))
    assert seen == [("check", 1), ("capture", 1, 2), ("check", 4),
                    ("capture", 4, 5)]
    np.testing.assert_array_equal(out[0], n_new)
    np.testing.assert_array_equal(out[1], nsteps)


@pytest.mark.parametrize("die_at", [None, 0, 3, 5])
@pytest.mark.parametrize("sync_every", ["0", "1", "8"])
def test_drive_ladder_async_stop_gives_the_same_arrays(monkeypatch,
                                                      sync_every, die_at):
    """``stop`` (the port's: the host has seen a finished split that made
    no lane) ends the queueing early; the arrays are the JAX one's, and
    no segment past the first dead one is dispatched."""
    monkeypatch.setenv("MCS_HYBRID_SYNC_EVERY", sync_every)
    (ref_n, ref_s), _ = _drive(ps.drive_ladder_async,
                               lambda v: jnp.asarray(v, jnp.int32), die_at,
                               0)
    n_new, nsteps = _sequence(die_at)
    ran = []

    def dispatch(i):
        ran.append(i)
        return torch.tensor(n_new[i]), torch.tensor(nsteps[i])

    got_n, got_s = mega.drive_ladder_async(
        dispatch, N_SEG, stop=lambda i: any(n_new[j] == 0
                                            for j in range(i + 1)))
    np.testing.assert_array_equal(got_n, np.asarray(ref_n))
    np.testing.assert_array_equal(got_s, np.asarray(ref_s))
    assert ran == list(range(N_SEG if die_at is None else die_at + 1))


def test_split_on_device_nothing_saved_is_a_device_zero():
    b = 64
    st = wl.flagship_population(
        build_setup(wl.load_variant(wl.CFG)), wl.load_variant(wl.CFG), "cpu",
        lanes=b)
    st.status = torch.full((b,), stt.FINISHED, dtype=torch.int32)
    new, n_new = split.split_on_device(st, 32, (1, 2))
    assert isinstance(n_new, torch.Tensor)
    assert n_new.dim() == 0 and n_new.dtype == torch.int64
    assert int(n_new) == 0
    assert bool((new.status == stt.FINISHED).all())
    assert bool((new.weight == 0).all())


@pytest.fixture(scope="module")
def one_thread():
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    with wl.helix_cap(CAP):
        yield
    torch.set_num_threads(n_thr)


def _dsa_cfg():
    cfg = wl.load_variant(wl.CFG, n_itrs=1)
    cfg.n_pts_inj = 40
    cfg.n_pts_pcut = cfg.n_pts_pcut_hi = 60
    return cfg


def _electron_cfg():
    cfg = wl.load_variant(ELECTRONS, replace=[
        ("calculate-photon-production = true",
         "calculate-photon-production = false"),
        ("energy-transfer-frac = 0.0", "energy-transfer-frac = 0.1")],
        n_itrs=1)
    cfg.n_pts_inj = 40
    cfg.n_pts_pcut = cfg.n_pts_pcut_hi = 60
    # no lane reaches the fourth pcut within the helix cap: the chain
    # dies at segment 3 of 7
    cfg.pcuts = cfg.pcuts[:3] + [p * 1e6 for p in cfg.pcuts[3:]]
    return cfg


CASES = {"k1-twin-f32": (_dsa_cfg, torch.float32),
         "xla-f64": (_dsa_cfg, torch.float64),
         "electrons-f64": (_electron_cfg, torch.float64)}


def _run(case, sync_every, monkeypatch, ckpt_every=0, tmp_path=None):
    """Every species of one iteration through the engine's fused ladder;
    (the IonResults, the iteration's tallies, the checkpointer)."""
    make, p_dtype = CASES[case]
    monkeypatch.setenv("MCS_HYBRID_SYNC_EVERY", str(sync_every))
    setup = build_setup(make())
    eng = TransportEngine(setup, device="cpu", p_dtype=p_dtype)
    it = eng.new_iteration_tallies(setup.profile)
    saver = None
    if ckpt_every:
        saver = ck.MidCheckpointer(str(tmp_path / "ck.npz"),
                                   every=ckpt_every)
    res = [eng.run_ion(0, i, setup.profile, it, ckpt=saver)
           for i in range(setup.cfg.n_ions)]
    return res, it, saver


def _fields(res) -> dict:
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if isinstance(v, torch.Tensor):
            v = v.numpy()
        elif dataclasses.is_dataclass(v):
            v = {g.name: np.asarray(getattr(v, g.name))
                 for g in dataclasses.fields(v)}
        out[f.name] = v
    return out


def _assert_same(a, b, tag):
    for name, va in _fields(a).items():
        vb = _fields(b)[name]
        if isinstance(va, dict):
            for k in va:
                np.testing.assert_array_equal(vb[k], va[k],
                                              err_msg=f"{tag} {name}.{k}")
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(vb, va, err_msg=f"{tag} {name}")
        else:
            assert vb == va, f"{tag} {name}: {vb} != {va}"


@pytest.fixture(scope="module")
def every_segment(one_thread):
    """Each case at one segment a sync (the per-segment loop's reads)."""
    with pytest.MonkeyPatch.context() as mp:
        return {case: _run(case, 1, mp) for case in CASES}


@pytest.mark.parametrize("sync_every", [8, 0])
@pytest.mark.parametrize("case", list(CASES))
def test_run_ion_same_bits_at_every_cadence(every_segment, monkeypatch,
                                            case, sync_every):
    ref, ref_it, _ = every_segment[case]
    got, got_it, _ = _run(case, sync_every, monkeypatch)
    # the chain dies inside the ladder, off a sync point, with dead
    # segments dispatched after it
    n_seg = len(CASES[case][0]().pcuts)
    assert any(0 < len(r.n_new) < n_seg and r.n_new[-1] == 0
               and len(r.n_new) % 8 != 0 for r in ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a.n_new and all(v > 0 for v in a.n_new[:-1])
        _assert_same(a, b, f"{case} species {i}")
    for name in ("pxx_flux", "energy_flux", "energy_pool",
                 "weight_coupled", "spectra_coupled"):
        np.testing.assert_array_equal(getattr(got_it, name),
                                      getattr(ref_it, name), err_msg=name)
    if case == "electrons-f64":
        assert float(np.sum(ref_it.energy_pool)) > 0
        assert ref[1].energy_received > 0


def test_run_ion_mid_checkpoints_at_their_cadence(every_segment,
                                                  monkeypatch, tmp_path):
    """A mid checkpoint every 2 segments at 8 segments a sync: every due
    segment is a sync point, so the saves are those of the per-segment
    loop (one a live even boundary) and the result is unchanged."""
    ref, _, _ = every_segment["xla-f64"]
    got, _, saver = _run("xla-f64", 8, monkeypatch, ckpt_every=2,
                         tmp_path=tmp_path)
    _assert_same(ref[0], got[0], "checkpointed")
    live = len(ref[0].n_new) - 1        # boundaries after a live split
    assert saver.n_saved == live // 2
    payload = ck.load_mid_checkpoint(str(tmp_path / "ck.npz"))
    last = 2 * (live // 2)
    assert payload["next_seg"] == last
    assert list(payload["n_new"]) == ref[0].n_new[:last]
