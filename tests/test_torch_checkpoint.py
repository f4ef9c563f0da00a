"""Checkpoint and resume of the port (parallel/checkpoint.py, the
driver's checkpoint / resume / mid_every, the CLI's flags) on the CPU,
and against the JAX package's checkpoints.

Shrunk as tests/test_torch_examples.py shrinks examples/01 and 02 (40
particles a pcut, the helix cap 128 in every engine, the PSD at 5
momentum bins a decade, 10 cosine bins, 1 theta decade); examples/03
likewise, with photon production off and the baseline's
energy-transfer fraction 0.1 (two species, the ions' pool read by the
electrons).

* (a) MidCheckpointer's cadence, as tests/test_mid_checkpoint.py holds
  the JAX one's: bucket cadence, unaligned sync points, reset,
  stop-after-save, an atomic write that leaves no .tmp, an iteration NPZ
  that is not mid; a payload's nesting, dtypes and tensors round-trip.
* (b) An iteration NPZ written by either package loads through both
  packages' load_checkpoint with every array equal, and the two files
  hold the same keys in the same dtypes.
* (c) Cross-package resume: the JAX driver runs examples/02 at float64
  and writes its checkpoint after iteration 1; both drivers resume from
  that file to iteration 3.  Iteration 2 starts from one profile in
  both, so, as in test_iteration1_counts_exact, its pushes and
  trajectories are equal and its fluxes agree to 1e-6 of their largest
  entry; both smoothings use the weight 4.6 (4.0 x 1.15, carried in the
  checkpoint).  Iteration 3 starts from profiles that differ in the last
  digits and is held statistically, as test_iteration2_statistics does.
* (d) A run killed at a segment-boundary checkpoint and resumed is bit
  for bit the uninterrupted run: every IonFinal array and counter, the
  iteration tallies, the smoothed profile, the run's pushes and
  trajectories.  On K1's twin at float32, and on the XLA engine at
  float64 with energy transfer (examples/03 at its first 4 pcuts, 2
  iterations), killed inside the electrons' ladder of iteration 1 and
  at their first segment boundary of iteration 2.
* (e) A resume into another (iteration, species), engine, momentum
  dtype or batch size raises, and so does a JAX mid checkpoint (a
  pickle).
* (f) The CLI's --checkpoint, --resume and --mid-every, through
  ``main([... "--device", "cpu"])``; --mid-every without --checkpoint
  writes nothing.
"""

import dataclasses
import inspect
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.engine import driver as jdriver
from montecarloscattering_jl_tpu.ops import fused_ion as jfused
from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu.parallel import checkpoint as jck
from montecarloscattering_jl_tpu.utils import load_config as jload
from montecarloscattering_jl_tpu_torch.__main__ import main
from montecarloscattering_jl_tpu_torch.engine import driver as tdriver
from montecarloscattering_jl_tpu_torch.engine.driver import IonFinal, run
from montecarloscattering_jl_tpu_torch.ops import mega
from montecarloscattering_jl_tpu_torch.ops import step as tstep
from montecarloscattering_jl_tpu_torch.ops.finish import EscapeTallies
from montecarloscattering_jl_tpu_torch.parallel import checkpoint as ck
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 128
N = 40
PSD = (("num-psd-bins-per-decade = [10, 5]",
        "num-psd-bins-per-decade = [5, 5]"),
       ("psd-linear-cosine-bins = 30", "psd-linear-cosine-bins = 10"),
       ("psd-log-theta-decs = 2", "psd-log-theta-decs = 1"))
CONFIGS = {
    "02": ("02_nonlinear_smoothed.toml", (400, 400, 400), ()),
    "03et": ("03_electron_synch_ic.toml", (50, 100, 100),
             (("calculate-photon-production = true",
               "calculate-photon-production = false"),
              ("energy-transfer-frac = 0.0", "energy-transfer-frac = 0.1"))),
}
# (case, config, momentum dtype, iterations, the kill: iteration, species
# and segment boundary)
KILLS = (("k1-f32", "02", torch.float32, 2, (0, 0, 2)),
         ("xla-f64-electrons", "03et", torch.float64, 2, (0, 1, 2)),
         ("xla-f64-electrons-first-iter2", "03et", torch.float64, 2,
          (1, 1, 1)))
# examples/03 is cut to its first pcuts, as chip_smoke.py's electrons
# phase cuts it
PCUTS_03 = 4
FLUXES = ("pxx_flux", "pxz_flux", "energy_flux")


def _toml(d, name):
    fname, counts, extra = CONFIGS[name]
    text = open(os.path.join(ROOT, "examples", fname)).read()
    pts = tuple((f"{k} = {n}", f"{k} = {N}") for k, n in
                zip(("N_PTS_INJ", "N_PTS_PCUT", "N_PTS_PCUT_HI"), counts))
    for old, new in pts + PSD + extra:
        assert old in text, old
        text = text.replace(old, new)
    path = os.path.join(d, f"ex{name}.toml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _clear_jax_caches():
    stp.run_segment_jit.clear_cache()
    stp.run_segment_hjit.clear_cache()
    jfused.run_ion_fused_jit.clear_cache()
    jfused._XLA_HYBRID_CACHE.clear()
    ps._HYBRID_CACHE.clear()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """One torch thread, the helix cap CAP in every engine, and the
    shrunk configs' paths."""
    d = tmp_path_factory.mktemp("ckpt")
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (stp, tstep, mega):
            mp.setattr(mod, "MAX_HELIX_STEPS", CAP)
        # the cap is a trace-time constant of the JAX segment
        _clear_jax_caches()
        yield dict(dir=d, paths={k: _toml(str(d), k) for k in CONFIGS})
    _clear_jax_caches()
    torch.set_num_threads(n_thr)


def _cfg(env, name, **fields):
    cfg = wl.load_variant(env["paths"][name])
    if name == "03et":
        cfg.pcuts = cfg.pcuts[:PCUTS_03]
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


# ---- (a) the checkpointer -----------------------------------------------


class TestCadence:
    def test_bucket_cadence(self, tmp_path):
        c = ck.MidCheckpointer(str(tmp_path / "m.mid"), every=3)
        for seg in range(1, 10):
            c.maybe(seg, lambda: {})
        assert c.n_saved == 3               # segments 3, 6, 9

    def test_unaligned_sync_points_still_fire(self, tmp_path):
        c = ck.MidCheckpointer(str(tmp_path / "m.mid"), every=5)
        for seg in (8, 16, 24):
            c.maybe(seg, lambda: {})
        assert c.n_saved == 3

    def test_reset_for_next_species(self, tmp_path):
        c = ck.MidCheckpointer(str(tmp_path / "m.mid"), every=4)
        c.maybe(8, lambda: {})
        assert c.n_saved == 1
        c.reset()
        c.maybe(4, lambda: {})
        assert c.n_saved == 2
        c.reset(8)                          # resumed at segment 8
        c.maybe(8, lambda: {})
        assert c.n_saved == 2

    def test_stop_after_save(self, tmp_path):
        p = str(tmp_path / "m.mid")
        c = ck.MidCheckpointer(p, every=1, stop_after_save=True)
        with pytest.raises(ck.MidCheckpointStop):
            c.maybe(1, lambda: {"a": 1})
        assert ck.load_mid_checkpoint(p) == {"a": 1}

    def test_atomic_write_leaves_no_tmp(self, tmp_path):
        p = str(tmp_path / "m.mid")
        ck.save_mid_checkpoint(p, {"a": 1})
        assert os.path.exists(p) and not os.path.exists(p + ".tmp")
        assert ck.is_mid_checkpoint(p)

    def test_iteration_npz_is_not_mid(self, tmp_path):
        p = str(tmp_path / "it.npz")
        np.savez(p, x=np.ones(3))
        assert not ck.is_mid_checkpoint(p)

    def test_payload_roundtrip(self, tmp_path):
        p = str(tmp_path / "m.mid")
        esc = EscapeTallies.zeros(3, 2, "cpu")
        esc.esc_flux += 0.25
        payload = dict(
            mode="xla", next_seg=3, big=2 ** 40, x=float("inf"),
            arr=np.arange(6, dtype=np.int32).reshape(2, 3),
            scalar=np.float64(1.5), t=torch.arange(4, dtype=torch.float32),
            flags=torch.tensor([True, False]), esc=esc,
            nested={"t": (1, 2.5, None), "l": [np.zeros(2), "s"]})
        ck.save_mid_checkpoint(p, payload)
        back = ck.load_mid_checkpoint(p)
        assert back["mode"] == "xla" and back["next_seg"] == 3
        assert back["big"] == 2 ** 40 and back["x"] == float("inf")
        assert back["arr"].dtype == np.int32
        np.testing.assert_array_equal(back["arr"], payload["arr"])
        assert type(back["scalar"]) is np.float64 and back["scalar"] == 1.5
        assert torch.equal(back["t"], payload["t"])
        assert back["flags"].dtype == torch.bool
        assert type(back["esc"]) is EscapeTallies
        assert float(back["esc"].esc_flux) == 0.25
        assert back["nested"]["t"] == (1, 2.5, None)
        assert back["nested"]["l"][1] == "s"

    def test_foreign_objects_refused(self, tmp_path):
        with pytest.raises(TypeError):
            ck.save_mid_checkpoint(str(tmp_path / "m.mid"),
                                   {"f": object()})


# ---- (b), (c): iteration checkpoints across the packages ---------------


@pytest.fixture(scope="module")
def cross(env):
    """The JAX driver's checkpoint after iteration 1 of examples/02 at
    float64, and both drivers resumed from it to iteration 3, each
    writing its own checkpoint; smooth_grid's calls recorded."""
    d = env["dir"]
    path = env["paths"]["02"]
    ck_jax = str(d / "jax1.npz")
    cfg = jload(path)
    cfg.n_itrs = 1
    jdriver.run(cfg, p_dtype=jnp.float64, checkpoint=ck_jax)
    calls = {"jax": [], "torch": []}
    out = dict(ck_jax=ck_jax, calls=calls)
    with pytest.MonkeyPatch.context() as mp:
        for key, mod in (("jax", jdriver), ("torch", tdriver)):
            fn = mod.smooth_grid
            sig = inspect.signature(fn)

            def spy(*a, _fn=fn, _sig=sig, _calls=calls[key], **kw):
                out = _fn(*a, **kw)
                used = _sig.bind(*a, **kw).arguments["prof_weight_fac"]
                _calls.append((used, out[2]))
                return out
            mp.setattr(mod, "smooth_grid", spy)
        cfg = jload(path)
        cfg.n_itrs = 3
        out["ck_jax3"] = str(d / "jax3.npz")
        out["jax"] = jdriver.run(cfg, p_dtype=jnp.float64, resume=ck_jax,
                                 checkpoint=out["ck_jax3"])
        out["ck_torch3"] = str(d / "torch3.npz")
        out["torch"] = run(_cfg(env, "02", n_itrs=3), "cpu", resume=ck_jax,
                           checkpoint=out["ck_torch3"])
    return out


@pytest.mark.parametrize("writer", ["ck_jax", "ck_jax3", "ck_torch3"])
def test_iteration_npz_loads_in_both(cross, writer):
    a = jck.load_checkpoint(cross[writer])
    b = ck.load_checkpoint(cross[writer])
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "profile":
            for f in dataclasses.fields(a[k]):
                np.testing.assert_array_equal(getattr(b[k], f.name),
                                              getattr(a[k], f.name))
        else:
            np.testing.assert_array_equal(np.asarray(b[k]),
                                          np.asarray(a[k]), err_msg=k)


def test_iteration_npz_same_keys_and_dtypes(cross):
    files = [np.load(cross[w]) for w in ("ck_jax3", "ck_torch3")]
    try:
        kinds = [{k: (z[k].dtype, z[k].shape) for k in z.files}
                 for z in files]
    finally:
        for z in files:
            z.close()
    assert kinds[0] == kinds[1]
    assert int(np.load(cross["ck_torch3"])["i_iter"]) == 3


def test_cross_resume_iteration2_exact(cross):
    ref, got = cross["jax"], cross["torch"]
    assert len(ref.iterations) == len(got.iterations) == 2
    for fr, fg in zip(ref.iterations[0].ion_finals,
                      got.iterations[0].ion_finals):
        assert fg.n_pushes == fr.n_pushes > 10 * N
        assert fg.n_trajectories == fr.n_trajectories
    for field in FLUXES:
        a = np.asarray(getattr(ref.iterations[0].tallies, field))
        b = np.asarray(getattr(got.iterations[0].tallies, field))
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-6 * np.abs(a).max(),
                                   err_msg=field)


def test_cross_resume_weight_factor(cross):
    """examples/02's first smoothing keeps 4.0, each later one raises it
    by 1.15: the checkpoint after iteration 1 carries 4.0, iteration 2
    returns 4.6 and iteration 3 goes on with it."""
    assert float(np.load(cross["ck_jax"])["prof_weight_fac"]) == 4.0
    for key in ("jax", "torch"):
        np.testing.assert_allclose(
            cross["calls"][key], [(4.0, 4.6), (4.6, 4.6 * 1.15)],
            rtol=1e-12, err_msg=key)


def test_cross_resume_iteration3_statistics(cross):
    ref, got = cross["jax"].iterations[1], cross["torch"].iterations[1]
    fr, fg = ref.ion_finals[0], got.ion_finals[0]
    assert fg.n_pushes == pytest.approx(fr.n_pushes, rel=0.1)
    assert fg.n_trajectories == pytest.approx(fr.n_trajectories, rel=0.1)
    for f in FLUXES:
        a = float(np.sum(getattr(ref.tallies, f)))
        b = float(np.sum(getattr(got.tallies, f)))
        assert a != 0 and b == pytest.approx(a, rel=0.3), f


# ---- (d) kill and resume, bitwise ---------------------------------------


@pytest.fixture(scope="module")
def kills(env):
    """{case: (uninterrupted run, resumed run, the mid payload)}."""
    refs, out = {}, {}
    for case, name, pd, n_itrs, at in KILLS:
        if (name, pd) not in refs:
            refs[name, pd] = run(_cfg(env, name, n_itrs=n_itrs), "cpu",
                                 p_dtype=pd)
        path = str(env["dir"] / f"{case}.npz")
        with pytest.raises(ck.MidCheckpointStop), wl.kill_at(*at):
            run(_cfg(env, name, n_itrs=n_itrs), "cpu", p_dtype=pd,
                checkpoint=path, mid_every=1)
        peek = ck.load_mid_checkpoint(path + ".mid")
        res = run(_cfg(env, name, n_itrs=n_itrs), "cpu", p_dtype=pd,
                  checkpoint=path, resume=path + ".mid", mid_every=1)
        out[case] = (refs[name, pd], res, peek, path)
    return out


def _same(a, b, what):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{what}.{f.name}")
    elif a is None or isinstance(a, (int, float, str)):
        assert a == b, what
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=what)


@pytest.mark.parametrize("case", [k[0] for k in KILLS])
def test_kill_and_resume_bitwise(kills, case):
    ref, res, peek, _ = kills[case]
    at = next(k[4] for k in KILLS if k[0] == case)
    assert (peek["i_iter"], peek["i_ion"], peek["next_seg"]) == at
    assert res.n_pushes == ref.n_pushes
    assert res.n_trajectories == ref.n_trajectories
    tail = ref.iterations[at[0]:]
    assert len(res.iterations) == len(tail)
    for i, (a, b) in enumerate(zip(tail, res.iterations)):
        assert len(a.ion_finals) == len(b.ion_finals)
        for j, (fa, fb) in enumerate(zip(a.ion_finals, b.ion_finals)):
            assert isinstance(fb, IonFinal)
            _same(fa, fb, f"iteration {i} species {j}")
        _same(a.tallies, b.tallies, f"iteration {i} tallies")
        for f in ("gamma_downstream", "q_esc_px", "q_esc_en",
                  "px_esc_frac", "en_esc_frac"):
            assert getattr(a, f) == getattr(b, f), f
        _same(a.profile_after, b.profile_after, f"iteration {i} profile")


def test_killed_electrons_read_the_ions_pool(kills):
    ref, res, peek, _ = kills["xla-f64-electrons"]
    pool = peek["it"].energy_pool
    assert pool.sum() > 0
    np.testing.assert_array_equal(pool, ref.iterations[0].tallies.energy_pool)
    assert res.iterations[0].ion_finals[1].energy_received > 0


@pytest.mark.parametrize("case", [k[0] for k in KILLS])
def test_mid_checkpoint_removed_after_iteration(kills, case):
    _, _, _, path = kills[case]
    assert not os.path.exists(path + ".mid")
    assert ck.load_checkpoint(path)["i_iter"] == len(
        kills[case][0].iterations)


# ---- (e) mismatched resumes ---------------------------------------------


def test_resume_into_another_engine_raises(env, kills, tmp_path):
    _, _, peek, _ = kills["k1-f32"]
    p = str(tmp_path / "m.mid")
    ck.save_mid_checkpoint(p, peek)
    with pytest.raises(ValueError, match="engine"):
        run(_cfg(env, "02", n_itrs=2), "cpu", p_dtype=torch.float64,
            resume=p)


def test_resume_with_another_batch_size_raises(env, kills, tmp_path):
    _, _, peek, _ = kills["k1-f32"]
    p = str(tmp_path / "m.mid")
    ck.save_mid_checkpoint(p, peek)
    with pytest.raises(ValueError, match="lanes"):
        run(_cfg(env, "02", n_itrs=2, n_pts_pcut=4 * N), "cpu",
            p_dtype=torch.float32, resume=p)


def test_resume_into_another_species_raises(env, kills):
    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup

    _, _, peek, _ = kills["xla-f64-electrons"]
    eng = TransportEngine(build_setup(_cfg(env, "03et")), "cpu")
    for i_iter, i_ion in ((0, 0), (1, 1)):
        with pytest.raises(ValueError, match="iter"):
            eng.run_ion(i_iter, i_ion, peek["driver"]["profile"],
                        peek["it"], resume_mid=peek)


def test_jax_mid_checkpoint_refused(tmp_path):
    p = str(tmp_path / "jax.mid")
    jck.save_mid_checkpoint(p, {"mode": "host", "next_seg": 1})
    assert ck.is_mid_checkpoint(p)
    with pytest.raises(ValueError, match="JAX"):
        ck.load_mid_checkpoint(p)
    with open(p, "wb") as f:
        pickle.dump({"a": 1}, f, protocol=4)
    with pytest.raises(ValueError, match="pickle"):
        ck.load_mid_checkpoint(p)


# ---- (f) the CLI ---------------------------------------------------------


def test_cli_checkpoint_resume(env, tmp_path, monkeypatch):
    cfg = str(tmp_path / "cli.toml")
    with open(env["paths"]["02"]) as f:
        text = f.read().replace("num-iterations = 10", "num-iterations = 2")
    with open(cfg, "w") as f:
        f.write(text)
    out = str(tmp_path / "out")
    path = str(tmp_path / "cli.npz")
    args = [cfg, "-o", out, "--device", "cpu", "--f32"]
    # --mid-every alone is inert: no checkpoint, no stop
    monkeypatch.setenv("MCS_MID_STOP_AFTER", "1")
    assert main(args + ["--mid-every", "1"]) == 0
    assert not [f for f in os.listdir(tmp_path) if f.startswith("cli.n")]
    with pytest.raises(ck.MidCheckpointStop):
        main(args + ["--checkpoint", path, "--mid-every", "1"])
    assert ck.is_mid_checkpoint(path + ".mid")
    assert not os.path.exists(path)
    monkeypatch.delenv("MCS_MID_STOP_AFTER")
    assert main(args + ["--checkpoint", path, "--mid-every", "1",
                        "--resume", path + ".mid"]) == 0
    assert not os.path.exists(path + ".mid")
    assert ck.load_checkpoint(path)["i_iter"] == 2
    assert "mc_grid.dat" in os.listdir(out)
