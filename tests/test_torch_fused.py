"""The host pcut splitter (montecarloscattering_jl_tpu_torch/ops/cuts.py
``pcut_split``) and the engine's ``fused=False`` ladder, on the CPU.

* The port's ``fused=True`` (split on the device) against ``fused=False``
  (split on the host), at tests/test_fused.py's sizes and tolerances:
  tests/data/dsa_nonrel.toml, 1 iteration, 40 particles injected, 60 a
  pcut, on both engines (float64 on the XLA engine, float32 on K1's
  plain version).  Both key a lane as fold_in(fold_in(ion_key, pcut + 1),
  lane) and lay the split population out alike, so pushes and
  trajectories are exact; the host path rebuilds pperp from (|p|, pb),
  so dN/dp agrees to 1e-5, the smoothed ux_sk and the escapes to 1e-6.
* The port's host split against the JAX package's ``run(...,
  fused=False)`` at float64: iteration 1's pushes and trajectories
  exactly.
* ``pcut_split`` against the JAX ``pcut_split`` on the same saved state:
  identical arrays, for a multiplicity of 1 and above; None with nothing
  saved.
* A segment-boundary checkpoint under ``fused=False``, resumed bit for
  bit; a resume into the fused ladder refuses it.

The helix cap is 128 in every engine (a CPU run of the XLA engine takes
~3 ms a step whatever the lane count), as tests/test_torch_checkpoint.py
sets it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as ge
from montecarloscattering_jl_tpu.engine import driver as jdriver
from montecarloscattering_jl_tpu.ops import cuts as jcuts
from montecarloscattering_jl_tpu.ops import fused_ion as jfused
from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu_torch.engine.driver import run
from montecarloscattering_jl_tpu_torch.ops import cuts, mega
from montecarloscattering_jl_tpu_torch.ops import state as tst
from montecarloscattering_jl_tpu_torch.ops import step as tstep
from montecarloscattering_jl_tpu_torch.parallel import checkpoint as ck
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

CAP = 128
CFG = "tests/data/dsa_nonrel.toml"
DTYPES = {"f64": torch.float64, "f32": torch.float32}
SPLIT_FIELDS = ("weight", "pb", "pperp", "phi", "x", "igrid", "ux_prev",
                "downstream", "inj", "xn_per", "prp_x", "acctime", "tcut")


def _cfg():
    cfg = wl.load_variant(CFG, n_itrs=1)
    cfg.n_pts_inj = 40
    cfg.n_pts_pcut = cfg.n_pts_pcut_hi = 60
    return cfg


def _clear_jax_caches():
    stp.run_segment_jit.clear_cache()
    stp.run_segment_hjit.clear_cache()
    jfused.run_ion_fused_jit.clear_cache()
    jfused._XLA_HYBRID_CACHE.clear()
    ps._HYBRID_CACHE.clear()


@pytest.fixture(scope="module")
def capped():
    """One torch thread and the helix cap CAP in every engine."""
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (stp, tstep, mega):
            mp.setattr(mod, "MAX_HELIX_STEPS", CAP)
        # the cap is a trace-time constant of the JAX segment
        _clear_jax_caches()
        yield
    _clear_jax_caches()
    torch.set_num_threads(n_thr)


@pytest.fixture(scope="module", params=list(DTYPES))
def pair(request, capped):
    pd = DTYPES[request.param]
    return {fused: run(_cfg(), "cpu", p_dtype=pd, fused=fused)
            for fused in (True, False)}


def test_trajectory_and_push_counts_match(pair):
    f, h = pair[True], pair[False]
    assert f.n_trajectories == h.n_trajectories > 0
    assert f.n_pushes == h.n_pushes > 0
    fa, ha = f.iterations[0].ion_finals[0], h.iterations[0].ion_finals[0]
    np.testing.assert_array_equal(fa.reason_counts, ha.reason_counts)


def test_spectra_match(pair):
    a = pair[True].iterations[-1].ion_finals[0].dndp_cr
    b = pair[False].iterations[-1].ion_finals[0].dndp_cr
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


def test_profile_match(pair):
    np.testing.assert_allclose(
        pair[True].iterations[-1].profile_after.ux_sk,
        pair[False].iterations[-1].profile_after.ux_sk, rtol=1e-6)


def test_escapes_match(pair):
    fe = pair[True].iterations[-1].ion_finals[0]
    he = pair[False].iterations[-1].ion_finals[0]
    np.testing.assert_allclose(fe.esc.esc_flux, he.esc.esc_flux, rtol=1e-6)
    np.testing.assert_allclose(fe.esc.esc_psd_up.sum(),
                               he.esc.esc_psd_up.sum(), rtol=1e-6)


def test_host_split_matches_the_jax_host_split(capped, tmp_path):
    """The port's fused=False against the JAX package's at float64: the
    same lanes, keys and splits, so iteration 1's counts are exact."""
    port = run(_cfg(), "cpu", p_dtype=torch.float64, fused=False)
    ref = jdriver.run(_cfg(), out_dir=str(tmp_path), p_dtype=jnp.float64,
                      fused=False)
    a, b = ref.iterations[0].ion_finals[0], port.iterations[0].ion_finals[0]
    assert (b.n_pushes, b.n_trajectories) == (a.n_pushes, a.n_trajectories)
    assert b.n_trajectories > 40      # the chain split at least once


def _saved_state(seed, frac_saved):
    """The JAX flagship state with lanes marked SAVED (and some FINISHED),
    and its port twin."""
    _, state, *_ = ge._build(batch=512)
    g = np.random.default_rng(seed)
    status = np.where(g.random(512) < frac_saved, jst_saved(), 0)
    status = np.where(g.random(512) < 0.2, 2, status)
    state = state._replace(
        status=jnp.asarray(status, jnp.int32),
        downstream=jnp.asarray(g.random(512) < 0.5),
        inj=jnp.asarray(g.random(512) < 0.3),
        acctime=jnp.asarray(g.random(512)),
        tcut=jnp.asarray(g.integers(0, 3, 512), jnp.int32),
        prp_x=jnp.asarray(g.random(512) * 1e10))
    d = {k: np.asarray(v) for k, v in state._asdict().items() if k != "key"}
    d["key"] = np.asarray(jax.random.key_data(state.key))
    return state, tst.ParticleState.from_jax_numpy(d)


def jst_saved():
    from montecarloscattering_jl_tpu.ops.state import SAVED
    assert SAVED == tst.SAVED
    return SAVED


@pytest.mark.parametrize("target,frac", [(60, 0.3), (600, 0.05),
                                         (1, 0.5)])
def test_pcut_split_matches_the_jax_split(target, frac):
    state, st = _saved_state(7, frac)
    ref = jcuts.pcut_split(state, target, 640)
    got = cuts.pcut_split(st, target, 640)
    assert (got.n, got.multiplicity) == (ref.n, ref.multiplicity)
    assert got.multiplicity == max(target // int(
        (np.asarray(state.status) == tst.SAVED).sum()), 1)
    for f in SPLIT_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f)
        assert a.shape == b.shape == (640,), f
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_pcut_split_of_nothing_saved():
    state, st = _saved_state(3, 0.0)
    assert jcuts.pcut_split(state, 60, 640) is None
    assert cuts.pcut_split(st, 60, 640) is None


@pytest.fixture(scope="module")
def host_kill(capped, tmp_path_factory):
    d = tmp_path_factory.mktemp("hostkill")
    path = str(d / "ck.npz")
    ref = run(_cfg(), "cpu", p_dtype=torch.float64, fused=False)
    with pytest.raises(ck.MidCheckpointStop), wl.kill_at(0, 0, 2):
        run(_cfg(), "cpu", p_dtype=torch.float64, fused=False,
            checkpoint=path, mid_every=1)
    peek = ck.load_mid_checkpoint(path + ".mid")
    res = run(_cfg(), "cpu", p_dtype=torch.float64, fused=False,
              checkpoint=path, resume=path + ".mid", mid_every=1)
    return ref, res, peek, path


def test_host_split_kill_and_resume_bitwise(host_kill):
    ref, res, peek, _ = host_kill
    assert (peek["mode"], peek["next_seg"]) == ("xla-host", 2)
    assert (res.n_pushes, res.n_trajectories) == (ref.n_pushes,
                                                  ref.n_trajectories)
    a, b = ref.iterations[0], res.iterations[0]
    for fa, fb in zip(a.ion_finals, b.ion_finals):
        for f in dataclasses.fields(fa):
            x, y = getattr(fa, f.name), getattr(fb, f.name)
            if dataclasses.is_dataclass(x):
                for g in dataclasses.fields(x):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(y, g.name)),
                        np.asarray(getattr(x, g.name)), err_msg=g.name)
            else:
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                              err_msg=f.name)
    for f in ("pxx_flux", "pxz_flux", "energy_flux"):
        np.testing.assert_array_equal(getattr(b.tallies, f),
                                      getattr(a.tallies, f), err_msg=f)


def test_fused_run_refuses_a_host_split_checkpoint(host_kill, tmp_path):
    _, _, peek, _ = host_kill
    p = str(tmp_path / "m.mid")
    ck.save_mid_checkpoint(p, peek)
    with pytest.raises(ValueError, match="engine"):
        run(_cfg(), "cpu", p_dtype=torch.float64, resume=p)
