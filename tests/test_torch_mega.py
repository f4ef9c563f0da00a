"""The transport kernel's plain PyTorch version (ops/mega.py step_twin)
against the JAX megakernel, on the CPU.

* Per lane, over a short horizon: one launch of 16 steps on 256 lanes of
  the DSA test population, against ``run_segment_mega(...,
  interpret=True)``.  Both packages draw the same uniforms (the lane-keyed
  counter RNG), so lanes follow the same trajectories.  Integer fields
  must agree on at least 99% of lanes (divergent lanes are counted: a
  position within one f32 ulp of a boundary, which the reference
  compares in f32 and the port in f64, can take another branch); float
  fields to rtol 1e-5, momenta relative to the lane's total momentum
  (the reference's XLA fuses multiply-adds, the port rounds each
  product, and a near-cancelling pitch cosine magnifies the last bit);
  tally totals to 1e-2, which covers the reference's bf16 stochastic
  rounding.
* Statistically, over a full drain: the twin against the XLA engine
  (``ops/step.run_segment``), with the tolerances of the JAX package's
  TestMegaSegmentStatistical; the helix cap is lowered to 1024 steps for
  both (the ``low_cap`` fixture) to keep the CPU time bounded.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu.ops import state as jst
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu_torch.ops import mega
from montecarloscattering_jl_tpu_torch.ops import state as tst

H = 16          # steps in the per-lane horizon
LANES = 256


def _np(nt):
    d = {k: np.asarray(v) for k, v in nt._asdict().items() if k != "key"}
    if "key" in nt._fields:
        d["key"] = np.asarray(jax.random.key_data(nt.key))
    return d


def _port_inputs(state, tal, grids, sc, ss):
    st = tst.ParticleState.from_jax_numpy(_np(state))
    tl = tst.Tallies.from_jax_numpy(_np(tal))
    gr = tst.SegmentGrids.from_jax_numpy(_np(grids))
    scp = tst.SegmentScalars.from_jax_numpy(_np(sc))
    ssp = tst.StepStatic.from_jax(ss)
    return st, tl, mega.mega_tables(gr, scp, ssp, "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["ion", "electron"])
def horizon(request):
    """The electron case flips only the species flag of the same
    population: it covers the electron branches of the step (the
    effective gyro factor, the diffusion length and the PRP shrink);
    the static-flag branches are held in tests/test_torch_mega_flags.py."""
    import __graft_entry__ as ge
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, "MAX_HELIX_STEPS", H)
        mp.setattr(ps, "_LAUNCH_CACHE", {})
        setup, state, tal, grids, sc, ss = ge._build(
            batch=LANES, p_dtype=jnp.float32)
        if request.param == "electron":
            ss = dataclasses.replace(ss, is_electron=True)
        s_ref, t_ref = ps.run_segment_mega(state, tal, grids, sc, ss,
                                           steps_per_launch=H,
                                           interpret=True)
    st, tl, tb = _port_inputs(state, tal, grids, sc, ss)
    n_act = mega.launch(st, tb, tl, n_steps=H, max_helix=H)
    return _np(s_ref), jst.finalize_tallies(t_ref), st, tl, n_act


@pytest.mark.parametrize("field", ["status", "reason", "nsteps", "flags"])
def test_integer_fields_per_lane(horizon, field):
    ref, _, st, _, _ = horizon
    got = st.to_numpy()
    if field == "flags":
        names = ("downstream", "inj", "retro", "just_returned")
        same = np.all([ref[k] == got[k] for k in names], axis=0)
    else:
        same = ref[field] == got[field]
    n_div = int((~same).sum())
    assert n_div <= 0.01 * LANES, f"{field}: {n_div} divergent lanes"


def test_horizon_moves_lanes(horizon):
    ref, _, st, _, n_act = horizon
    # the horizon is the helix cap: every lane leaves ACTIVE, and the
    # lanes did step (the comparison is not vacuous)
    assert n_act == 0
    assert int(st.nsteps.sum()) > LANES * H // 2
    assert (ref["status"] != 0).all()


@pytest.mark.parametrize("field", ["pb", "pperp", "phi", "x", "prp_x",
                                   "acctime", "ux_prev", "xn_per",
                                   "t_step"])
def test_float_fields_per_lane(horizon, field):
    ref, _, st, _, _ = horizon
    got = st.to_numpy()
    same = np.all([ref[k] == got[k] for k in ("status", "nsteps")], axis=0)
    a = ref[field].astype(np.float64)[same]
    b = got[field].astype(np.float64)[same]
    if field in ("pb", "pperp"):
        scale = np.hypot(ref["pb"].astype(np.float64),
                         ref["pperp"].astype(np.float64))[same]
    else:
        scale = np.abs(a)
    np.testing.assert_array_less(np.abs(b - a), 1e-5 * scale + 1e-300)


@pytest.mark.parametrize("field", ["psd", "therm_psd", "pxx_flux",
                                   "pxz_flux", "energy_flux",
                                   "num_crossings"])
def test_tally_totals(horizon, field):
    _, f_ref, _, tl, _ = horizon
    f_got = tst.finalize_tallies(tl)
    a = float(np.asarray(getattr(f_ref, field), np.float64).sum())
    b = float(getattr(f_got, field).double().sum())
    assert a != 0.0
    assert abs(b - a) <= 1e-2 * abs(a), (field, a, b)


def test_lane_order_and_keys_untouched(horizon):
    ref, _, st, _, _ = horizon
    np.testing.assert_array_equal(st.to_numpy()["key"], ref["key"])
    np.testing.assert_array_equal(st.to_numpy()["weight"], ref["weight"])


# ---------------------------------------------------------------------------
# full drain, statistically against the XLA engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drains():
    import __graft_entry__ as ge
    cap = 1024

    def clear():       # the cap is a trace-time constant (conftest low_cap)
        stp.run_segment_jit.clear_cache()
        stp.run_segment_hjit.clear_cache()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, "MAX_HELIX_STEPS", cap)
        mp.setattr(stp, "MAX_HELIX_STEPS", cap)
        clear()
        setup, state, tal, grids, sc, ss = ge._build(
            batch=1024, p_dtype=jnp.float32)
        s1, t1 = stp.run_segment(state, tal, grids, sc, ss, 0)
        f1 = jst.finalize_tallies(t1)
    clear()
    st, tl, tb = _port_inputs(state, tal, grids, sc, ss)
    mega.drain(st, tb, tl, max_helix=cap)
    return _np(s1), f1, st.to_numpy(), tst.finalize_tallies(tl)


def test_drain_all_lanes_drained(drains):
    _, _, s2, _ = drains
    assert not (s2["status"] == 0).any()


def test_drain_status_mix(drains):
    s1, _, s2, _ = drains
    c1 = np.bincount(s1["status"], minlength=3)
    c2 = np.bincount(s2["status"], minlength=3)
    assert abs(c1[2] - c2[2]) < 6 * np.sqrt(max(c1[1], c2[1], 4))


def test_drain_step_totals(drains):
    s1, _, s2, _ = drains
    n1 = int(s1["nsteps"].astype(np.int64).sum())
    n2 = int(s2["nsteps"].astype(np.int64).sum())
    assert abs(n1 - n2) / n1 < 0.15


@pytest.mark.parametrize("field", ["psd", "therm_psd", "pxx_flux",
                                   "energy_flux", "num_crossings"])
def test_drain_tally_totals(drains, field):
    _, f1, _, f2 = drains
    a = float(np.asarray(getattr(f1, field), np.float64).sum())
    b = float(getattr(f2, field).double().sum())
    assert a != 0
    tol = {"psd": 0.5, "pxx_flux": 0.5, "energy_flux": 0.5}.get(field, 0.15)
    assert abs(b / a - 1.0) < tol, (field, a, b)


def test_drain_spectrum_shape(drains):
    _, f1, _, f2 = drains
    pa = np.asarray(f1.psd, np.float64).sum(axis=(1, 2))
    pb = f2.psd.double().sum(dim=(1, 2)).numpy()
    sel = pa > pa.max() * 3e-2
    r = pb[sel] / pa[sel]
    assert np.abs(np.log(r)).max() < 1.0, r


# ---------------------------------------------------------------------------
# the static-flag gate and the wrapper's checks
# ---------------------------------------------------------------------------

_PORTED_FLAGS = ("do_rad_losses", "do_retro", "do_tcuts",
                 "do_energy_transfer", "use_custom_eps_b", "dont_scatter",
                 "dont_dsa")


@pytest.mark.parametrize("flag", list(_PORTED_FLAGS) + [
    "frg_rg0_cm", "n_xspec", "parallel", "nb"])
def test_gate_raises_on_deferred_flags(flag):
    """The gate raises for what K1 does not run: x_spec detectors and
    oblique fields (the XLA engine's), a zone table beyond ZMAX.  The
    eight static flags it once raised for run (the custom f(r_g) law at
    alpha = 1.5, r_ref = 1e10 cm): the gate admits each, as the JAX
    megakernel's gate does, the flag reaches K1's tables as the bit of
    the static config the megakernel compiles with, and a 4-step launch
    of the
    twin with it on matches ``run_segment_mega(..., interpret=True)``
    per lane on the DSA population, to the horizon tests' tolerances
    (integer fields on 99% of lanes, float fields to 1e-5).  These lanes
    reach few of the flag branches in 4 steps; the population placed to
    reach each is held in tests/test_torch_mega_flags.py."""
    import __graft_entry__ as ge
    _, state, tal, grids, sc, ss_j = ge._build(batch=128,
                                                p_dtype=jnp.float32)
    ss = tst.StepStatic.from_jax(ss_j)
    mega.check_supported(ss)
    if flag not in _PORTED_FLAGS + ("frg_rg0_cm",):
        value = {"n_xspec": 2, "parallel": False, "nb": mega.ZMAX}[flag]
        with pytest.raises(NotImplementedError):
            mega.check_supported(dataclasses.replace(ss, **{flag: value}))
        return
    if flag == "frg_rg0_cm":
        ss_j = dataclasses.replace(ss_j, frg_rg0_cm=1.0e10, frg_alpha=1.5)
    else:
        ss_j = dataclasses.replace(ss_j, **{flag: True})
    assert ps.megakernel_supported(ss_j, jnp.float32, jnp.float32)
    assert ps._static_cfg(ss_j, n_tcut_slots=1)[flag]
    n_steps = 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, "MAX_HELIX_STEPS", n_steps)
        mp.setattr(ps, "_LAUNCH_CACHE", {})
        s_ref, _ = ps.run_segment_mega(state, tal, grids, sc, ss_j,
                                       steps_per_launch=n_steps,
                                       interpret=True)
    st, tl, tb = _port_inputs(state, tal, grids, sc, ss_j)
    mega.check_supported(tst.StepStatic.from_jax(ss_j))
    bit = dict(mega._FLAG_NAMES, frg_rg0_cm=mega.FLAG_CUSTOM_FRG)[flag]
    assert tb.flags == bit and int(tb.si[mega.SI_FLAGS]) == bit
    n_lanes = int(st.nsteps.numel())
    mega.launch(st, tb, tl, n_steps=n_steps, max_helix=n_steps)
    assert int(st.nsteps.sum()) > 0
    ref, got = _np(s_ref), st.to_numpy()
    for name in ("status", "reason", "nsteps", "tcut", "downstream", "inj",
                 "retro"):
        n_div = int((ref[name] != got[name]).sum())
        assert n_div <= 0.01 * n_lanes, f"{name}: {n_div} divergent lanes"
    same = (ref["status"] == got["status"]) & (ref["nsteps"] == got["nsteps"])
    p_ref = np.hypot(ref["pb"].astype(np.float64),
                     ref["pperp"].astype(np.float64))
    for name in ("pb", "pperp", "phi", "x", "prp_x", "acctime", "t_step"):
        assert np.isfinite(got[name]).all(), name
        a = ref[name].astype(np.float64)[same]
        b = got[name].astype(np.float64)[same]
        scale = p_ref[same] if name in ("pb", "pperp") else np.abs(a)
        np.testing.assert_array_less(np.abs(b - a), 1e-5 * scale + 1e-300,
                                     err_msg=name)


def test_wrapper_rejects_bad_inputs():
    import __graft_entry__ as ge
    _, state, tal, grids, sc, ss = ge._build(batch=128, p_dtype=jnp.float32)
    st2, tl2, tb2 = _port_inputs(state, tal, grids, sc, ss)
    with pytest.raises(ValueError):
        mega.launch(dataclasses.replace(st2, pb=st2.pb.double()), tb2, tl2,
                    n_steps=1)
    with pytest.raises(ValueError):
        mega.launch(st2, tb2, dataclasses.replace(
            tl2, psd_diff=tl2.psd_diff[:, :-1]), n_steps=1)
    before = mega.TWIN_CALLS
    mega.launch(st2, tb2, tl2, n_steps=1)
    assert mega.TWIN_CALLS == before + 1
