"""The XLA engine's step (montecarloscattering_jl_tpu_torch/ops/step.py)
against the JAX package's ``helix_step`` at float64, on the CPU.

The flagship config (tests/data/dsa_nonrel.toml) with two x_spec
detectors at -/+0.5 r_g0; 2,048 lanes of its injected population at
pcut index 0 and 2, 32 steps; and a third case for the shock
reflection (the injection test of no_DSA_loop): injection fraction 0.5
and the lanes placed just downstream of the shock at a hundred times the
injection momenta (several times the downstream flow speed), so that lanes crossing back upstream draw the test.  Both packages draw the same uniforms (the
lane-keyed stream is bit-exact, tests/test_torch_rng.py), so lanes
follow the same trajectories.  The JAX tallies are flushed through
``_flush_records`` with ``hist_band = 0`` (the exact scatter).

Tolerances:

* integer fields (status, reason, step count, zone, flags): at most
  0.1% of lanes may differ (XLA contracts a*b+c into fused
  multiply-adds, so a value at a threshold can fall on the other side);
* the port with the reference's float32 cosine of the scattering phase
  substituted: float fields to 1e-12 relative (momenta relative to the
  lane's |p|), flux, detector spectra and escape sums (float64) to 1e-6
  of their largest entry, the float32 PSD difference array to 1e-5 of
  its largest entry (the same records summed in float32 in another
  order: up to ~100 adds into one entry at 2^-24 each);
* the port as it is: XLA's float32 cos is its own polynomial and
  differs from torch's by one float32 ulp on ~5% of phases; one ulp of
  cos moves a lane's pitch by ~1e-7 of |p|, and 32 steps accumulate
  that to at most 1e-4 relative on momenta and positions.  A record can
  then fall into the neighbouring bin: tally totals agree to 1e-4, and
  at most 0.1% of the nonzero entries differ by more than 1e-4 of the
  largest.

``run_segment`` with the host check every step and every 64 steps must
give identical state and tallies.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarloscattering_jl_tpu.engine.run import TransportEngine
from montecarloscattering_jl_tpu.engine.setup import build_setup
from montecarloscattering_jl_tpu.models.injection import init_pop
from montecarloscattering_jl_tpu.ops import state as jst
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu.utils import load_config
from montecarloscattering_jl_tpu_torch.ops import hist, rng
from montecarloscattering_jl_tpu_torch.ops import state as tst
from montecarloscattering_jl_tpu_torch.ops import step as tstep

CFG = "tests/data/dsa_nonrel.toml"
LANES = 2048
H = 32
INT_FIELDS = ("status", "reason", "nsteps", "igrid", "downstream", "inj",
              "just_returned")
FLOAT_FIELDS = ("pb", "pperp", "phi", "x", "prp_x", "acctime", "ux_prev",
                "xn_per", "t_step")
TALLIES = ("flux_diff", "psd_diff", "spectra_sf", "spectra_pf",
           "px_esc_up", "en_esc_up", "sum_p_dw", "sum_ke_dw")

_helix_jit = jax.jit(stp.helix_step, static_argnums=(4,))


def _np(nt):
    d = {k: np.asarray(v) for k, v in nt._asdict().items() if k != "key"}
    if "key" in nt._fields:
        d["key"] = np.asarray(jax.random.key_data(nt.key))
    return d


def _build(i_pcut, lanes=LANES, reflect=False):
    cfg = load_config(CFG)
    cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    setup = build_setup(cfg)
    eng = TransportEngine(setup, p_dtype=jnp.float64)
    prof = setup.profile
    grids = eng.segment_grids(prof)
    sc = eng.segment_scalars(0, i_pcut, prof.bmag2)
    ss = eng.step_static(0)
    pop = init_pop(np.random.default_rng(0), cfg.species, 0, 1,
                   cfg.energy_inj, True, cfg.n_pts_inj, setup.x_grid_start,
                   cfg.rg0, 1.0, True, -1.0, cfg.beta0, cfg.gamma0, cfg.u0,
                   setup.x_grid_rg, prof.ux_sk, prof.gamma_sf)
    reps = lanes // len(pop.ptot_pf) + 1
    t = lambda a: np.tile(a, reps)[:lanes]
    state = jst.init_state(t(pop.weight), t(pop.ptot_pf), t(pop.pb_pf),
                           t(pop.x_cm), t(pop.i_grid).astype(np.int32),
                           t(prof.ux_sk[pop.i_grid]), cfg.xn_per_fine,
                           setup.x_grid_stop, jax.random.key(0),
                           p_dtype=jnp.float64)
    if reflect:
        g = np.random.default_rng(1)
        x = g.uniform(0.0, 2.0 * cfg.rg0, lanes)
        ig = (np.searchsorted(setup.x_grid_cm, x, side="right") - 1)
        state = state._replace(x=jnp.asarray(x),
                               igrid=jnp.asarray(ig, jnp.int32),
                               ux_prev=jnp.asarray(prof.ux_sk[ig]),
                               pb=state.pb * 100.0, pperp=state.pperp * 100.0)
        sc = sc._replace(inj_frac=jnp.asarray(0.5, jnp.float64))
    b = setup.bins
    tal = jst.make_tallies(setup.nb, b.n_mom, b.n_theta, 2, 1, jnp.float32,
                           batch=lanes, chunk=8, p_dtype=jnp.float64)
    return state, tal, grids, sc, ss


def _port(state, tal, grids, sc, ss):
    st = tst.ParticleState.from_jax_numpy(_np(state))
    tl = tst.Tallies.from_jax_numpy(_np(tal))
    tb = tstep.step_tables(
        tst.SegmentGrids.from_jax_numpy(_np(grids), "cpu", torch.float64),
        tst.SegmentScalars.from_jax_numpy(_np(sc)),
        tst.StepStatic.from_jax(ss), "cpu")
    return st, tl, tb


def _steps(st, tl, tb, n):
    for _ in range(n):
        u = rng.lane_uniforms_xla(st.key0, st.key1, st.nsteps)
        tstep.helix_step(st, tl, tb, u, 10_000)


def _xla_cos(x):
    """The reference's float32 cos (XLA's), for float32 arguments."""
    if x.dtype == torch.float32:
        return torch.from_numpy(np.array(jnp.cos(jnp.asarray(x.numpy()))))
    return _torch_cos(x)


_torch_cos = torch.cos


def _xla_sin(x):
    """The reference's float32 sin (XLA's), for float32 arguments."""
    if x.dtype == torch.float32:
        return torch.from_numpy(np.array(jnp.sin(jnp.asarray(x.numpy()))))
    return _torch_sin(x)


_torch_sin = torch.sin


@pytest.fixture(scope="module", params=[(0, False), (2, False), (0, True)],
                ids=["pcut0", "pcut2", "reflect"])
def horizon(request):
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    i_pcut, reflect = request.param
    state, tal, grids, sc, ss = _build(i_pcut, reflect=reflect)
    assert ss.hist_band == 0 and ss.n_xspec == 2
    s, t = state, tal
    for _ in range(H):
        s, t = _helix_jit(s, t, grids, sc, ss)
    t = stp._flush_records(t, ss)
    out = {"ref": (_np(s), _np(t))}
    st, tl, tb = _port(state, tal, grids, sc, ss)
    _steps(st, tl, tb, H)
    out["port"] = (st.to_numpy(), tl.to_numpy())
    st, tl, tb = _port(state, tal, grids, sc, ss)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "cos", _xla_cos)
        _steps(st, tl, tb, H)
    out["xla_cos"] = (st.to_numpy(), tl.to_numpy())
    if request.param[1]:
        # the case is not vacuous: with every injection test passed
        # (inj_frac = 1) some lanes end elsewhere
        st, tl, tb = _port(state, tal, grids,
                           sc._replace(inj_frac=jnp.asarray(1.0)), ss)
        assert not tb.reflect
        _steps(st, tl, tb, H)
        n_refl = int((st.to_numpy()["x"] != out["port"][0]["x"]).sum())
        assert n_refl > 10, n_refl
    torch.set_num_threads(n_thr)
    return out


def _same_lanes(ref, got):
    same = np.ones(LANES, bool)
    for f in INT_FIELDS:
        same &= ref[f] == got[f]
    return same


@pytest.mark.parametrize("variant", ["port", "xla_cos"])
@pytest.mark.parametrize("field", INT_FIELDS)
def test_integer_fields_per_lane(horizon, variant, field):
    ref, got = horizon["ref"][0], horizon[variant][0]
    n_div = int((ref[field] != got[field]).sum())
    assert n_div <= 1e-3 * LANES, f"{field}: {n_div} lanes differ"


def test_lanes_moved(horizon):
    ref, got = horizon["ref"][0], horizon["port"][0]
    assert int(got["nsteps"].sum()) > LANES * H // 2
    assert (ref["status"] == 0).sum() > LANES // 2   # still mostly ACTIVE
    np.testing.assert_array_equal(got["key"], ref["key"])
    np.testing.assert_array_equal(got["weight"], ref["weight"])


def _float_err(ref, got, field):
    same = _same_lanes(ref, got)
    a = ref[field][same].astype(np.float64)
    b = got[field][same].astype(np.float64)
    if field in ("pb", "pperp"):
        scale = np.hypot(ref["pb"], ref["pperp"])[same]
    else:
        scale = np.abs(a)
    return np.abs(b - a), scale


@pytest.mark.parametrize("variant,tol", [("xla_cos", 1e-12),
                                         ("port", 1e-4)])
@pytest.mark.parametrize("field", FLOAT_FIELDS)
def test_float_fields_per_lane(horizon, variant, tol, field):
    diff, scale = _float_err(horizon["ref"][0], horizon[variant][0], field)
    np.testing.assert_array_less(diff, tol * scale + 1e-300)


@pytest.mark.parametrize("field", TALLIES)
def test_tallies_strict(horizon, field):
    """With XLA's cos: float64 tallies to 1e-6 of their largest entry,
    the float32 PSD difference array to 1e-5."""
    ref, got = horizon["ref"][1], horizon["xla_cos"][1]
    a = np.asarray(ref[field], np.float64)
    b = np.asarray(got[field], np.float64)
    assert a.shape == b.shape
    if field in ("flux_diff", "psd_diff", "spectra_sf", "spectra_pf"):
        assert np.abs(a).max() > 0, field
    tol = 1e-5 if field == "psd_diff" else 1e-6
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(b - a).max() <= tol * scale, (field, np.abs(b - a).max(),
                                                scale)


@pytest.mark.parametrize("field", TALLIES)
def test_tallies(horizon, field):
    """The port as it is: a record of a lane that drifted by ~1e-6 can
    land in the neighbouring bin.  Totals agree to 1e-4, and at most
    0.1% of the nonzero entries differ by more than 1e-4 of the largest
    entry."""
    ref, got = horizon["ref"][1], horizon["port"][1]
    a = np.asarray(ref[field], np.float64)
    b = np.asarray(got[field], np.float64)
    scale = max(np.abs(a).max(), 1e-300)
    assert abs(b.sum() - a.sum()) <= 1e-4 * max(np.abs(a).sum(), 1e-300)
    off = np.abs(b - a) > 1e-4 * scale
    assert off.sum() <= max(1e-3 * np.count_nonzero(a), 1), (field, off.sum())


def test_psd_deposits_take_the_wrapper():
    """The step deposits through hist.psd_scatter, once a step."""
    state, tal, grids, sc, ss = _build(0, lanes=256)
    st, tl, tb = _port(state, tal, grids, sc, ss)
    before = hist.PLAIN_CALLS
    _steps(st, tl, tb, 3)
    assert hist.PLAIN_CALLS == before + 3


def _clone(obj):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).clone()
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def test_drain_independent_of_sync_interval():
    """run_segment with the host check every step and every 64 steps:
    identical state and tallies (the extra steps are exact no-ops)."""
    state, tal, grids, sc, ss = _build(2, lanes=256)
    st0, tl0, tb = _port(state, tal, grids, sc, ss)
    out = []
    for every in (1, 64):
        st, tl = _clone(st0), _clone(tl0)
        taken = tstep.run_segment(st, tl, tb, sync_every=every,
                                  max_helix=200)
        assert not (st.status == 0).any()
        out.append((st, tl, taken))
    (s1, t1, n1), (s64, t64, n64) = out
    assert n1 <= 200 <= n64
    for f in dataclasses.fields(s1):
        assert torch.equal(getattr(s1, f.name), getattr(s64, f.name)), f.name
    for name in ("flux_diff", "psd_diff", "esc", "spectra_sf", "spectra_pf"):
        assert torch.equal(getattr(t1, name), getattr(t64, name)), name


@pytest.mark.parametrize("flag,value", [
    ("do_rad_losses", True), ("do_retro", True), ("do_tcuts", True),
    ("do_energy_transfer", True), ("use_custom_eps_b", True),
    ("dont_scatter", True), ("dont_dsa", True), ("frg_rg0_cm", 1.0e10),
    ("parallel", False)])
def test_gate_raises_on_deferred_flags(flag, value):
    """The engine refuses no static flag any more, nor (since the
    oblique step was ported) an oblique field.  With each flag on (the
    custom f(r_g) law at alpha = 1.5; parallel False: the oblique
    branches at theta_B = 0), two steps of 128 flagship lanes agree with
    the JAX ``helix_step`` per lane (XLA's float32 cos, and for the
    oblique phase adjustment its sin, substituted: integer fields
    exactly, float fields to 1e-12)."""
    state, tal, grids, sc, ss = _build(0, lanes=128)
    ss = dataclasses.replace(ss, **{flag: value})
    if flag == "frg_rg0_cm":
        ss = dataclasses.replace(ss, frg_alpha=1.5)
    s, t = state, tal
    for _ in range(2):
        s, t = _helix_jit(s, t, grids, sc, ss)
    st, tl, tb = _port(state, tal, grids, sc, ss)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "cos", _xla_cos)
        mp.setattr(torch, "sin", _xla_sin)
        _steps(st, tl, tb, 2)
    ref, got = _np(s), st.to_numpy()
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    p_ref = np.hypot(ref["pb"], ref["pperp"])
    for f in FLOAT_FIELDS:
        scale = p_ref if f in ("pb", "pperp") else np.abs(ref[f])
        np.testing.assert_array_less(np.abs(got[f] - ref[f]),
                                     1e-12 * scale + 1e-300, err_msg=f)
    assert int(got["nsteps"].sum()) == 2 * 128
