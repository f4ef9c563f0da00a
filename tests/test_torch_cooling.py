"""The electron cooling track: one electron's momentum under radiative
losses against the analytic curve, on four paths, on the CPU.

The loss step (JAX package: ops/step.py:309, ops/pallas_step.py:409-427;
particle_loop.jl:301-334) is p -> p / (1 + d) when d > 1e-2, else
p (1 - d), with d = RAD_LOSS_FAC B_eff^2 p dt, B_eff^2 = B^2 +
(b_cmbz gamma_ef)^2 and dt the lane's step (its t_step before the step).
So 1/p_n = 1/p_0 + RAD_LOSS_FAC B_eff^2 t_n, t_n the summed steps,
exactly in the division branch, and in the first-order branch with an
excess of d_k^2 / (1 - d_k) in 1/p a step: p(1 - d) cools by d^2 more
than p / (1 + d).  Scattering stays on (it turns p in the plasma frame,
its length stays); nothing else changes |p| while the lane stays in its
zone, which it must (the frame is then fixed).

Set-up: configs/baseline.toml with electron density 1
(tests/torch_flag_cases.py), the electrons' segment at the last pcut
(above every lane), radiative losses the only static flag.  Each lane
is one electron in the downstream zone at 1.78 r_g0 (0.275 r_g0 = 4.2e11
cm wide), moving with mu = 0.5.  The grid's field is set to 1 G: at the
baseline's 4.3e-4 G an electron loses more than a float32 ulp in a step
only at gamma > 5e6, whose gyroradius (~1e4 r_g0 at 1e8) spans the
whole grid; at 1 G the two regimes lie inside one zone.  Two starting
gammas, one lane each:
* 3e6: d ~ 4e-5 a step, ~350 float32 ulps of p: float32 must cool;
* 1e4: d ~ 5e-10 a step, below half a float32 ulp: float32 stalls if
  the lead in ROADMAP.md is right.

Paths and what is held (N = 320 steps):
* float64: the port's XLA engine (ops/step.py helix_step, with XLA's
  float32 cos of the scattering phase substituted, as in
  test_torch_step.py) and the JAX helix_step, step by step: both follow
  the curve to within their summed second-order excess (times 1.01, plus
  1e-13), always on or below it, and agree with each other to 1e-12 of
  p at every step;
* float32: K1's twin (ops/mega.py) and the JAX megakernel in interpret
  mode, in chunks of C = 40 steps (the helix cap of one launch; each
  chunk restarts the lane's step count, so one trace of the megakernel
  serves them all and the twin takes the same uniforms).  At 3e6 the
  twin follows the curve to 4 ulps of p a step (its roundings), the
  megakernel the same, and they agree at each chunk's end to 32 ulps of
  p (measured: up to 14; the reference's arccos series and field
  gathers round otherwise).  At 1e4 neither cools: 1 - d rounds to 1,
  so the loss is a no-op in the reference's arithmetic and the twin's
  lane is bit for bit the lane without losses; |p| moves only by the
  roundings of the scattering rotations.  The port does as the reference
  does: the lead in ROADMAP.md is confirmed.
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
from montecarloscattering_jl_tpu_torch.ops import mega, rng
from montecarloscattering_jl_tpu_torch.ops import state as tst
from montecarloscattering_jl_tpu_torch.ops import step as tstep
from montecarloscattering_jl_tpu_torch.utils import constants as K

import torch_flag_cases as fc

N = 320
C = 40
ZONE = 87
GAMMAS = (3.0e6, 1.0e4)
B_ZONE = 1.0                 # G
ULP32 = 2.0 ** -23

_np = fc.np_tree


def _xla_cos(x):
    """The reference's float32 cos (XLA's), for float32 arguments."""
    if x.dtype == torch.float32:
        return torch.from_numpy(np.array(jnp.cos(jnp.asarray(x.numpy()))))
    return _torch_cos(x)


_torch_cos = torch.cos


def _build(tmp, p_dtype):
    """(grids, sc, ss, state, b_eff2, n_tcut_slots) of the JAX package:
    the electrons' segment with the grid's field at B_ZONE, one lane per
    GAMMAS."""
    cfg, setup, eng, grids = fc.build(tmp, p_dtype)
    grids = grids._replace(btot=jnp.full_like(grids.btot, B_ZONE))
    ss = fc.static(eng, 1, "do_rad_losses")
    sc = eng.segment_scalars(1, len(cfg.pcuts) - 1, setup.profile.bmag2)
    xg = setup.x_grid_cm
    x = np.full(len(GAMMAS), xg[ZONE] + 0.05 * (xg[ZONE + 1] - xg[ZONE]))
    mc = K.ME_CGS * K.C_CGS
    g = np.asarray(GAMMAS)
    ptot = mc * np.sqrt(g * g - 1.0)
    ig = np.full(len(g), ZONE, np.int32)
    state = jst.init_state(
        np.ones(len(g)), ptot, 0.5 * ptot, x, ig, setup.profile.ux_sk[ig],
        cfg.xn_per_fine, setup.x_grid_stop, jax.random.key(11),
        downstream=np.ones(len(g), bool), inj=np.zeros(len(g), bool),
        acctime=np.zeros(len(g)), tcut=np.zeros(len(g), np.int32),
        p_dtype=p_dtype)
    t_step = 2.0 * np.pi * g * mc / (K.QE_CGS * B_ZONE) / cfg.xn_per_coarse
    state = state._replace(t_step=jnp.asarray(t_step, p_dtype))
    gef = float(np.asarray(grids.gamma_ef)[ZONE])
    b_eff2 = B_ZONE ** 2 + (float(sc.b_cmbz) * gef) ** 2
    return grids, sc, ss, state, b_eff2, eng.n_tcut_slots


def _record(rows, p, t_step, igrid, status):
    rows.append((np.hypot(*p), np.asarray(t_step, np.float64).copy(),
                 np.asarray(igrid).copy(), np.asarray(status).copy()))


def _curve(p0, t_before, b_eff2):
    """1/p on the analytic curve after each step: t_before[k] is the
    lane's t_step before step k (what step k's loss uses)."""
    t = np.concatenate([np.zeros((1, p0.size)), np.cumsum(t_before, 0)])
    return 1.0 / p0 + K.RAD_LOSS_FAC * b_eff2 * t


def _stack(rows):
    p, t, ig, status = (np.stack([r[i] for r in rows]) for i in range(4))
    return p.astype(np.float64), t[:-1], ig, status


@pytest.fixture(scope="module")
def f64_tracks(tmp_path_factory):
    grids, sc, ss, state, b_eff2, n_tc = _build(
        tmp_path_factory.mktemp("cool64"), jnp.float64)
    tal = jst.make_tallies(ss.nb, ss.n_mom, ss.n_theta, 0, n_tc, jnp.float32,
                           batch=len(GAMMAS), chunk=1, p_dtype=jnp.float64)

    def step(carry, _):
        s, t = stp.helix_step(*carry, grids, sc, ss)
        return (s, t), (s.pb, s.pperp, s.t_step, s.igrid, s.status)

    # the JAX helix_step, N steps in one scan, each step's lane kept
    ys = [np.asarray(y) for y in jax.jit(lambda c: jax.lax.scan(
        step, c, None, length=N)[1])((state, tal))]
    ref = []
    _record(ref, (np.asarray(state.pb), np.asarray(state.pperp)),
            state.t_step, state.igrid, state.status)
    for k in range(N):
        _record(ref, (ys[0][k], ys[1][k]), ys[2][k], ys[3][k], ys[4][k])
    st = tst.ParticleState.from_jax_numpy(_np(state))
    tl = tst.Tallies.from_jax_numpy(_np(tal))
    tb = tstep.step_tables(
        tst.SegmentGrids.from_jax_numpy(_np(grids), "cpu", torch.float64),
        tst.SegmentScalars.from_jax_numpy(_np(sc)),
        tst.StepStatic.from_jax(ss), "cpu")
    got = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "cos", _xla_cos)
        _record(got, (st.pb.numpy(), st.pperp.numpy()), st.t_step,
                st.igrid, st.status)
        for _ in range(N):
            tstep.helix_step(st, tl, tb, rng.lane_uniforms_xla(
                st.key0, st.key1, st.nsteps), 10_000)
            _record(got, (st.pb.numpy(), st.pperp.numpy()), st.t_step,
                    st.igrid, st.status)
    return dict(jax=_stack(ref), port=_stack(got), b_eff2=b_eff2)


def _restart(s):
    """The lane again ACTIVE at step 0 (the next chunk)."""
    return s._replace(status=jnp.zeros_like(s.status),
                      reason=jnp.zeros_like(s.reason),
                      nsteps=jnp.zeros_like(s.nsteps))


@pytest.fixture(scope="module")
def f32_tracks(tmp_path_factory):
    grids, sc, ss, state, b_eff2, n_tc = _build(
        tmp_path_factory.mktemp("cool32"), jnp.float32)
    tal = jst.make_tallies(ss.nb, ss.n_mom, ss.n_theta, 0, n_tc, jnp.float32,
                           batch=len(GAMMAS), chunk=8, p_dtype=jnp.float32)
    # the megakernel, chunk by chunk
    ends, s = [], state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, "MAX_HELIX_STEPS", C)
        mp.setattr(ps, "_LAUNCH_CACHE", {})
        mp.setattr(ps, "check_oob", lambda *a, **k: None)
        for _ in range(N // C):
            s, _t = ps.run_segment_mega(_restart(s), tal, grids, sc, ss,
                                        steps_per_launch=C, interpret=True)
            ends.append((np.hypot(np.asarray(s.pb, np.float64),
                                  np.asarray(s.pperp, np.float64)),
                         np.asarray(s.nsteps)))
    # the twin, step by step, the same chunks; and with the losses off
    twin = {}
    for name, s_s in (("twin", ss), ("twin_off", dataclasses.replace(
            ss, do_rad_losses=False))):
        tb = mega.mega_tables(tst.SegmentGrids.from_jax_numpy(_np(grids)),
                              tst.SegmentScalars.from_jax_numpy(_np(sc)),
                              tst.StepStatic.from_jax(s_s), "cpu")
        st = tst.ParticleState.from_jax_numpy(_np(state))
        tl = tst.Tallies.from_jax_numpy(_np(tal))
        rows = []
        _record(rows, (st.pb.double().numpy(), st.pperp.double().numpy()),
                st.t_step, st.igrid, st.status)
        for k in range(N):
            if k % C == 0:
                st.status.zero_()
                st.reason.zero_()
                st.nsteps.zero_()
            mega.launch(st, tb, tl, n_steps=1, max_helix=C)
            _record(rows, (st.pb.double().numpy(),
                           st.pperp.double().numpy()),
                    st.t_step, st.igrid, st.status)
        twin[name] = _stack(rows)
    return dict(twin, mega=ends, b_eff2=b_eff2)


def _loss_per_step(p, t, b_eff2):
    return K.RAD_LOSS_FAC * b_eff2 * p[:-1] * t


@pytest.mark.parametrize("path", ["port", "jax"])
def test_f64_follows_the_curve(f64_tracks, path):
    p, t, ig, status = f64_tracks[path]
    b_eff2 = f64_tracks["b_eff2"]
    assert (ig == ZONE).all() and (status == tst.ACTIVE).all()
    d = _loss_per_step(p, t, b_eff2)
    assert d[0, 0] > 100 * ULP32 and d[0, 1] < ULP32 / 4
    inv = _curve(p[0], t, b_eff2)
    excess = np.concatenate([np.zeros((1, p.shape[1])),
                             np.cumsum(d * d / (1.0 - d), 0)])
    dev = p * inv - 1.0              # p over the curve's p, less 1
    assert (dev <= 1e-13).all()       # on or below the curve
    assert (dev >= -1.01 * excess - 1e-13).all()
    # both lanes cooled, the fast one by about N d
    assert 0.01 < 1.0 - p[-1, 0] / p[0, 0] < 0.03
    assert 0.0 < 1.0 - p[-1, 1] / p[0, 1] < 1e-6


def test_f64_port_matches_jax_per_step(f64_tracks):
    a, b = f64_tracks["jax"][0], f64_tracks["port"][0]
    np.testing.assert_array_less(np.abs(b - a), 1e-12 * a)
    np.testing.assert_array_equal(f64_tracks["jax"][2], f64_tracks["port"][2])


def test_f32_cools_at_high_gamma(f32_tracks):
    p, t, ig, status = f32_tracks["twin"]
    assert (ig == ZONE).all()
    b_eff2 = f32_tracks["b_eff2"]
    inv = _curve(p[0], t, b_eff2)
    n = np.arange(N + 1)
    # the twin's roundings: at most 4 ulps of p a step off the curve
    assert (np.abs(p[:, 0] * inv[:, 0] - 1.0) <= 4 * ULP32 * n).all()
    assert 0.01 < 1.0 - p[-1, 0] / p[0, 0] < 0.03
    for k, (pm, nsteps) in enumerate(f32_tracks["mega"]):
        assert (nsteps == C).all()
        j = (k + 1) * C
        assert abs(pm[0] * inv[j, 0] - 1.0) <= 4 * ULP32 * j
        assert abs(pm[0] - p[j, 0]) <= 32 * ULP32 * p[j, 0]


def test_f32_stalls_at_low_gamma_as_the_reference(f32_tracks):
    """A loss below a quarter of a float32 ulp a step rounds away: 1 - d
    is 1 in float32, so the reference's loss factor is exactly 1 and the
    twin's lane is bit for bit the lane with the losses off, while the
    fast lane differs.  |p| moves only by the roundings of the
    scattering rotations, on both sides alike (32 ulps)."""
    p, t, _, _ = f32_tracks["twin"]
    off = f32_tracks["twin_off"][0]
    b_eff2 = f32_tracks["b_eff2"]
    d = _loss_per_step(p, t, b_eff2)
    assert (d[:, 1] < ULP32 / 4).all()
    # the reference's loss arithmetic (pallas_step.py:413-420) in float32
    f32 = jnp.float32
    ptot = jnp.asarray(p[:-1, 1], f32)
    dlnp = (f32(K.RAD_LOSS_FAC) * f32(b_eff2) * ptot
            * jnp.asarray(t[:, 1], f32))
    scale = jnp.where(dlnp > 1e-2, ptot / (1.0 + dlnp),
                      ptot * (1.0 - dlnp)) / jnp.maximum(ptot, f32(1e-30))
    assert bool((scale == 1.0).all())
    np.testing.assert_array_equal(p[:, 1], off[:, 1])
    assert not np.array_equal(p[:, 0], off[:, 0])
    for k, (pm, _) in enumerate(f32_tracks["mega"]):
        j = (k + 1) * C
        assert abs(pm[1] - p[j, 1]) <= 32 * ULP32 * p[j, 1]
