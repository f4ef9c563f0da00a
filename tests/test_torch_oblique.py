"""The XLA engine's oblique step (``StepStatic.parallel`` False:
montecarloscattering_jl_tpu_torch/ops/step.py, transforms.py
``transform_p_psp``, scattering.py's phase adjustment) on the CPU at
float64.

The config layer refuses oblique shocks as the reference does
(check_shock_angle), so these branches are reached from code only.
tests/test_oblique.py's two checks, on the port (the flagship population
of __graft_entry__._build, 256 lanes, 50 steps):

1. at theta_B = 0 the oblique branches give the parallel ones' lanes:
   integer fields equal, float fields to 1e-12 relative (momenta
   relative to |p|) -- the gyro phase excepted, which the oblique step
   adjusts at every scattering and which at theta_B = 0 reaches only
   the pxz tally; fluxes to the JAX test's tolerances;
2. at theta_B = 30 degrees in a uniform flow no frame change fires, and
   each lane's plasma-frame |p| is conserved to 1e-12.

Against the JAX package's oblique ``helix_step`` at theta_B = 30 degrees,
50 steps, with the reference's float32 cosine and sine of the scattering
phase substituted (XLA's polynomials, as tests/test_torch_step.py
substitutes the cosine): in the uniform flow, on the flagship's shock
profile (frame re-transforms at every zone crossing), and on the flag
population of configs/baseline.toml (tests/torch_flag_cases.py) with the
retro walk on, and with the retro walk, custom eps_B, tcuts, energy
transfer and radiative losses on (protons and electrons).  Integer fields equal on every lane, float fields
to 1e-12 relative (the phase to 1e-12 of 2 pi, a position to 1e-12 of
the larger of |x| and the lane's path), the float64 flux tallies
to 1e-9 of their largest entry and the float32 PSD to 1e-5.

K1 keeps refusing oblique fields, as ``megakernel_supported`` does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as ge
from montecarloscattering_jl_tpu.ops import state as jst
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu_torch.ops import mega, rng
from montecarloscattering_jl_tpu_torch.ops import state as tst
from montecarloscattering_jl_tpu_torch.ops import step as tstep

import torch_flag_cases as fc

BATCH = 256
N_STEPS = 50
THETA = np.pi / 6
INT_FIELDS = ("status", "reason", "nsteps", "igrid", "downstream", "inj",
              "retro", "just_returned", "tcut")
FLOAT_FIELDS = ("pb", "pperp", "x", "prp_x", "acctime", "ux_prev",
                "xn_per", "t_step")
# every flag of the step that scatters: the retro walk, custom eps_B,
# tcuts, energy transfer and radiative losses
SCIENCE = ("do_retro", "use_custom_eps_b", "do_tcuts", "do_energy_transfer",
           "do_rad_losses")
_np = fc.np_tree
_torch_cos, _torch_sin = torch.cos, torch.sin


def _xla(fn, torch_fn):
    def f(x):
        if x.dtype == torch.float32:
            return torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))
        return torch_fn(x)
    return f


def _port(state, tal, grids, sc, ss, n=N_STEPS, xla_trig=True):
    st = tst.ParticleState.from_jax_numpy(_np(state))
    tl = tst.Tallies.from_jax_numpy(_np(tal))
    tb = tstep.step_tables(
        tst.SegmentGrids.from_jax_numpy(_np(grids), "cpu", torch.float64),
        tst.SegmentScalars.from_jax_numpy(_np(sc)),
        tst.StepStatic.from_jax(ss), "cpu")
    with pytest.MonkeyPatch.context() as mp:
        if xla_trig:
            mp.setattr(torch, "cos", _xla(jnp.cos, _torch_cos))
            mp.setattr(torch, "sin", _xla(jnp.sin, _torch_sin))
        for _ in range(n):
            u = rng.lane_uniforms_xla(st.key0, st.key1, st.nsteps)
            tstep.helix_step(st, tl, tb, u, 10_000)
    return st.to_numpy(), dict(tl.to_numpy(), counts=tl.counts.numpy())


def _jax(state, tal, grids, sc, ss, n=N_STEPS):
    def body(i, c):
        return stp.helix_step(c[0], c[1], grids, sc, ss)
    s, t = jax.jit(lambda s, t: jax.lax.fori_loop(0, n, body, (s, t)))(
        state, tal)
    return _np(s), _np(stp._flush_records(t, ss))


def _oblique(grids, uniform=False):
    """`grids` with the field at THETA everywhere (and, with `uniform`,
    the flow of zone 1 everywhere)."""
    nb = len(np.asarray(grids.ux))
    full = lambda v, a: jnp.full(nb, v, a.dtype)
    out = grids._replace(b_cos=full(np.cos(THETA), grids.b_cos),
                         b_sin=full(np.sin(THETA), grids.b_sin))
    if uniform:
        u0 = float(np.asarray(grids.ux)[1])
        out = out._replace(
            ux=full(u0, grids.ux), uz=full(0.0, grids.uz),
            utot=full(abs(u0), grids.utot),
            gamma_sf=full(float(np.asarray(grids.gamma_sf)[1]),
                          grids.gamma_sf))
    return out


def _lane_errors(ref, got, x0):
    """(lanes whose integer fields differ, the largest relative float
    error per field, the largest phase error over 2 pi).  A position is
    held relative to the larger of |x| and the lane's path from `x0`: a
    lane that ends near the shock has |x| far below the gyro excursions
    that brought it there."""
    same = np.ones(len(ref["pb"]), bool)
    for f in INT_FIELDS:
        same &= ref[f] == got[f]
    p = np.hypot(ref["pb"], ref["pperp"])
    err = {}
    for f in FLOAT_FIELDS:
        scale = p if f in ("pb", "pperp") else np.abs(ref[f])
        if f == "x":
            scale = np.maximum(scale, np.abs(ref[f] - x0))
        err[f] = float((np.abs(got[f] - ref[f])
                        / np.maximum(scale, 1e-300))[same].max())
    d = np.abs(got["phi"] - ref["phi"])[same]
    phase = float(np.minimum(d, 2.0 * np.pi - d).max() / (2.0 * np.pi))
    return int((~same).sum()), err, phase


@pytest.fixture(scope="module")
def graft():
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    yield ge._build(batch=BATCH)
    torch.set_num_threads(n_thr)


def test_theta_zero_reduces_to_parallel(graft):
    _, state, tal, grids, sc, ss = graft
    par, t_par = _port(state, tal, grids, sc, ss, xla_trig=False)
    obl, t_obl = _port(state, tal, grids, sc,
                       dataclasses.replace(ss, parallel=False),
                       xla_trig=False)
    n_div, err, _ = _lane_errors(par, obl, np.asarray(state.x))
    assert n_div == 0
    assert max(err.values()) <= 1e-12, err
    assert (obl["phi"] != par["phi"]).any()     # the phase adjustment ran
    # the fluxes, as tests/test_oblique.py holds them: pxz is the phase
    # adjustment's only observable
    for ch, rtol in ((0, 1e-6), (2, 1e-6)):
        a = np.cumsum(t_par["flux_diff"][ch])
        b = np.cumsum(t_obl["flux_diff"][ch])
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=1e-9 * np.abs(a).max())
    a = np.asarray(t_par["psd_diff"], np.float64)
    b = np.asarray(t_obl["psd_diff"], np.float64)
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7 * np.abs(a).max())


def test_uniform_flow_conserves_momentum(graft):
    _, state, tal, grids, sc, ss = graft
    ss_obl = dataclasses.replace(ss, parallel=False, do_rad_losses=False)
    u0 = float(np.asarray(grids.ux)[1])
    state_u = state._replace(ux_prev=jnp.full(BATCH, u0,
                                              state.ux_prev.dtype))
    got, _ = _port(state_u, tal, _oblique(grids, uniform=True), sc, ss_obl,
                   xla_trig=False)
    alive = got["status"] == tst.ACTIVE
    assert alive.sum() > 0
    p0 = np.hypot(np.asarray(state_u.pb), np.asarray(state_u.pperp))
    p1 = np.hypot(got["pb"], got["pperp"])
    np.testing.assert_allclose(p1[alive], p0[alive], rtol=1e-12)
    assert np.any(got["x"][alive] != np.asarray(state_u.x)[alive])
    assert np.any(got["phi"][alive] != np.asarray(state_u.phi)[alive])


@pytest.fixture(scope="module")
def flag_setup(tmp_path_factory):
    return fc.build(tmp_path_factory.mktemp("oblique"), jnp.float64)


def _flag_case(flag_setup, kind, flags):
    cfg, setup, eng, grids = flag_setup
    i_ion = 0 if kind == "ion" else 1
    ss = dataclasses.replace(eng.step_static(i_ion), parallel=False,
                             **{f: f in flags for f in fc.FLAGS})
    sc = eng.segment_scalars(i_ion, fc.I_PCUT, setup.profile.bmag2)
    state = fc.population(cfg, setup, i_ion, jnp.float64)
    b = setup.bins
    tal = jst.make_tallies(setup.nb, b.n_mom, b.n_theta, 0,
                           eng.n_tcut_slots, jnp.float32, batch=fc.LANES,
                           chunk=8, p_dtype=jnp.float64)
    return state, tal, _oblique(grids), sc, ss


@pytest.mark.parametrize("case", ["uniform", "profile", "retro-ion",
                                  "science-ion", "science-electron"])
def test_oblique_step_matches_jax(graft, flag_setup, case):
    if "-" in case:
        name, kind = case.split("-")
        flags = ("do_retro",) if name == "retro" else SCIENCE
        state, tal, grids, sc, ss = _flag_case(flag_setup, kind, flags)
    else:
        _, state, tal, grids, sc, ss = graft
        ss = dataclasses.replace(ss, parallel=False, do_rad_losses=False)
        if case == "uniform":
            u0 = float(np.asarray(grids.ux)[1])
            state = state._replace(ux_prev=jnp.full(
                BATCH, u0, state.ux_prev.dtype))
        grids = _oblique(grids, uniform=case == "uniform")
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    ref, t_ref = _jax(state, tal, grids, sc, ss)
    got, t_got = _port(state, tal, grids, sc, ss)
    torch.set_num_threads(n_thr)
    n_div, err, phase = _lane_errors(ref, got, np.asarray(state.x))
    assert n_div == 0
    assert max(err.values()) <= 1e-12, err
    assert phase <= 1e-12, phase
    for name in ("flux_diff", "psd_diff", "pool_diff", "weight_coupled",
                 "px_esc_up", "en_esc_up", "sum_p_dw", "sum_ke_dw"):
        a = np.asarray(t_ref[name], np.float64)
        b = np.asarray(t_got[name], np.float64)
        tol = 1e-5 if name == "psd_diff" else 1e-9
        assert np.abs(b - a).max() <= tol * max(np.abs(a).max(), 1e-300), \
            name
    assert np.abs(t_got["flux_diff"]).max() > 0
    if case == "retro-ion":
        # the retro walk ran in the oblique field
        assert t_got["counts"][tst.C_RETRO] > 0


def test_k1_refuses_oblique_fields(graft):
    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.utils import load_config

    ss = tst.StepStatic.from_jax(graft[5])
    mega.check_supported(ss)
    with pytest.raises(NotImplementedError):
        mega.check_supported(dataclasses.replace(ss, parallel=False))
    eng = TransportEngine(build_setup(load_config(
        "tests/data/dsa_nonrel.toml")), device="cpu", p_dtype=torch.float32)
    assert eng.uses_k1(ss)
    assert not eng.uses_k1(dataclasses.replace(ss, parallel=False))
