"""The XLA engine's static-flag branches (ops/step.py) against the JAX
package's ``helix_step`` at float64, on the CPU.

configs/baseline.toml (the gamma0 = 5 parallel shock, protons and
electrons) with the electrons' density set to 1, so that they carry the
received energy.  Each case turns on one static flag of ``StepStatic``
-- or all of them, or the custom f(r_g) law (alpha = 1.5, and alpha = 1,
the standard law) -- and runs 32 steps of 512 lanes of a population made
to reach every branch (tests/torch_flag_cases.py).  Both packages draw
the same uniforms, so lanes follow the same trajectories; the port runs
with the reference's float32 cos substituted (XLA's polynomial, as
tests/test_torch_step.py does).

Tolerances: integer fields differ on at most 0.1% of lanes; float fields
to 1e-12 relative (momenta relative to the lane's |p|); the float64
tallies -- flux channels, escape sums, the ions' pool, the tcut weights
and spectra -- to 1e-9 of their largest entry, the float32 PSD to 1e-5
of its largest entry (the same records summed in another order).  Each
case also checks that its branch fired.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarloscattering_jl_tpu.ops import state as jst
from montecarloscattering_jl_tpu.ops import step as stp
from montecarloscattering_jl_tpu_torch.ops import rng
from montecarloscattering_jl_tpu_torch.ops import state as tst
from montecarloscattering_jl_tpu_torch.ops import step as tstep

import torch_flag_cases as fc

LANES = fc.LANES
H = 32
INT_FIELDS = ("status", "reason", "nsteps", "igrid", "downstream", "inj",
              "retro", "just_returned", "tcut")
FLOAT_FIELDS = ("pb", "pperp", "phi", "x", "prp_x", "acctime", "ux_prev",
                "xn_per", "t_step")
TALLIES = ("flux_diff", "psd_diff", "pool_diff", "weight_coupled",
           "spectra_coupled", "px_esc_up", "en_esc_up", "sum_p_dw",
           "sum_ke_dw")

_helix_jit = jax.jit(stp.helix_step, static_argnums=(4,))
_np = fc.np_tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return fc.build(tmp_path_factory.mktemp("flags"), jnp.float64)


def _tallies(setup, eng):
    b = setup.bins
    return jst.make_tallies(setup.nb, b.n_mom, b.n_theta, 0,
                            eng.n_tcut_slots, jnp.float32, batch=LANES,
                            chunk=8, p_dtype=jnp.float64)


def _xla_cos(x):
    """The reference's float32 cos (XLA's), for float32 arguments."""
    if x.dtype == torch.float32:
        return torch.from_numpy(np.array(jnp.cos(jnp.asarray(x.numpy()))))
    return _torch_cos(x)


_torch_cos = torch.cos


def _run_port(state, tal, grids, sc, ss, n=H):
    st = tst.ParticleState.from_jax_numpy(_np(state))
    tl = tst.Tallies.from_jax_numpy(_np(tal))
    tb = tstep.step_tables(
        tst.SegmentGrids.from_jax_numpy(_np(grids), "cpu", torch.float64),
        tst.SegmentScalars.from_jax_numpy(_np(sc)),
        tst.StepStatic.from_jax(ss), "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "cos", _xla_cos)
        for _ in range(n):
            u = rng.lane_uniforms_xla(st.key0, st.key1, st.nsteps)
            tstep.helix_step(st, tl, tb, u, 10_000)
    return st, tl


@pytest.fixture(scope="module", params=fc.CASES, ids=fc.IDS)
def case(request, setup):
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    flag, kind = request.param
    cfg, stp_setup, eng, grids = setup
    i_ion = 0 if kind == "ion" else 1
    ss = fc.static(eng, i_ion, flag)
    sc = eng.segment_scalars(i_ion, fc.I_PCUT, stp_setup.profile.bmag2)
    state = fc.population(cfg, stp_setup, i_ion, jnp.float64)
    tal = _tallies(stp_setup, eng)
    s, t = state, tal
    for _ in range(H):
        s, t = _helix_jit(s, t, grids, sc, ss)
    t = stp._flush_records(t, ss)
    st, tl = _run_port(state, tal, grids, sc, ss)
    # the same lanes with the flag off: the branch must change something
    off = fc.static(eng, i_ion, "none")
    st_off, tl_off = _run_port(state, tal, grids, sc, off)
    torch.set_num_threads(n_thr)
    p0 = np.hypot(np.asarray(state.pb), np.asarray(state.pperp))
    return dict(ref=(_np(s), _np(t)), port=(st.to_numpy(), tl.to_numpy()),
                off=(st_off.to_numpy(), tl_off.to_numpy()),
                counts=tl.counts.numpy(), flag=flag, kind=kind,
                below_pe_crit=p0 < float(sc.pe_crit))


@pytest.mark.parametrize("field", INT_FIELDS)
def test_integer_fields_per_lane(case, field):
    ref, got = case["ref"][0], case["port"][0]
    n_div = int((ref[field] != got[field]).sum())
    assert n_div <= 1e-3 * LANES, f"{field}: {n_div} lanes differ"


def _same(ref, got):
    same = np.ones(LANES, bool)
    for f in INT_FIELDS:
        same &= ref[f] == got[f]
    return same


@pytest.mark.parametrize("field", FLOAT_FIELDS)
def test_float_fields_per_lane(case, field):
    ref, got = case["ref"][0], case["port"][0]
    same = _same(ref, got)
    a = ref[field][same].astype(np.float64)
    b = got[field][same].astype(np.float64)
    if field in ("pb", "pperp"):
        scale = np.hypot(ref["pb"], ref["pperp"])[same]
    else:
        scale = np.abs(a)
    np.testing.assert_array_less(np.abs(b - a), 1e-12 * scale + 1e-300)


@pytest.mark.parametrize("field", TALLIES)
def test_tallies(case, field):
    ref, got = case["ref"][1], case["port"][1]
    a = np.asarray(ref[field], np.float64)
    b = np.asarray(got[field], np.float64)
    assert a.shape == b.shape
    tol = 1e-5 if field == "psd_diff" else 1e-9
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(b - a).max() <= tol * scale, (field, np.abs(b - a).max(),
                                                scale)


def test_branch_fires(case):
    """The case is not vacuous: its flag changes the lanes or tallies,
    and the branch's own observable is there."""
    flag, kind = case["flag"], case["kind"]
    got, tl = case["port"]
    off, tl_off = case["off"]
    if flag == "frg_alpha1":
        # alpha = 1 is the standard law: the per-lane cos_max equals the
        # precomputed one to a float64 rounding, and so do the lanes
        for f in INT_FIELDS:
            np.testing.assert_array_equal(got[f], off[f], err_msg=f)
        p = np.hypot(off["pb"], off["pperp"])
        for f in ("pb", "pperp"):
            np.testing.assert_array_less(np.abs(got[f] - off[f]),
                                         1e-12 * p + 1e-300, err_msg=f)
        return
    moved = any(not np.array_equal(got[f], off[f])
                for f in INT_FIELDS + FLOAT_FIELDS)
    assert moved, flag
    if flag == "frg" and kind == "electron":
        below = case["below_pe_crit"]
        assert below.sum() > 10 and (~below).sum() > 10
    # with every flag on, the no-scatter escape takes the downstream
    # lanes at their first step, before a tcut or a PRP (the shipped
    # baseline's switches)
    if flag == "do_tcuts":
        assert tl["weight_coupled"].sum() > 0
        np.testing.assert_allclose(tl["spectra_coupled"].sum(),
                                   tl["weight_coupled"].sum(), rtol=1e-12)
    if flag == "do_retro":
        assert case["counts"][tst.C_RETRO] > 0
    if flag == "do_rad_losses":
        assert case["counts"][tst.C_RAD] > 0
    if flag in ("do_energy_transfer", "all") and kind == "ion":
        assert np.abs(tl["pool_diff"]).max() > 0
        assert tl_off["pool_diff"].max() == 0
    if flag in ("do_energy_transfer", "all") and kind == "electron":
        assert case["counts"][tst.C_RECV] > 0
    if flag in ("dont_scatter", "all"):
        assert (got["reason"] == tst.R_DOWNSTREAM).sum() > (
            off["reason"] == tst.R_DOWNSTREAM).sum()
