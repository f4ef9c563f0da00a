"""K1's static-flag branches in its plain version (ops/mega.py step_twin)
against the JAX megakernel, ``run_segment_mega(..., interpret=True)``, on
the CPU.

configs/baseline.toml with the electrons' density set to 1 and the lane
population of tests/torch_flag_cases.py at float32 (electrons up to
10^9 m c, where their radiative loss is larger than a float32 ulp of
the momentum, and the group returning to the shock within 1e-4 r_g0 of
it, so that it reaches the shock in 16 steps).  Each case turns on one
static flag -- or all of them, or the custom f(r_g) law (alpha = 1.5,
and alpha = 1, the standard law) -- for the species whose lanes reach it,
and runs one launch of 16 steps with the helix cap at 16 in both
packages.  Both draw the megakernel's
lane-keyed uniforms, so lanes follow the same trajectories.

Tolerances are those of tests/test_torch_mega.py: integer fields
(status, reason, step count, flags, tcut index) agree on at least 99%
of lanes (the reference compares float32 words of double-single
positions and acceleration times, the port float64); float fields to
1e-5 on 99% of lanes (momenta relative to the lane's |p|, positions
relative to the distance travelled as well); tally totals -- the flux
channels, the ions' pool, the tcut weights and spectra -- to 1e-2,
which covers the reference's bf16 stochastic rounding and its bf16
splits of the eps_target and received-pool tables.  The reference's
PSD band drops the records of this population's wide momentum spread
(its check is turned off here); the PSD deposit does not depend on the
flags and is held in tests/test_torch_mega.py.  Each case also checks
that its branch changed the lanes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarloscattering_jl_tpu.ops import pallas_step as ps
from montecarloscattering_jl_tpu.ops import state as jst
from montecarloscattering_jl_tpu_torch.ops import mega
from montecarloscattering_jl_tpu_torch.ops import state as tst

import torch_flag_cases as fc

H = 16
LANES = 256
E_TOP = 9.0
NEAR = 1.0e-4     # r_g0: the returning group reaches the shock in 16 steps
INT_FIELDS = ("status", "reason", "nsteps", "tcut")
FLAG_FIELDS = ("downstream", "inj", "retro", "just_returned")
FLOAT_FIELDS = ("pb", "pperp", "phi", "x", "prp_x", "acctime", "ux_prev",
                "xn_per", "t_step")
TOTALS = ("pxx_flux", "pxz_flux", "energy_flux", "num_crossings",
          "weight_coupled", "spectra_coupled", "energy_pool")

_np = fc.np_tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return fc.build(tmp_path_factory.mktemp("mega_flags"), jnp.float32)


def _port(state, tal, grids, sc, ss):
    st = tst.ParticleState.from_jax_numpy(_np(state))
    tl = tst.Tallies.from_jax_numpy(_np(tal))
    tb = mega.mega_tables(tst.SegmentGrids.from_jax_numpy(_np(grids)),
                          tst.SegmentScalars.from_jax_numpy(_np(sc)),
                          tst.StepStatic.from_jax(ss), "cpu")
    mega.check_supported(tst.StepStatic.from_jax(ss))
    mega.launch(st, tb, tl, n_steps=H, max_helix=H)
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
    state = fc.population(cfg, stp_setup, i_ion, jnp.float32, e_top=E_TOP,
                          near=NEAR, lanes=LANES)
    b = stp_setup.bins
    tal = jst.make_tallies(stp_setup.nb, b.n_mom, b.n_theta, 0,
                           eng.n_tcut_slots, jnp.float32, batch=LANES,
                           chunk=8, p_dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps, "MAX_HELIX_STEPS", H)
        mp.setattr(ps, "_LAUNCH_CACHE", {})
        mp.setattr(ps, "check_oob", lambda *a, **k: None)
        s_ref, t_ref = ps.run_segment_mega(state, tal, grids, sc, ss,
                                           steps_per_launch=H,
                                           interpret=True)
    st, tl = _port(state, tal, grids, sc, ss)
    st_off, _ = _port(state, tal, grids, sc, fc.static(eng, i_ion, "none"))
    torch.set_num_threads(n_thr)
    return dict(ref=_np(s_ref), ref_tl=jst.finalize_tallies(t_ref),
                port=st.to_numpy(), port_tl=tst.finalize_tallies(tl),
                off=st_off.to_numpy(), counts=tl.counts.numpy(),
                x0=np.asarray(state.x),
                flag=flag, kind=kind,
                below_pe_crit=np.hypot(np.asarray(state.pb),
                                       np.asarray(state.pperp))
                < float(sc.pe_crit))


@pytest.mark.parametrize("field", INT_FIELDS + ("flags",))
def test_integer_fields_per_lane(case, field):
    ref, got = case["ref"], case["port"]
    names = FLAG_FIELDS if field == "flags" else (field,)
    same = np.all([ref[k] == got[k] for k in names], axis=0)
    n_div = int((~same).sum())
    assert n_div <= 0.01 * LANES, f"{field}: {n_div} divergent lanes"


@pytest.mark.parametrize("field", FLOAT_FIELDS)
def test_float_fields_per_lane(case, field):
    """1e-5 on at least 99% of the lanes that agree in every integer
    field: a lane crossing into the gamma0 = 5 upstream flow against it
    steps by a near-cancelling sum of its own and the flow's velocity,
    which magnifies the one-ulp differences of the reference's bf16-split
    zone-field gathers."""
    ref, got = case["ref"], case["port"]
    same = np.all([ref[k] == got[k] for k in INT_FIELDS + FLAG_FIELDS],
                  axis=0)
    a = ref[field].astype(np.float64)[same]
    b = got[field].astype(np.float64)[same]
    if field in ("pb", "pperp"):
        scale = np.hypot(ref["pb"].astype(np.float64),
                         ref["pperp"].astype(np.float64))[same]
    elif field == "x":
        # relative to the distance travelled as well: a lane that ends
        # near the shock carries the rounding of its whole path
        scale = np.abs(a) + np.abs(a - case["x0"][same])
    else:
        scale = np.abs(a)
    n_off = int((np.abs(b - a) > 1e-5 * scale + 1e-300).sum())
    assert n_off <= 0.01 * LANES, f"{field}: {n_off} lanes beyond 1e-5"


@pytest.mark.parametrize("field", TOTALS)
def test_tally_totals(case, field):
    a = float(np.asarray(getattr(case["ref_tl"], field), np.float64).sum())
    b = float(getattr(case["port_tl"], field).double().sum())
    assert abs(b - a) <= 1e-2 * max(abs(a), abs(b)), (field, a, b)


def test_branch_fires(case):
    """The case is not vacuous: its flag changes the lanes, and the
    branch's own observable is there in both packages."""
    flag, kind = case["flag"], case["kind"]
    got, off, tl = case["port"], case["off"], case["port_tl"]
    if flag == "frg_alpha1":
        # alpha = 1 is the standard law: exp(log(.) * 0) = 1, and the
        # per-lane cos_max equals the precomputed one to a float32
        # rounding, so the lanes stay together over the launch
        for f in INT_FIELDS + FLAG_FIELDS:
            assert (got[f] != off[f]).sum() <= 0.01 * LANES, f
        p = np.hypot(off["pb"].astype(np.float64), off["pperp"])
        same = np.all([got[f] == off[f] for f in INT_FIELDS + FLAG_FIELDS],
                      axis=0)
        for f in ("pb", "pperp"):
            err = np.abs(got[f].astype(np.float64) - off[f])
            assert (err[same] > 1e-5 * p[same]).sum() <= 0.01 * LANES, f
        return
    if flag == "frg" and kind == "electron":
        below = case["below_pe_crit"]
        assert below.sum() > 10 and (~below).sum() > 10
    assert any(not np.array_equal(got[f], off[f])
               for f in INT_FIELDS + FLAG_FIELDS + FLOAT_FIELDS), flag
    ref_tl = case["ref_tl"]
    if flag in ("do_tcuts", "all") and kind == "ion":
        assert float(tl.weight_coupled.sum()) > 0
        assert float(np.asarray(ref_tl.weight_coupled).sum()) > 0
    if flag in ("do_energy_transfer", "all") and kind == "ion":
        assert float(tl.energy_pool.sum()) > 0
        assert float(np.asarray(ref_tl.energy_pool).sum()) > 0
    if flag == "do_energy_transfer" and kind == "electron":
        assert case["counts"][tst.C_RECV] > 0
    if flag == "do_retro":
        assert case["counts"][tst.C_RETRO] > 0
        assert case["ref"]["retro"].any()
    if flag == "do_rad_losses":
        assert case["counts"][tst.C_RAD] > 0
