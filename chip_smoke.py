"""Smoke test of montecarloscattering_jl_tpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and builds every
   kernel of the port with nvcc for sm_90a, one nvcc per source, all
   started together: K1 (csrc/mega_step.cu) and K2/K3
   (csrc/psd_hist.cu), with each kernel's registers and spills.
2. ``k1``: holds K1 against its plain PyTorch version (ops/mega.py
   step_twin) on the card, on the flagship population:
   tests/data/dsa_nonrel.toml, 65,536 injected lanes at pcut index 2.
   First one 64-step launch from the same state (per-lane fields), then
   a full drain with the helix cap lowered to 512 steps (status counts,
   step totals, tallies).
3. ``flags``: the same with K1's static-flag branches on, on
   configs/baseline.toml (electron density set to 1) at 65,536 lanes
   placed to reach every branch (``flag_population``): protons of the
   science variant (tcuts, retro walk, custom eps_B, pool donation),
   electrons (radiative loss, received energy) and protons with the
   shipped no-scatter / no-DSA switches.  Window and drain as in 2, the
   pool, tcut and counter tallies included.  Then the custom f(r_g)
   mean-free-path law (alpha = 1.5, r_ref = 2 r_g0) on the science
   protons and electrons, and a window at alpha = 1, where K1's
   per-lane cos_max must give the standard law's lanes back: after one
   step every float field within 16 float32 ulp, no lane divergent.
4. ``hist``: holds K2 and K3 (ops/hist.py) against their plain versions
   on the card, through the histogram probe (scripts/probe_hist.py): K2
   at the main path's shape (one record per lane of the 69,632-lane
   batch into the 4,428 x 102 PSD) and on the probe's 2^21 records, K3
   at bands 1,024 and 2,048, K2 at the probe's 2^16-record P4 shape;
   each timed beside its plain version and, for K2/K4, beside one
   ``index_add_`` of the same records (the library call, never used by
   the port), and checked against float64.
5. ``f32``: drives the K1 path: ``engine.driver.run`` on the flagship
   nonlinear config with float32 momenta (65,536 particles per pcut,
   smoothing on, 2 iterations); checks that every transport launch went
   through K1 and none through the twin, that the output files are
   written, and the test-particle power-law slope of iteration 1.
6. ``science``: the gamma0 = 5 baseline's science variant on K1 (f32):
   configs/baseline.toml with scattering, DSA and smoothing on, 4 pcuts
   per decade, the helix cap at 200,000 steps and 4x the particle
   counts (scripts/flagship_baseline.py --dsa --pcuts-per-decade 4
   --max-helix-steps 200000 --n-pts-mult 4), 1 iteration.  Every drain
   must launch K1; the coupled CSVs are written; per species the exit
   reasons, tcut weights, pool, retro entries and radiated energy are
   printed, and the proton side must show tcut weight and retro or age
   activity.
7. ``electrons32``: examples/03_electron_synch_ic.toml as shipped,
   photon production on, on K1 (float32), every pcut at the default
   helix cap: both species' drains launch K1 (none the twin or the XLA
   engine), the electrons' rad-loss branch runs inside it, the electron
   species must push and exit, and the photon files are written.
8. ``sed``: the SED flagship (scripts/flagship_sed.py of the port):
   examples/04_hadronic_sed.toml, gamma0 = 5, protons and electrons,
   radiative losses, 9 pcuts, photons on, 16,384 particles per pcut,
   float32 momenta, from config to the photon files.  Every drain must
   launch K1; the synchrotron, IC and pion shells and the total SED
   must be non-empty; L_synch / L_IC must lie within a factor 30 of
   U_B / U_CMB; and the emission pass on the card must agree with the
   per-zone NumPy loop on the same reductions to rtol 1e-5 on every bin
   above 1e-90.
9. ``electrons``: examples/03 with photon production off and the
   baseline's energy-transfer fraction 0.1 at float64 momenta (the XLA
   engine and K2), cut to its first 4 pcuts and a 2,000-step helix cap: the
   ions' pool, the electrons' received and radiated energy must be
   positive.  Float64, because a thermal proton's gamma - 1 (~2e-8) and
   an electron's loss in a step (~1e-10 of its momentum) are below a
   float32 ulp, so at float32 they read 0.  The reference removes a
   lane as radiated only when its momentum after the loss is <= 0,
   which p / (1 + dlnp) never is, so the exit count is printed, not
   required.
10. ``f64``: drives the XLA-engine path, the JAX CLI's default: the
   flagship config with float64 momenta and two x_spec detectors at
   -/+0.5 r_g0, 1 iteration, cut to its first 4 pcuts; checks that every
   PSD deposit went through K2 (none through its plain version, no K1
   launch), that the output files with mc_xspec.dat are written, that
   both detectors' spectra are positive, and the slope.
11. ``shipped``: configs/baseline.toml as shipped (no-scatter, no-DSA)
    at float64 on the XLA engine, 1 iteration: every PSD deposit
    through K2, the coupled CSVs written, pushes and trajectories
    printed.

Every phase that fails raises, so the script exits non-zero; it also
exits non-zero without a CUDA device.  The line before the last is a
JSON summary of the kernels, the last line the device record.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "tests", "data", "dsa_nonrel.toml")
BASELINE = os.path.join(ROOT, "configs", "baseline.toml")
ELECTRONS = os.path.join(ROOT, "examples", "03_electron_synch_ic.toml")
LANES = 65_536
WINDOW = 64
DRAIN_CAP = 512
# per-lane bounds of K1 against the twin on the card: both round every
# f32 operation once (nvcc -fmad=false) and call the same CUDA libm, so
# state agrees to a few ulp; lanes whose step count or status differ
# (a transcendental one ulp apart on the other side of a threshold)
# are counted and may be at most 0.1% of the lanes
ULP_BOUND = 16 * 2.0 ** -23    # relative; momenta relative to |p|
MAX_DIVERGENT = 1e-3
TALLY_RTOL = 1e-4                          # f32 atomics in any order
# K2/K3 against their plain versions: f32 sums in another order
HIST_TOL = 1e-4                            # of max |psd|
# the science variant (scripts/flagship_baseline.py --dsa
# --pcuts-per-decade 4 --max-helix-steps 200000 --n-pts-mult 4)
SCIENCE_PCUTS_PER_DECADE = 4
SCIENCE_CAP = 200_000
SCIENCE_PTS_MULT = 4
# the f64 paths' cuts: pcut segments kept, and examples/03's helix cap
F64_PCUTS = 4
ELECTRON_CAP = 2_000
# the flags phase: the electrons' flat received-energy pool [erg per
# zone], and the top of their momentum range [log10 m c], where the
# radiative loss of a step exceeds a float32 ulp of the momentum
RECV_PER_ZONE = 3.0e-7
E_TOP = 9.0
# the custom f(r_g) law of the frg windows: alpha and the reference
# radius in r_g0 (tests/test_switches.py)
FRG_ALPHA, FRG_RG0_RG = 1.5, 2.0
# the SED flagship's particles per pcut (scripts/flagship_sed.py), and
# the bound of the card's emission pass against the per-zone NumPy loop
# on every bin above EMISSION_FLOOR (tests/test_device_emission.py)
SED_PER_PCUT = 16_384
EMISSION_RTOL, EMISSION_FLOOR = 1e-5, 1e-90
# JAX CPU run of the shipped baseline (1 iteration, --f32, XLA engine),
# for comparison with the port's counts
SHIPPED_JAX_PUSHES, SHIPPED_JAX_TRAJECTORIES = 980_000, 196
# the H100 SXM's published peaks: HBM bytes/s and the
# float32 rate outside the tensor cores, which bound_ms also applies to
# K1's integer operations
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# K1's operations per helix step, counted from csrc/mega_step.cu on the
# flagship's branches: two threefry2x32 blocks (~230 integer ops), the
# eight uniforms (~32), the zone search (~28), ~8 hypot (~64), the frame
# transform, escapes and scattering (~75), the movement with one
# reflection try (~35), the PSD bins and tallies (~60) and the
# downstream logic (~30)
K1_OPS_PER_PUSH = 560
# bytes of one lane's state K1 reads (80) and writes (68)
K1_STATE_BYTES = 148
HIST_RECORD_BYTES = 16                     # cell, lo, hi, w


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time [ms] the card could take: bytes over the memory
    rate or operations over the float32 rate, whichever is larger."""
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, n_ops / F32_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def flagship_population(setup, cfg, dev):
    """bench.py's drain population: the injected distribution tiled to
    LANES lanes, keyed from seed 0."""
    import numpy as np

    from montecarloscattering_jl_tpu_torch.models.injection import init_pop
    from montecarloscattering_jl_tpu_torch.ops import rng, state as stt

    prof = setup.profile
    pop = init_pop(np.random.default_rng(0), cfg.species, 0, 1,
                   cfg.energy_inj, True, cfg.n_pts_inj, setup.x_grid_start,
                   cfg.rg0, 1.0, True, -1.0, cfg.beta0, cfg.gamma0, cfg.u0,
                   setup.x_grid_rg, prof.ux_sk, prof.gamma_sf)
    reps = LANES // len(pop.ptot_pf) + 1
    t = lambda a: np.tile(a, reps)[:LANES]
    return stt.init_state(
        t(pop.weight), t(pop.ptot_pf), t(pop.pb_pf), t(pop.x_cm),
        t(pop.i_grid).astype(np.int32), t(prof.ux_sk[pop.i_grid]),
        cfg.xn_per_fine, setup.x_grid_stop, rng.key(0), dev)


def flag_population(cfg, setup, i_ion, dev, seed=0):
    """LANES lanes that reach every flag branch within one window, as
    tests/torch_flag_cases.py places them: a quarter upstream within
    0.01 r_g0 (times the species' mass over the protons') of the shock
    moving with the flow (pool donation or
    receipt on the crossing), a quarter within 1e-4 r_g0 downstream
    moving upstream at 3 m c (the no-DSA reflection), half beyond the
    grid end (custom eps_B) with the PRP 1 to 3% ahead (the retro walk)
    at 3-30 m c (electrons up to 10^E_TOP m c).  Acceleration times sit
    around a tcut, an eighth past the age limit; the last step size is a
    fine step in the lane's zone."""
    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.ops import rng, state as stt
    from montecarloscattering_jl_tpu_torch.utils import constants as K

    g = np.random.default_rng(seed)
    s = cfg.species[i_ion]
    mc = s.mass * K.C_CGS
    prof = setup.profile
    n = LANES // 4
    rg0, x_stop = cfg.rg0, setup.x_grid_stop
    x = np.concatenate([-1.0e-2 * rg0 * (s.mass / cfg.species[0].mass)
                        * g.random(n),
                        1.0e-4 * rg0 * g.random(n),
                        x_stop * (1.0 + 0.5 * g.random(2 * n))])
    ptot = np.concatenate([
        0.05 * mc * (1.0 + g.random(n)), 3.0 * mc * np.ones(n),
        mc * 10.0 ** g.uniform(0.5, E_TOP if s.is_electron else 1.5,
                               2 * n)])
    mu = np.concatenate([g.uniform(-1, 1, n), -0.9 + 0.1 * g.random(n),
                         0.5 + 0.5 * g.random(2 * n)])
    ig = (np.searchsorted(setup.x_grid_cm, x, side="right") - 1).astype(
        np.int32)
    tc = np.asarray(cfg.tcuts)
    slot = g.integers(0, len(tc) - 1, LANES)
    acct = tc[slot] * g.uniform(0.3, 1.2, LANES)
    acct[-n // 2:] = 1.1 * cfg.age_max
    dw = x > 0.0
    st = stt.init_state(
        np.ones(LANES), ptot, ptot * mu, x, ig, prof.ux_sk[ig],
        cfg.xn_per_fine, x_stop, rng.key(seed), dev, downstream=dw,
        inj=dw & (x > x_stop), acctime=acct, tcut=slot.astype(np.int32))
    prp = np.where(x > x_stop, x * g.uniform(1.01, 1.03, LANES), x_stop)
    gamma = np.hypot(ptot / mc, 1.0)
    t_step = (2.0 * np.pi * gamma * mc / (abs(s.charge) * prof.btot[ig])
              / cfg.xn_per_fine)
    st.prp_x = torch.from_numpy(prp).to(dev)
    st.t_step = torch.from_numpy(t_step).to(dev, torch.float32)
    return st, float(ptot.max())


def clone_state(st):
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone()
        for f in dataclasses.fields(st)})


def compare_lanes(a, b) -> dict:
    """Per-lane differences between two states (K1 = a, twin = b)."""
    import torch
    out = {}
    same = torch.ones_like(a.status, dtype=torch.bool)
    for name in ("status", "reason", "nsteps", "flags", "tcut"):
        eq = getattr(a, name) == getattr(b, name)
        out[f"mismatch_{name}"] = int((~eq).sum())
        same &= eq
    ptot = torch.hypot(b.pb.double(), b.pperp.double())
    worst = 0.0
    n_off = 0
    for name in ("pb", "pperp", "phi", "ux_prev", "xn_per", "t_step", "x",
                 "prp_x", "acctime"):
        va = getattr(a, name).double()
        vb = getattr(b, name).double()
        scale = ptot if name in ("pb", "pperp") else vb.abs()
        rel = ((va - vb).abs() / scale.clamp(min=1e-300))[same]
        rel = torch.where(va[same] == vb[same], 0.0, rel)
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
        n_off += int((rel > ULP_BOUND).sum())
        out[f"maxrel_{name}"] = float(rel.max()) if rel.numel() else 0.0
    out["float_lanes_over_bound"] = n_off
    out["divergent_lanes"] = int((~same).sum())
    return out


def time_launches(fn, prepared) -> float:
    """Mean ms of fn(*args) over the prepared argument sets after the
    first (a warm-up), by CUDA events around the launches alone."""
    import torch
    fn(*prepared[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in prepared[1:]:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(prepared) - 1)


# the finalized tallies K1 and the twin must agree on, as totals
TALLY_FIELDS = ("psd", "therm_psd", "pxx_flux", "pxz_flux", "energy_flux",
                "num_crossings", "px_esc_up", "en_esc_up", "sum_p_dw",
                "sum_ke_dw", "weight_coupled", "spectra_coupled",
                "energy_pool", "retro_entries", "energy_received",
                "energy_radiated")


def compare_totals(tag, fk, ftw) -> dict:
    """Totals of every finalized tally, K1 (fk) against the twin (ftw);
    fails beyond TALLY_RTOL."""
    out = {}
    for name in TALLY_FIELDS:
        a = float(getattr(fk, name).double().sum())
        c = float(getattr(ftw, name).double().sum())
        out[name] = c
        if abs(a - c) > TALLY_RTOL * max(abs(c), 1e-300) and (a or c):
            fail(f"{tag} {name}: K1 {a!r} twin {c!r}")
    return out


def hold_k1(tag, tabs, st0, fresh_tal, drain: bool = True) -> dict:
    """K1 against its twin from the same state: one WINDOW-step launch
    (per-lane fields, tally totals, both timed: plain, kernel, kernel,
    plain), then, with `drain`, a drain to DRAIN_CAP steps."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import mega, state as stt

    # ---- one 64-step launch from the same state -------------------------
    s_k, t_k = clone_state(st0), fresh_tal()
    s_t, t_t = clone_state(st0), fresh_tal()
    torch.cuda.synchronize()
    mega.launch(s_k, tabs, t_k, WINDOW, 10_000)
    mega.step_twin(s_t, tabs, t_t, WINDOW, 10_000)
    torch.cuda.synchronize()
    lanes = compare_lanes(s_k, s_t)
    print(f"{tag} window per-lane:", json.dumps(lanes))
    if lanes["divergent_lanes"] > MAX_DIVERGENT * LANES:
        fail(f"{tag} window: {lanes['divergent_lanes']} lanes diverge")
    if lanes["float_lanes_over_bound"] > MAX_DIVERGENT * LANES:
        fail(f"{tag} window: {lanes['float_lanes_over_bound']} float "
             f"fields beyond {ULP_BOUND:.3g} relative")
    psd_err = float((t_k.psd_diff - t_t.psd_diff).abs().max())
    # bytes of the tally entries the window added to, each read and
    # written once (the entries no lane touched need no traffic)
    touched = sum(2 * int(torch.count_nonzero(v)) * v.element_size()
                  for v in (getattr(t_t, f.name)
                            for f in dataclasses.fields(t_t))
                  if isinstance(v, torch.Tensor))
    win = compare_totals(f"{tag} window", stt.finalize_tallies(t_k),
                         stt.finalize_tallies(t_t))
    print(f"{tag} window psd: max_abs_err={psd_err:.6e}; twin totals "
          f"{json.dumps(win)}")
    pushes_w = int((s_t.nsteps - st0.nsteps).sum())

    def k1_window(s, t):
        mega.launch(s, tabs, t, WINDOW, 10_000)

    def twin_window(s, t):
        mega.step_twin(s, tabs, t, WINDOW, 10_000)

    prep = lambda n: [(clone_state(st0), fresh_tal()) for _ in range(n)]
    # plain, kernel, kernel, plain
    tw1 = time_launches(twin_window, prep(2))
    k1a = time_launches(k1_window, prep(11))
    k1b = time_launches(k1_window, prep(11))
    tw2 = time_launches(twin_window, prep(2))
    k1_ms, tw_ms = (k1a + k1b) / 2, (tw1 + tw2) / 2
    print(f"{tag} window {WINDOW} steps x {LANES} lanes ({pushes_w} "
          f"pushes): K1 {k1a:.4f} / {k1b:.4f} ms "
          f"({pushes_w / k1_ms / 1e3:.1f} M pushes/s), twin {tw1:.2f} / "
          f"{tw2:.2f} ms ({pushes_w / tw_ms / 1e3:.3f} M pushes/s)")
    out = dict(max_abs_err=psd_err, ms=k1_ms, plain_ms=tw_ms,
               pushes=pushes_w, tally_bytes=touched, window=win)
    if not drain:
        return out

    # ---- a full drain (helix cap lowered) ------------------------------
    res = {}
    for who in ("twin", "k1"):
        s, t = clone_state(st0), fresh_tal()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if who == "k1":
            mega.drain(s, tabs, t, max_helix=DRAIN_CAP)
        else:
            n_act = int((s.status == 0).sum())
            k = 0
            while n_act > 0 and k < DRAIN_CAP // mega.STEPS + 2:
                n_act = mega.step_twin(s, tabs, t, mega.STEPS, DRAIN_CAP)
                k += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res[who] = (s, stt.finalize_tallies(t), dt)
    (sk, fk, dk), (stw, ftw, dtw) = res["k1"], res["twin"]
    ck = torch.bincount(sk.status, minlength=3).tolist()
    ct = torch.bincount(stw.status, minlength=3).tolist()
    rk = torch.bincount(sk.reason, minlength=5).tolist()
    nk, nt = int(sk.nsteps.sum()), int(stw.nsteps.sum())
    div = compare_lanes(sk, stw)["divergent_lanes"]
    print(f"{tag} drain status K1 {ck} twin {ct}; reasons K1 {rk}; nsteps "
          f"K1 {nk} twin {nt}; divergent lanes {div}")
    if div > MAX_DIVERGENT * LANES:
        fail(f"{tag} drain: {div} lanes diverge")
    if any(abs(x - y) > div for x, y in zip(ck, ct)):
        fail(f"{tag} drain status counts differ beyond the divergent lanes")
    if abs(nk - nt) > div * DRAIN_CAP:
        fail(f"{tag} drain step totals differ beyond the divergent lanes")
    drained = compare_totals(f"{tag} drain", fk, ftw)
    print(f"{tag} drain to {DRAIN_CAP}-step cap: K1 {dk:.3f} s "
          f"({nk / dk / 1e6:.2f} M pushes/s), twin {dtw:.3f} s "
          f"({nt / dtw / 1e6:.3f} M pushes/s); twin totals "
          f"{json.dumps(drained)}")
    return dict(out, drain=drained, reasons=rk)


def kernel_vs_twin(dev) -> dict:
    """K1 against its twin on the flagship population (phase k1), with
    the bound of its window."""
    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import mega, state as stt
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(CFG)
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=dev)
    grids = eng.segment_grids(setup.profile)
    sc = eng.segment_scalars(0, 2, setup.profile.bmag2)
    ss = eng.step_static(0)
    mega.check_supported(ss)
    tabs = mega.mega_tables(grids, sc, ss, dev)
    st0 = flagship_population(setup, cfg, dev)
    b = setup.bins
    fresh_tal = lambda: stt.make_tallies(setup.nb, b.n_mom, b.n_theta, dev)
    out = hold_k1("flagship", tabs, st0, fresh_tal)
    out["bound_ms"], out["bound_by"] = bound(
        LANES * K1_STATE_BYTES + out["tally_bytes"],
        out["pushes"] * K1_OPS_PER_PUSH)
    print(f"flagship window bound: {out['bound_ms']:.6f} ms "
          f"({out['bound_by']}; {out['tally_bytes']} B of tally entries "
          f"touched)")
    return out


def load_variant(path: str, replace=(), **fields):
    """A config file with text replacements, loaded through a temporary
    copy, then with `fields` set on the RunConfig."""
    from montecarloscattering_jl_tpu_torch.utils import load_config

    text = open(path).read()
    for old, new in replace:
        if old not in text:
            fail(f"{path}: {old!r} not found")
        text = text.replace(old, new)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, os.path.basename(path))
        with open(p, "w") as f:
            f.write(text)
        cfg = load_config(p)
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def science_variant(cfg) -> None:
    """Scattering, DSA and smoothing on, the geometric pcut ladder and
    the larger particle counts of the science runs, in place."""
    from montecarloscattering_jl_tpu_torch.utils.config import (
        auto_pcut_ladder, check_pcuts)

    cfg.dont_scatter = cfg.dont_dsa = False
    cfg.do_smoothing = True
    cfg.pcuts = auto_pcut_ladder(cfg.pcuts[0], SCIENCE_PCUTS_PER_DECADE,
                                 cfg.emax, cfg.emax_per_aa, cfg.pmax)
    check_pcuts(cfg.pcuts, cfg.emax, cfg.emax_per_aa, cfg.pmax)
    cfg.n_pts_inj *= SCIENCE_PTS_MULT
    cfg.n_pts_pcut *= SCIENCE_PTS_MULT
    cfg.n_pts_pcut_hi *= SCIENCE_PTS_MULT


# (tag, species, science switches, flags that must be on, alpha of the
# custom f(r_g) law or None)
_PROTON_FLAGS = ("do_tcuts", "do_retro", "use_custom_eps_b",
                 "do_energy_transfer")
_ELECTRON_FLAGS = ("do_rad_losses",) + _PROTON_FLAGS
FLAG_CASES = (("protons", 0, True, _PROTON_FLAGS, None),
              ("electrons", 1, True, _ELECTRON_FLAGS, None),
              ("protons-shipped", 0, False, ("dont_scatter", "dont_dsa",
                                             "do_tcuts", "do_retro"), None),
              ("protons-frg", 0, True, _PROTON_FLAGS, FRG_ALPHA),
              ("electrons-frg", 1, True, _ELECTRON_FLAGS, FRG_ALPHA),
              ("protons-frg-alpha1", 0, True, _PROTON_FLAGS, 1.0))


def hold_alpha1(tag, tabs, tabs_std, st0, fresh_tal) -> None:
    """One K1 step with the custom f(r_g) law at alpha = 1 (`tabs`)
    against one with the standard law (`tabs_std`) from the same state:
    exp(log(.) * 0) = 1, so the per-lane cos_max is the precomputed one
    to a float32 rounding, and so are the lanes."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import mega

    s_f, s_s = clone_state(st0), clone_state(st0)
    mega.launch(s_f, tabs, fresh_tal(), 1, 10_000)
    mega.launch(s_s, tabs_std, fresh_tal(), 1, 10_000)
    torch.cuda.synchronize()
    lanes = compare_lanes(s_f, s_s)
    print(f"{tag} one step against the standard law:", json.dumps(lanes))
    if lanes["divergent_lanes"] or lanes["float_lanes_over_bound"]:
        fail(f"{tag}: alpha = 1 differs from the standard law: {lanes}")


def kernel_vs_twin_flags(dev) -> dict:
    """K1 against its twin with the static-flag branches on (phase
    flags): the baseline (electron density 1) at the science variant's
    switches for protons and electrons, and at the shipped switches for
    protons, on flag_population's lanes."""
    import numpy as np

    from montecarloscattering_jl_tpu_torch.engine.run import (
        TransportEngine, populate_eps_target)
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import mega, state as stt

    out = {}
    for tag, i_ion, science, want, frg_alpha in FLAG_CASES:
        cfg = load_variant(BASELINE, replace=[("DENZ_ION = [1.0, 0.0]",
                                               "DENZ_ION = [1.0, 1.0]")])
        if science:
            science_variant(cfg)
        if frg_alpha is not None:
            cfg.use_custom_frg = True
            cfg.frg_alpha, cfg.frg_rg0_rg = frg_alpha, FRG_RG0_RG
        setup = build_setup(cfg)
        eng = TransportEngine(setup, device=dev)
        prof = setup.profile
        eps = populate_eps_target(cfg.energy_transfer_frac, cfg.u0,
                                  cfg.gamma0, setup.u2, setup.gamma2, prof)
        grids = eng.segment_grids(prof, eps_target=eps,
                                  recv_pool=np.full(setup.nb, RECV_PER_ZONE))
        st0, p_top = flag_population(cfg, setup, i_ion, dev)
        # a pcut above every lane: the window saves none of them
        i_pcut = next(i for i, p in enumerate(cfg.pcuts) if p > 2.0 * p_top)
        sc = eng.segment_scalars(i_ion, i_pcut, prof.bmag2)
        ss = eng.step_static(i_ion)
        off = [f for f in want if not getattr(ss, f)]
        if off:
            fail(f"flags {tag}: {off} are off in the config")
        mega.check_supported(ss)
        tabs = mega.mega_tables(grids, sc, ss, dev)
        if bool(tabs.flags & mega.FLAG_CUSTOM_FRG) != (frg_alpha is not None):
            fail(f"flags {tag}: the f(r_g) bit is {tabs.flags:#x}")
        b = setup.bins
        fresh_tal = lambda: stt.make_tallies(
            setup.nb, b.n_mom, b.n_theta, dev,
            n_tcut_slots=eng.n_tcut_slots)
        if frg_alpha == 1.0:
            # the window only, and one step against the standard law
            out[tag] = hold_k1(f"flags {tag}", tabs, st0, fresh_tal,
                               drain=False)
            std = dataclasses.replace(ss, frg_rg0_cm=0.0)
            hold_alpha1(f"flags {tag}", tabs,
                        mega.mega_tables(grids, sc, std, dev), st0, fresh_tal)
            continue
        r = out[tag] = hold_k1(f"flags {tag}", tabs, st0, fresh_tal)
        w, d = r["window"], r["drain"]
        fired = {
            "tcut weight": d["weight_coupled"] if "do_tcuts" in want
            and i_ion == 0 else 1.0,
            "pool": d["energy_pool"] if "do_energy_transfer" in want
            and i_ion == 0 else 1.0,
            "received": d["energy_received"] if i_ion == 1 else 1.0,
            "radiated": w["energy_radiated"] if i_ion == 1 else 1.0,
            "retro entries": d["retro_entries"] if science and i_ion == 0
            else 1.0,
            "no-scatter exits": r["reasons"][1] if not science else 1.0}
        dead = [k for k, v in fired.items() if not v > 0]
        if dead:
            fail(f"flags {tag}: no {dead} (the branch did not fire)")
    return out


def expected_files(cfg):
    names = ["mc_out.dat", "mc_grid.dat", "mc_profile.json"]
    suffixes = ([f"_{i + 1}" for i in range(cfg.n_itrs)]
                if cfg.do_multi_dndps else [""])
    for sfx in suffixes:
        names += [f"mc_dNdp_grid_therm{sfx}.dat", f"mc_dNdp_grid_CR{sfx}.dat"]
    if cfg.do_tcuts:
        names += ["mc_coupled_weights.csv", "mc_coupled_spectra.csv"]
    if cfg.x_spec:
        names.append("mc_xspec.dat")
    if cfg.do_photons:
        names += ["photon_pion_decay_grid.dat", "photon_synch_grid.dat",
                  "photon_IC_grid.dat", "photon_pion_summed.dat",
                  "photon_synch_summed.dat", "photon_IC_summed.dat",
                  "photon_tot.dat", "photon_tot_summed.dat"]
    return names


def hist_phase(dev) -> dict:
    """K2, K3 and K4 (K2 at P4's shape) against their plain versions on
    the same records, with the histogram probe (scripts/probe_hist.py):
    ns/record of each, errors against the plain version and against
    float64."""
    from montecarloscattering_jl_tpu_torch.scripts import probe_hist as ph

    print("histogram kernels (scripts/probe_hist.py):")
    out = ph.run(dev)
    for name, r in out.items():
        err, scale = r["max_abs_err"], r["max_abs_psd"]
        if not scale > 0 or not math.isfinite(err) or err > HIST_TOL * scale:
            fail(f"{name}: max abs err {err!r} against the plain version "
                 f"(max |psd| {scale!r})")
        if not r["rel_err_f64"] < 1e-4:
            fail(f"{name}: max rel err {r['rel_err_f64']!r} against "
                 f"float64")
    return out


def slope_of(res) -> tuple[float, float]:
    """The downstream power-law slope of iteration 1 and its theory."""
    import numpy as np

    from montecarloscattering_jl_tpu_torch.utils import constants as K

    setup = res.setup
    fi = res.iterations[0].ion_finals[0]
    p_cent = setup.bins.mom_centers
    dndp = fi.psd[:, :, 75].sum(axis=1) / np.diff(setup.bins.mom_edges)
    sel = ((p_cent > 0.018 * K.MP_C) & (p_cent < 0.12 * K.MP_C)
           & (dndp > 0))
    if sel.sum() < 6:
        fail(f"only {sel.sum()} spectrum bins in the fit range")
    slope = float(np.polyfit(np.log10(p_cent[sel]), np.log10(dndp[sel]),
                             1)[0])
    return slope, -(3 * setup.r_comp / (setup.r_comp - 1) - 2)


def drive(cfg, dev, p_dtype, tag: str, cap: int = 0) -> tuple:
    """One driven run through ``engine.driver.run``, the helix cap of
    both engines set to `cap` for it when given; counts of every
    kernel's launches set to 0 just before it and read just after.
    Checks the engine each drain took, the output file set and the
    reductions; returns (result, counts, wall seconds, files with their
    line counts)."""
    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.ops import hist, mega
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    caps = (mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS)
    if cap:
        mega.MAX_HELIX_STEPS = xla_step.MAX_HELIX_STEPS = cap
    try:
        with tempfile.TemporaryDirectory() as out:
            mega.LAUNCHES = mega.TWIN_CALLS = 0
            hist.LAUNCHES = hist.BAND_LAUNCHES = hist.PLAIN_CALLS = 0
            t0 = time.perf_counter()
            res = run(cfg, device=dev, out_dir=out, p_dtype=p_dtype)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(k1=mega.LAUNCHES, twin=mega.TWIN_CALLS,
                          k2=hist.LAUNCHES, k3=hist.BAND_LAUNCHES,
                          hist_plain=hist.PLAIN_CALLS)
            written = {}
            for name in sorted(os.listdir(out)):
                with open(os.path.join(out, name), "rb") as f:
                    written[name] = sum(1 for _ in f)
    finally:
        mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS = caps
    phases = {k: round(v, 3) for k, v in res.timers.totals.items()}
    print(f"{tag}: {len(res.iterations)} iterations, "
          f"{res.n_trajectories} trajectories, {res.n_pushes} pushes in "
          f"{wall:.2f} s ({res.n_pushes / wall / 1e6:.2f} M pushes/s); "
          f"launches {json.dumps(counts)}; phases {json.dumps(phases)}")
    if p_dtype == torch.float32:
        if counts["k1"] <= 0 or counts["twin"] != 0 or counts["k2"] != 0:
            fail(f"{tag}: {counts} (every drain must launch K1, none the "
                 f"twin or the XLA engine)")
    elif (counts["k2"] <= 0 or counts["hist_plain"] != 0
          or counts["k1"] != 0 or counts["twin"] != 0):
        fail(f"{tag}: {counts} (every deposit must launch K2, no K1)")
    missing = [f for f in expected_files(cfg) if f not in written]
    if missing:
        fail(f"{tag}: output files missing: {missing} (got {written})")
    for itr in res.iterations:
        for f in itr.ion_finals:
            if not (np.isfinite(f.dndp_cr).all()
                    and np.isfinite(f.p_psd_par).all()):
                fail(f"{tag}: non-finite reductions")
    return res, counts, wall, written


def species_report(tag, res) -> list:
    """Per species of iteration 1: exit reasons, tcut weights, pool,
    received and radiated energy, retro entries, pushes and
    trajectories, printed as JSON; returns the list."""
    import numpy as np

    it = res.iterations[0]
    rows = []
    for i_ion, f in enumerate(it.ion_finals):
        rc = [int(v) for v in f.reason_counts]
        wc = it.tallies.weight_coupled
        row = dict(
            species=i_ion, exits=dict(downstream=rc[1], pmax_feb=rc[2],
                                      age=rc[3], radiated=rc[4]),
            tcut_weight=float(wc[:, i_ion].sum()) if wc is not None else 0.0,
            pool_erg=float(np.sum(it.tallies.energy_pool))
            if i_ion == 0 else None,
            received_erg=f.energy_received, radiated_erg=f.energy_radiated,
            retro_entries=f.retro_entries, pushes=f.n_pushes,
            trajectories=f.n_trajectories)
        rows.append(row)
        print(f"{tag} species {i_ion}: {json.dumps(row)}")
    setup = res.setup
    print(f"{tag}: r_comp {setup.r_comp:.4f} against r_RH "
          f"{setup.r_rh:.4f}")
    return rows


def main_path(dev, p_dtype, n_itrs: int, x_spec: bool) -> dict:
    """The flagship config driven through one engine (phases f32, f64):
    the slope of iteration 1, and the detector spectra with x_spec."""
    import torch

    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(CFG)
    cfg.n_itrs = n_itrs
    cfg.do_smoothing = True
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = LANES
    if x_spec:
        cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    if p_dtype == torch.float64:
        cfg.pcuts = cfg.pcuts[:F64_PCUTS]
    tag = f"{str(p_dtype).replace('torch.', '')} path"
    res, counts, _, _ = drive(cfg, dev, p_dtype, tag)
    slope, expect = slope_of(res)
    print(f"{tag}: iteration 1 downstream slope {slope:.4f} (expected "
          f"{expect:.4f} +- 0.45)")
    if not math.isfinite(slope) or abs(slope - expect) > 0.45:
        fail(f"{tag}: slope {slope} vs {expect}")
    if x_spec:
        fi = res.iterations[0].ion_finals[0]
        tot = [(float(fi.spectra_sf[:, i].sum()),
                float(fi.spectra_pf[:, i].sum())) for i in range(2)]
        print(f"{tag}: detector spectra totals (sf, pf) {tot}")
        if not all(a > 0 and b > 0 and math.isfinite(a + b)
                   for a, b in tot):
            fail(f"{tag}: detector spectra {tot}")
    return counts


def science_path(dev) -> dict:
    """The baseline's science variant on K1 at float32, 1 iteration
    (phase science)."""
    import torch

    cfg = load_variant(BASELINE, n_itrs=1)
    science_variant(cfg)
    print(f"science: {len(cfg.pcuts)} pcuts, {cfg.n_pts_inj} / "
          f"{cfg.n_pts_pcut} / {cfg.n_pts_pcut_hi} particles, helix cap "
          f"{SCIENCE_CAP}")
    res, counts, wall, written = drive(cfg, dev, torch.float32, "science",
                                       cap=SCIENCE_CAP)
    print(f"science: coupled CSV lines: weights "
          f"{written['mc_coupled_weights.csv']}, spectra "
          f"{written['mc_coupled_spectra.csv']}")
    rows = species_report("science", res)
    p = rows[0]
    if not (p["tcut_weight"] > 0
            and (p["exits"]["age"] + p["retro_entries"]) > 0):
        fail(f"science: a proton-side branch did not fire: {p}")
    # the pool: a proton donates at its first crossing from upstream, in
    # the upstream plasma frame, where the baseline's thermal protons
    # have gamma - 1 ~ 2e-8, below a float32 ulp of gamma: the donation
    # rounds to 0 on K1 as in the reference's megakernel (the flags
    # phase and the electrons phase show it at representable energies)
    print(f"science: ion pool {p['pool_erg']!r} erg (float32 momenta)")
    return dict(counts=counts, wall=wall, pushes=res.n_pushes,
                trajectories=res.n_trajectories, species=rows)


def emission_report(tag, res) -> dict:
    """The last iteration's emission: each process's shell total and
    the nonzero bins of the total SED, which must not be empty."""
    import numpy as np

    em = res.iterations[-1].emission
    if em is None:
        fail(f"{tag}: no emission result")
    tot = np.asarray(em.tot)
    sums = {k: float(np.asarray(getattr(em, k + "_shell")).sum())
            for k in ("synch", "ic", "pion")}
    print(f"{tag}: shell totals [erg/(cm^2 s)] {json.dumps(sums)}; "
          f"{int((tot > 0).sum())} nonzero bins of {tot.size} in the total "
          f"SED")
    if not (np.isfinite(tot).all() and (tot > 0).any()
            and all(v > 0 and math.isfinite(v) for v in sums.values())):
        fail(f"{tag}: an empty or non-finite SED: {sums}")
    return sums


def electron_path_f32(dev) -> dict:
    """examples/03 as shipped on K1 at float32, photons on (phase
    electrons32): both species' drains and the electrons' rad-loss
    branch run in K1; the electrons must push and exit, and the SED of
    their synchrotron and IC photons and the protons' pion decay is
    written."""
    import torch

    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(ELECTRONS)
    if not cfg.do_photons:
        fail("electrons32: examples/03 ships with photon production on")
    res, counts, wall, _ = drive(cfg, dev, torch.float32, "electrons32")
    rows = species_report("electrons32", res)
    e = rows[1]
    if not (e["pushes"] > 0 and sum(e["exits"].values()) > 0):
        fail(f"electrons32: the electrons did not push or exit: {e}")
    emission_report("electrons32", res)
    return dict(counts=counts, wall=wall, species=rows)


def sed_path(dev) -> dict:
    """The SED flagship on K1 at float32, SED_PER_PCUT particles per
    pcut (phase sed): transport, reductions, emission on the card and
    the photon files, then the script's physics checks and the card's
    emission pass against the per-zone NumPy loop on the same
    reductions."""
    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.models.emission import photon_calcs
    from montecarloscattering_jl_tpu_torch.scripts import flagship_sed

    cfg = flagship_sed.sed_config(SED_PER_PCUT)
    print(f"sed: {len(cfg.pcuts)} pcuts, {cfg.n_pts_inj} / {cfg.n_pts_pcut} "
          f"/ {cfg.n_pts_pcut_hi} particles, {cfg.n_ions} species")
    res, counts, wall, _ = drive(cfg, dev, torch.float32, "sed")
    rows = species_report("sed", res)
    sums = emission_report("sed", res)
    if not flagship_sed.check_sed(cfg, res):
        fail("sed: the flagship's physics checks failed")
    # the same reductions through both bodies of photon_calcs
    it = res.iterations[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em_dev = photon_calcs(res.setup, res.setup.profile, it.ion_finals,
                          device=dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    em_np = photon_calcs(res.setup, res.setup.profile, it.ion_finals,
                         device=None)
    t_np = time.perf_counter() - t0
    worst = {}
    for name in ("pion_grid", "synch_grid", "ic_grid", "pion_shell",
                 "synch_shell", "ic_shell", "tot"):
        a = np.maximum(np.asarray(getattr(em_np, name)), EMISSION_FLOOR)
        b = np.maximum(np.asarray(getattr(em_dev, name)), EMISSION_FLOOR)
        worst[name] = float(np.abs(b / a - 1.0).max())
    print(f"sed: emission on the card {t_dev:.3f} s, per-zone NumPy loop "
          f"{t_np:.3f} s; max relative difference above {EMISSION_FLOOR:g}: "
          f"{json.dumps(worst)}")
    bad = {k: v for k, v in worst.items() if not v <= EMISSION_RTOL}
    if bad:
        fail(f"sed: the card's emission differs from the NumPy loop: {bad}")
    return dict(counts=counts, wall=wall, pushes=res.n_pushes,
                trajectories=res.n_trajectories, species=rows, shells=sums)


def electron_variant():
    """examples/03 with photon production off and the baseline's
    energy-transfer fraction, 1 iteration."""
    return load_variant(ELECTRONS, replace=[
        ("calculate-photon-production = true",
         "calculate-photon-production = false"),
        ("energy-transfer-frac = 0.0", "energy-transfer-frac = 0.1")],
        n_itrs=1)


def electron_path(dev) -> dict:
    """electron_variant at float64, cut to its first F64_PCUTS pcuts and
    an ELECTRON_CAP helix cap (phase electrons): the ions' pool, the
    electrons' receipt and radiative loss on the driven path."""
    import torch

    cfg = electron_variant()
    cfg.pcuts = cfg.pcuts[:F64_PCUTS]
    res, counts, wall, _ = drive(cfg, dev, torch.float64, "electrons",
                                 cap=ELECTRON_CAP)
    rows = species_report("electrons", res)
    p, e = rows
    if not (p["pool_erg"] > 0 and e["received_erg"] > 0
            and e["radiated_erg"] > 0):
        fail(f"electrons: pool, receipt or radiative loss missing: {rows}")
    return dict(counts=counts, wall=wall, species=rows)


def shipped_path(dev) -> dict:
    """configs/baseline.toml as shipped at float64 on the XLA engine, 1
    iteration (phase shipped)."""
    import torch

    cfg = load_variant(BASELINE, n_itrs=1)
    res, counts, wall, written = drive(cfg, dev, torch.float64, "shipped")
    print(f"shipped: {res.n_pushes} pushes and {res.n_trajectories} "
          f"trajectories (the JAX package on the CPU, --f32: "
          f"{SHIPPED_JAX_PUSHES} and {SHIPPED_JAX_TRAJECTORIES}); coupled "
          f"CSV lines: weights {written['mc_coupled_weights.csv']}, "
          f"spectra {written['mc_coupled_spectra.csv']}")
    species_report("shipped", res)
    return dict(counts=counts, wall=wall, pushes=res.n_pushes,
                trajectories=res.n_trajectories)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT,
                                      "montecarloscattering_jl_tpu_torch")):
        print("chip_smoke: run from the root of a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from montecarloscattering_jl_tpu_torch.ops import build

    t_start = time.perf_counter()
    card = card_line()
    print(f"nvidia-smi: {card}")
    name = torch.cuda.get_device_name(0)
    print(f"torch: {torch.__version__} cuda {torch.version.cuda}; "
          f"device: {name}")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    libs = build.build_all(["mega_step", "psd_hist"], verbose=True)
    print(f"build (nvcc, in parallel): {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in libs.values())})")

    done = {}
    for phase, fn in (("k1", kernel_vs_twin), ("flags", kernel_vs_twin_flags),
                      ("hist", hist_phase),
                      ("f32", lambda d: main_path(d, torch.float32, 2,
                                                  False)),
                      ("science", science_path),
                      ("electrons32", electron_path_f32),
                      ("sed", sed_path),
                      ("electrons", electron_path),
                      ("f64", lambda d: main_path(d, torch.float64, 1, True)),
                      ("shipped", shipped_path)):
        t0 = time.perf_counter()
        done[phase] = fn(dev)
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernel_records(done)}))
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_records(done) -> list:
    """The kernels line: every kernel with its main-path launches (K1 on
    the flagship f32, science, electrons32 and sed paths, K2 on the f64
    flagship, shipped and electron paths), its error against its plain version,
    its time, its plain version's, its bound and the library call's."""
    src = "montecarloscattering_jl_tpu_torch/csrc/"
    hp, k1 = done["hist"], done["k1"]
    k2, k3, k4 = (hp["K2 (69,632 records)"], hp["K3 band=2048"],
                  hp["K4 = K2 (2^16 records)"])
    k1_launches = (done["f32"]["k1"] + done["science"]["counts"]["k1"]
                   + done["electrons32"]["counts"]["k1"]
                   + done["sed"]["counts"]["k1"])
    k2_launches = (done["f64"]["k2"] + done["shipped"]["counts"]["k2"]
                   + done["electrons"]["counts"]["k2"])
    rec = lambda r: dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"],
                         library_ms=r.get("library_ms"))
    return [
        {"name": "K1 mega_step", "route": "cuda",
         "source": src + "mega_step.cu",
         "replaces": "montecarloscattering_jl_tpu/ops/pallas_step.py:225",
         "launches": k1_launches, **rec(k1),
         "note": "timed on the flagship's 64-step window at 65,536 "
                 "lanes; no single PyTorch call computes a helix step"},
        {"name": "K2 psd_scatter", "route": "cuda",
         "source": src + "psd_hist.cu",
         "replaces": "montecarloscattering_jl_tpu/ops/pallas_hist.py:149",
         "launches": k2_launches, **rec(k2)},
        {"name": "K3 psd_scatter_band", "route": "cuda",
         "source": src + "psd_hist.cu",
         "replaces": "scripts/probe_hist.py:97",
         "launches": done["f64"]["k3"], **rec(k3),
         "note": "probe kernel, off the main path; timed at band 2,048; "
                 "its band filter has no single PyTorch call"},
        {"name": "K4 = K2 psd_scatter", "route": "cuda",
         "source": src + "psd_hist.cu",
         "replaces": "scripts/probe_hist.py:173",
         "launches": k2_launches, **rec(k4),
         "note": "runs K2's kernel at P4's 2^16 records"}]


if __name__ == "__main__":
    sys.exit(main())
