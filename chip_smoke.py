#!/usr/bin/env python3
"""Smoke test of montecarloscattering_jl_tpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and builds every
   kernel of the port with nvcc for sm_90a, one nvcc per source, all
   started together: K1 (csrc/mega_step.cu) and K2/K3
   (csrc/psd_hist.cu).
2. Holds K1 against its plain PyTorch version (ops/mega.py step_twin) on
   the card, on the flagship population: tests/data/dsa_nonrel.toml,
   65,536 injected lanes at pcut index 2.  First one 64-step launch from
   the same state (per-lane fields), then a full drain with the helix
   cap lowered to 512 steps (status counts, step totals, tallies).
3. Holds K2 and K3 (ops/hist.py) against their plain versions on the
   card, through the histogram probe (scripts/probe_hist.py): K2 at the
   main path's shape (one record per lane of the 69,632-lane batch into
   the 4,428 x 102 PSD) and on the probe's 2^21 records, K3 at bands
   1,024 and 2,048, K2 at the probe's 2^16-record P4 shape; each timed
   beside its plain version and checked against float64.
4. Drives the K1 path: ``engine.driver.run`` on the flagship nonlinear
   config with float32 momenta (65,536 particles per pcut, smoothing
   on, 2 iterations), checks that every transport launch went through
   K1 and none through the twin, that the output files are written, and
   the test-particle power-law slope of iteration 1.
5. Drives the XLA-engine path, the JAX CLI's default: the same config
   with float64 momenta and two x_spec detectors at -/+0.5 r_g0, 1
   iteration; checks that every PSD deposit went through K2 (none
   through its plain version, no K1 launch), that the output files with
   mc_xspec.dat are written, that both detectors' spectra are positive,
   and the slope.

Every phase that fails raises, so the script exits non-zero; it also
exits non-zero without a CUDA device.  The line before the last is a
JSON summary of the kernels, the last line the device record.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "tests", "data", "dsa_nonrel.toml")
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


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def flagship_population(eng, setup, cfg, dev):
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


def clone_state(st):
    import dataclasses
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone()
        for f in dataclasses.fields(st)})


def compare_lanes(a, b) -> dict:
    """Per-lane differences between two states (K1 = a, twin = b)."""
    import torch
    out = {}
    same = torch.ones_like(a.status, dtype=torch.bool)
    for name in ("status", "reason", "nsteps", "flags"):
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


def kernel_vs_twin(dev) -> dict:
    import torch

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
    st0 = flagship_population(eng, setup, cfg, dev)
    b = setup.bins
    fresh_tal = lambda: stt.make_tallies(setup.nb, b.n_mom, b.n_theta, dev)

    # ---- one 64-step launch from the same state -------------------------
    s_k, t_k = clone_state(st0), fresh_tal()
    s_t, t_t = clone_state(st0), fresh_tal()
    torch.cuda.synchronize()
    mega.launch(s_k, tabs, t_k, WINDOW, 10_000)
    mega.step_twin(s_t, tabs, t_t, WINDOW, 10_000)
    torch.cuda.synchronize()
    lanes = compare_lanes(s_k, s_t)
    print("window per-lane:", json.dumps(lanes))
    if lanes["divergent_lanes"] > MAX_DIVERGENT * LANES:
        fail(f"window: {lanes['divergent_lanes']} lanes diverge")
    if lanes["float_lanes_over_bound"] > MAX_DIVERGENT * LANES:
        fail(f"window: {lanes['float_lanes_over_bound']} float fields "
             f"beyond {ULP_BOUND:.3g} relative")
    psd_err = float((t_k.psd_diff - t_t.psd_diff).abs().max())
    psd_tot = float(t_t.psd_diff.abs().sum())
    rel = abs(float(t_k.psd_diff.double().abs().sum()) - psd_tot) / psd_tot
    print(f"window psd: max_abs_err={psd_err:.6e} total |psd| "
          f"rel_err={rel:.3e}")
    if rel > TALLY_RTOL:
        fail(f"window psd totals differ by {rel:.3e}")
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
    print(f"window {WINDOW} steps x {LANES} lanes ({pushes_w} pushes): "
          f"K1 {k1a:.4f} / {k1b:.4f} ms ({pushes_w / k1_ms / 1e3:.1f} "
          f"M pushes/s), twin {tw1:.2f} / {tw2:.2f} ms "
          f"({pushes_w / tw_ms / 1e3:.3f} M pushes/s)")

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
    nk, nt = int(sk.nsteps.sum()), int(stw.nsteps.sum())
    div = compare_lanes(sk, stw)["divergent_lanes"]
    print(f"drain status K1 {ck} twin {ct}; nsteps K1 {nk} twin {nt}; "
          f"divergent lanes {div}")
    if div > MAX_DIVERGENT * LANES:
        fail(f"drain: {div} lanes diverge")
    if any(abs(x - y) > div for x, y in zip(ck, ct)):
        fail("drain status counts differ beyond the divergent lanes")
    if abs(nk - nt) > div * DRAIN_CAP:
        fail("drain step totals differ beyond the divergent lanes")
    for name in ("psd", "therm_psd", "pxx_flux", "pxz_flux", "energy_flux",
                 "num_crossings", "px_esc_up", "en_esc_up", "sum_p_dw",
                 "sum_ke_dw"):
        a = float(getattr(fk, name).double().sum())
        c = float(getattr(ftw, name).double().sum())
        if abs(a - c) > TALLY_RTOL * max(abs(c), 1e-300) and (a or c):
            fail(f"drain {name}: K1 {a!r} twin {c!r}")
    print(f"drain to {DRAIN_CAP}-step cap: K1 {dk:.3f} s "
          f"({nk / dk / 1e6:.2f} M pushes/s), twin {dtw:.3f} s "
          f"({nt / dtw / 1e6:.3f} M pushes/s)")
    return dict(max_abs_err=psd_err, ms=k1_ms, plain_ms=tw_ms)


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


def main_path(dev, p_dtype, n_itrs: int, x_spec: bool) -> dict:
    """One driven run of the flagship config; counts of every kernel's
    launches set to 0 just before it and read just after."""
    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.ops import hist, mega
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(CFG)
    cfg.n_itrs = n_itrs
    cfg.do_smoothing = True
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = LANES
    if x_spec:
        cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    tag = f"{str(p_dtype).replace('torch.', '')} path"
    with tempfile.TemporaryDirectory() as out:
        mega.LAUNCHES = mega.TWIN_CALLS = 0
        hist.LAUNCHES = hist.BAND_LAUNCHES = hist.PLAIN_CALLS = 0
        t0 = time.perf_counter()
        res = run(cfg, device=dev, out_dir=out, p_dtype=p_dtype)
        wall = time.perf_counter() - t0
        counts = dict(k1=mega.LAUNCHES, twin=mega.TWIN_CALLS,
                      k2=hist.LAUNCHES, k3=hist.BAND_LAUNCHES,
                      hist_plain=hist.PLAIN_CALLS)
        written = sorted(os.listdir(out))
    phases = {k: round(v, 3) for k, v in res.timers.totals.items()}
    print(f"{tag}: {len(res.iterations)} iterations, "
          f"{res.n_trajectories} trajectories, {res.n_pushes} pushes in "
          f"{wall:.2f} s ({res.n_pushes / wall / 1e6:.2f} M pushes/s); "
          f"launches {json.dumps(counts)}; phases {json.dumps(phases)}")
    if p_dtype == torch.float32:
        if counts["k1"] <= 0 or counts["twin"] != 0:
            fail(f"{tag}: {counts} (every drain must launch K1)")
    elif (counts["k2"] <= 0 or counts["hist_plain"] != 0
          or counts["k1"] != 0 or counts["twin"] != 0):
        fail(f"{tag}: {counts} (every deposit must launch K2, no K1)")
    missing = [f for f in expected_files(cfg) if f not in written]
    if missing:
        fail(f"{tag}: output files missing: {missing} (got {written})")
    slope, expect = slope_of(res)
    print(f"{tag}: iteration 1 downstream slope {slope:.4f} (expected "
          f"{expect:.4f} +- 0.45)")
    if not math.isfinite(slope) or abs(slope - expect) > 0.45:
        fail(f"{tag}: slope {slope} vs {expect}")
    for itr in res.iterations:
        for f in itr.ion_finals:
            if not (np.isfinite(f.dndp_cr).all()
                    and np.isfinite(f.p_psd_par).all()):
                fail(f"{tag}: non-finite reductions")
    if x_spec:
        fi = res.iterations[0].ion_finals[0]
        tot = [(float(fi.spectra_sf[:, i].sum()),
                float(fi.spectra_pf[:, i].sum())) for i in range(2)]
        print(f"{tag}: detector spectra totals (sf, pf) {tot}")
        if not all(a > 0 and b > 0 and math.isfinite(a + b)
                   for a, b in tot):
            fail(f"{tag}: detector spectra {tot}")
    return counts


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

    k1 = kernel_vs_twin(dev)
    hp = hist_phase(dev)
    c32 = main_path(dev, torch.float32, n_itrs=2, x_spec=False)
    c64 = main_path(dev, torch.float64, n_itrs=1, x_spec=True)
    src = "montecarloscattering_jl_tpu_torch/csrc/"
    k2, k3, k4 = (hp["K2 (69,632 records)"], hp["K3 band=2048"],
                  hp["K4 = K2 (2^16 records)"])
    print(json.dumps({"kernels": [
        {"name": "K1 mega_step", "route": "cuda",
         "source": src + "mega_step.cu",
         "replaces": "montecarloscattering_jl_tpu/ops/pallas_step.py:225",
         "launches": c32["k1"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "K2 psd_scatter", "route": "cuda",
         "source": src + "psd_hist.cu",
         "replaces": "montecarloscattering_jl_tpu/ops/pallas_hist.py:149",
         "launches": c64["k2"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
        {"name": "K3 psd_scatter_band", "route": "cuda",
         "source": src + "psd_hist.cu",
         "replaces": "scripts/probe_hist.py:97",
         "launches": c64["k3"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "note": "probe kernel, off the main path; timed at band 2,048"},
        {"name": "K4 = K2 psd_scatter", "route": "cuda",
         "source": src + "psd_hist.cu",
         "replaces": "scripts/probe_hist.py:173",
         "launches": c64["k2"], "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "note": "runs K2's kernel at P4's 2^16 records"}]}))
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
