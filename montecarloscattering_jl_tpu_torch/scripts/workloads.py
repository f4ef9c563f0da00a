"""The populations, config variants and timers that chip_smoke.py, the
probes (scripts/probe_*.py) and the tests share.

* ``flagship_case``: tests/data/dsa_nonrel.toml's injected population at
  pcut index 2 (bench.py's drain population) with K1's tables and a maker
  of fresh tallies.
* ``flag_case``: one of FLAG_CASES on configs/baseline.toml (electron
  density 1): lanes placed to reach every static-flag branch of K1
  (``flag_population``), the tables and the tallies.
  ``helix_flag_case``: the same lanes in a momentum dtype with the XLA
  engine's tables, for K5.
* ``load_variant`` / ``science_variant``: a config with edits, and the
  science runs' switches (scripts/flagship_baseline.py --dsa
  --pcuts-per-decade 4 --max-helix-steps 200000 --n-pts-mult 4).
* ``time_launches`` (CUDA events around prepared launches) and
  ``timed_drain`` (host clock around one ``mega.drain``).
* ``kill_at``: the stop hook of the kill-and-resume checks, armed at a
  chosen segment boundary.

Only the package's public engine and ops entry points are used, and they
are imported inside the functions: a probe that measures another
checkout of the port loads this file by path and gets that checkout's
package.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CFG = os.path.join(ROOT, "tests", "data", "dsa_nonrel.toml")
BASELINE = os.path.join(ROOT, "configs", "baseline.toml")
LANES = 65_536
# the science variant
SCIENCE_PCUTS_PER_DECADE = 4
SCIENCE_CAP = 200_000
SCIENCE_PTS_MULT = 4
# flag_case: the electrons' flat received-energy pool [erg per zone], and
# the top of their momentum range [log10 m c], where the radiative loss
# of a step exceeds a float32 ulp of the momentum
RECV_PER_ZONE = 3.0e-7
E_TOP = 9.0
# the custom f(r_g) law of the frg cases: alpha and the reference radius
# in r_g0 (tests/test_switches.py)
FRG_ALPHA, FRG_RG0_RG = 1.5, 2.0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def flagship_population(setup, cfg, dev, lanes: int = LANES, **state_kw):
    """bench.py's drain population: the injected distribution tiled to
    `lanes` lanes, keyed from seed 0 (`state_kw` to ``init_state``)."""
    import numpy as np

    from montecarloscattering_jl_tpu_torch.models.injection import init_pop
    from montecarloscattering_jl_tpu_torch.ops import rng, state as stt

    prof = setup.profile
    pop = init_pop(np.random.default_rng(0), cfg.species, 0, 1,
                   cfg.energy_inj, True, cfg.n_pts_inj, setup.x_grid_start,
                   cfg.rg0, 1.0, True, -1.0, cfg.beta0, cfg.gamma0, cfg.u0,
                   setup.x_grid_rg, prof.ux_sk, prof.gamma_sf)
    reps = lanes // len(pop.ptot_pf) + 1
    t = lambda a: np.tile(a, reps)[:lanes]
    return stt.init_state(
        t(pop.weight), t(pop.ptot_pf), t(pop.pb_pf), t(pop.x_cm),
        t(pop.i_grid).astype(np.int32), t(prof.ux_sk[pop.i_grid]),
        cfg.xn_per_fine, setup.x_grid_stop, rng.key(0), dev, **state_kw)


def flagship_case(dev, lanes: int = LANES) -> dict:
    """The flagship population on `dev` with K1's tables at pcut index 2
    and a maker of fresh tallies."""
    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import mega, state as stt
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(CFG)
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=dev)
    ss = eng.step_static(0)
    mega.check_supported(ss)
    tabs = mega.mega_tables(eng.segment_grids(setup.profile),
                            eng.segment_scalars(0, 2, setup.profile.bmag2),
                            ss, dev)
    b = setup.bins
    return dict(tabs=tabs, st0=flagship_population(setup, cfg, dev, lanes),
                fresh_tal=lambda: stt.make_tallies(setup.nb, b.n_mom,
                                                   b.n_theta, dev))


def flag_population(cfg, setup, i_ion, dev, lanes: int = LANES, seed=0,
                    p_dtype=None):
    """`lanes` lanes that reach every flag branch within one window, as
    tests/torch_flag_cases.py places them: a quarter upstream within
    0.01 r_g0 (times the species' mass over the protons') of the shock
    moving with the flow (pool donation or
    receipt on the crossing), a quarter within 1e-4 r_g0 downstream
    moving upstream at 3 m c (the no-DSA reflection), half beyond the
    grid end (custom eps_B) with the PRP 1 to 3% ahead (the retro walk)
    at 3-30 m c (electrons up to 10^E_TOP m c).  Acceleration times sit
    around a tcut, an eighth past the age limit; the last step size is a
    fine step in the lane's zone.  Momenta in `p_dtype` (float32 when
    None).  Returns the state and the largest momentum."""
    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.ops import rng, state as stt
    from montecarloscattering_jl_tpu_torch.utils import constants as K

    p_dtype = p_dtype or torch.float32
    g = np.random.default_rng(seed)
    s = cfg.species[i_ion]
    mc = s.mass * K.C_CGS
    prof = setup.profile
    n = lanes // 4
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
    slot = g.integers(0, len(tc) - 1, lanes)
    acct = tc[slot] * g.uniform(0.3, 1.2, lanes)
    acct[-n // 2:] = 1.1 * cfg.age_max
    dw = x > 0.0
    st = stt.init_state(
        np.ones(lanes), ptot, ptot * mu, x, ig, prof.ux_sk[ig],
        cfg.xn_per_fine, x_stop, rng.key(seed), dev, downstream=dw,
        inj=dw & (x > x_stop), acctime=acct, tcut=slot.astype(np.int32),
        p_dtype=p_dtype)
    prp = np.where(x > x_stop, x * g.uniform(1.01, 1.03, lanes), x_stop)
    gamma = np.hypot(ptot / mc, 1.0)
    t_step = (2.0 * np.pi * gamma * mc / (abs(s.charge) * prof.btot[ig])
              / cfg.xn_per_fine)
    st.prp_x = torch.from_numpy(prp).to(dev)
    st.t_step = torch.from_numpy(t_step).to(dev, p_dtype)
    return st, float(ptot.max())


def load_variant(path: str, replace=(), **fields):
    """A config file with text replacements, loaded through a temporary
    copy, then with `fields` set on the RunConfig."""
    from montecarloscattering_jl_tpu_torch.utils import load_config

    text = open(path).read()
    for old, new in replace:
        if old not in text:
            raise RuntimeError(f"{path}: {old!r} not found")
        text = text.replace(old, new)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, os.path.basename(path))
        with open(p, "w") as f:
            f.write(text)
        cfg = load_config(p)
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def science_variant(cfg, dsa: bool = True,
                    pcuts_per_decade: int = SCIENCE_PCUTS_PER_DECADE,
                    n_pts_mult: int = SCIENCE_PTS_MULT) -> None:
    """The science runs' switches, in place (scripts/flagship_baseline.py
    --dsa --pcuts-per-decade --n-pts-mult): with `dsa` scattering, DSA
    and smoothing on; with `pcuts_per_decade` > 0 the geometric pcut
    ladder; the particle counts times `n_pts_mult`.  The defaults are the
    science variant's."""
    from montecarloscattering_jl_tpu_torch.utils.config import (
        auto_pcut_ladder, check_pcuts)

    if dsa:
        cfg.dont_scatter = cfg.dont_dsa = False
        cfg.do_smoothing = True
    if pcuts_per_decade:
        cfg.pcuts = auto_pcut_ladder(cfg.pcuts[0], pcuts_per_decade,
                                     cfg.emax, cfg.emax_per_aa, cfg.pmax)
        check_pcuts(cfg.pcuts, cfg.emax, cfg.emax_per_aa, cfg.pmax)
    if n_pts_mult > 1:
        cfg.n_pts_inj *= n_pts_mult
        cfg.n_pts_pcut *= n_pts_mult
        cfg.n_pts_pcut_hi *= n_pts_mult


@contextlib.contextmanager
def helix_cap(cap: int):
    """Within the block both engines stop a lane after `cap` helix steps
    a segment (the MCS_MAX_HELIX_STEPS of a fresh process)."""
    from montecarloscattering_jl_tpu_torch.ops import mega
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    caps = (mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS)
    mega.MAX_HELIX_STEPS = xla_step.MAX_HELIX_STEPS = cap
    try:
        yield
    finally:
        mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS = caps


@contextlib.contextmanager
def timed_drains():
    """Within the block every ``mega.drain`` is timed on the host clock,
    a synchronize before and after it (so measurement runs only): yields
    the list of (ms, K1 launches, pushes) of the drains."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import mega

    out = []
    base = mega.drain

    def drain(st, tabs, tal, *a, **kw):
        sync = st.device.type == "cuda"
        if sync:
            torch.cuda.synchronize()
        n0, k0 = st.nsteps.long().sum(), mega.LAUNCHES
        t0 = time.perf_counter()
        r = base(st, tabs, tal, *a, **kw)
        if sync:
            torch.cuda.synchronize()
        out.append(((time.perf_counter() - t0) * 1e3, mega.LAUNCHES - k0,
                    int(st.nsteps.long().sum() - n0)))
        return r

    mega.drain = drain
    try:
        yield out
    finally:
        mega.drain = base


# (tag, species, science switches, flags that must be on, alpha of the
# custom f(r_g) law or None, the word of the K1 instance that must run
# it: ops/mega.py INSTANCES; 120 = retro | tcuts | energy transfer |
# custom eps_B, +128 the f(r_g) law, +256 + 4 electrons with radiative
# losses, -1 the instance that reads the flags at run time)
_PROTON_FLAGS = ("do_tcuts", "do_retro", "use_custom_eps_b",
                 "do_energy_transfer")
_ELECTRON_FLAGS = ("do_rad_losses",) + _PROTON_FLAGS
FLAG_CASES = (("protons", 0, True, _PROTON_FLAGS, None, 120),
              ("electrons", 1, True, _ELECTRON_FLAGS, None, 380),
              ("protons-shipped", 0, False, ("dont_scatter", "dont_dsa",
                                             "do_tcuts", "do_retro"), None,
               -1),
              ("protons-frg", 0, True, _PROTON_FLAGS, FRG_ALPHA, 248),
              ("electrons-frg", 1, True, _ELECTRON_FLAGS, FRG_ALPHA, 508),
              ("protons-frg-alpha1", 0, True, _PROTON_FLAGS, 1.0, 248))


def flag_case(case, dev, lanes: int = LANES) -> dict:
    """One of FLAG_CASES set up on `dev`: the baseline (electron density
    1) with the case's switches, flag_population's lanes of its species,
    K1's tables at a pcut above every lane, and a maker of fresh
    tallies."""
    from montecarloscattering_jl_tpu_torch.ops import mega

    c = _flag_setup(case, dev, lanes, None)
    tag, _, _, _, frg_alpha, _ = case
    mega.check_supported(c["ss"])
    tabs = mega.mega_tables(c["grids"], c["sc"], c["ss"], dev)
    if bool(tabs.flags & mega.FLAG_CUSTOM_FRG) != (frg_alpha is not None):
        raise RuntimeError(f"flags {tag}: the f(r_g) bit is "
                           f"{tabs.flags:#x}")
    return dict(c, tabs=tabs)


def helix_flag_case(case, dev, lanes: int = LANES, p_dtype=None) -> dict:
    """One of FLAG_CASES as flag_case sets it up, with momenta in
    `p_dtype` (float64 when None) and the XLA engine's tables (`tb`,
    ops/step.py step_tables), for K5."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    c = _flag_setup(case, dev, lanes, p_dtype or torch.float64)
    return dict(c, tb=xla_step.step_tables(c["grids"], c["sc"], c["ss"],
                                           dev))


def _flag_setup(case, dev, lanes: int, p_dtype) -> dict:
    """flag_case's grids, scalars, StepStatic, lanes (momenta in
    `p_dtype`, float32 when None; the grids in `p_dtype`, float64 when
    None) and a maker of fresh tallies."""
    import numpy as np

    from montecarloscattering_jl_tpu_torch.engine.run import (
        TransportEngine, populate_eps_target)
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import state as stt

    tag, i_ion, science, want, frg_alpha, _ = case
    cfg = load_variant(BASELINE, replace=[("DENZ_ION = [1.0, 0.0]",
                                           "DENZ_ION = [1.0, 1.0]")])
    if science:
        science_variant(cfg)
    if frg_alpha is not None:
        cfg.use_custom_frg = True
        cfg.frg_alpha, cfg.frg_rg0_rg = frg_alpha, FRG_RG0_RG
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=dev,
                          **({} if p_dtype is None else dict(p_dtype=p_dtype)))
    prof = setup.profile
    eps = populate_eps_target(cfg.energy_transfer_frac, cfg.u0,
                              cfg.gamma0, setup.u2, setup.gamma2, prof)
    grids = eng.segment_grids(prof, eps_target=eps,
                              recv_pool=np.full(setup.nb, RECV_PER_ZONE))
    st0, p_top = flag_population(cfg, setup, i_ion, dev, lanes,
                                 p_dtype=p_dtype)
    # a pcut above every lane: the window saves none of them
    i_pcut = next(i for i, p in enumerate(cfg.pcuts) if p > 2.0 * p_top)
    sc = eng.segment_scalars(i_ion, i_pcut, prof.bmag2)
    ss = eng.step_static(i_ion)
    off = [f for f in want if not getattr(ss, f)]
    if off:
        raise RuntimeError(f"flags {tag}: {off} are off in the config")
    b = setup.bins
    fresh_tal = lambda: stt.make_tallies(
        setup.nb, b.n_mom, b.n_theta, dev, n_tcut_slots=eng.n_tcut_slots)
    return dict(st0=st0, fresh_tal=fresh_tal, grids=grids, sc=sc, ss=ss)


def clone_state(st):
    from montecarloscattering_jl_tpu_torch.ops import state as stt

    return stt.clone(st)


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


def timed_drain(case: dict, cap: int) -> dict:
    """One full drain of a case's population through ``mega.drain`` at
    the helix cap `cap`: wall ms (ending in a synchronize), K1 launches,
    pushes and pushes/s."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import mega

    st0 = case["st0"]
    s, t = clone_state(st0), case["fresh_tal"]()
    before = mega.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mega.drain(s, case["tabs"], t, max_helix=cap)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    left = int((s.status == 0).sum())
    if left:
        raise RuntimeError(f"{left} lanes ACTIVE after the drain")
    pushes = int((s.nsteps.long() - st0.nsteps.long()).sum())
    return dict(ms=ms, launches=mega.LAUNCHES - before, pushes=pushes,
                pushes_per_s=pushes / ms * 1e3)


@contextlib.contextmanager
def kill_at(i_iter: int, i_ion: int | None = None,
            next_seg: int | None = None):
    """Within the block, every MidCheckpointer the driver makes stops
    the run (MidCheckpointStop) right after its first save at iteration
    `i_iter` (0-based), and at species `i_ion` and segment boundary
    `next_seg` where given: a kill at a chosen segment boundary.  Yields
    the list of the checkpointers made, for their save times."""
    from montecarloscattering_jl_tpu_torch.parallel import checkpoint as ck

    made = []
    base = ck.MidCheckpointer

    class KillAt(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def maybe(self, seg_done, payload_fn):
            def armed():
                p = payload_fn()
                self.stop_after_save = (
                    p["i_iter"] == i_iter
                    and i_ion in (None, p["i_ion"])
                    and next_seg in (None, p["next_seg"]))
                return p
            super().maybe(seg_done, armed)

    ck.MidCheckpointer = KillAt
    try:
        yield made
    finally:
        ck.MidCheckpointer = base
