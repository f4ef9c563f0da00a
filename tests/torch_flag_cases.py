"""Shared inputs of the static-flag parity tests (test_torch_step_flags.py,
test_torch_mega_flags.py): configs/baseline.toml with the electrons'
density set to 1, a lane population that reaches every flag branch
within a few steps, and the StepStatic of each case.

The population (``population``) has four groups of LANES / 4: upstream
within 100 `near` r_g0 of the shock (times the species' mass over the
first species'), moving with the flow (energy transfer on the
crossing); just downstream, within `near` r_g0 (the
downstream field is ~1e3 times the upstream one), moving
upstream at 3 m c (the no-DSA reflection); two groups beyond the grid
end (custom eps_B) with the PRP 1 to 3% ahead (the retro walk), moving
on at 3-30 m c (electrons up to 10^e_top m c, where their radiative
loss shows in the momentum dtype; their first three groups lie below
pe_crit, the fast ones above it, so the custom f(r_g) law sees both of
its electron regimes).
Acceleration times sit around a tcut, an eighth of them past the age
limit; the last step size is a fine step in the lane's zone.  The
electrons' received-energy pool is a flat RECV_PER_ZONE.
"""

import dataclasses
import re

import numpy as np

import jax

from montecarloscattering_jl_tpu.engine.run import (
    TransportEngine, populate_eps_target)
from montecarloscattering_jl_tpu.engine.setup import build_setup
from montecarloscattering_jl_tpu.ops import state as jst
from montecarloscattering_jl_tpu.utils import load_config
from montecarloscattering_jl_tpu_torch.utils import constants as K

CFG = "configs/baseline.toml"
LANES = 512
FLAGS = ("dont_scatter", "dont_dsa", "do_rad_losses", "do_retro",
         "do_tcuts", "do_energy_transfer", "use_custom_eps_b")
# each flag on its own for the species whose lanes reach it, and all of
# them together for both species
CASES = [("dont_scatter", "ion"), ("dont_dsa", "ion"),
         ("do_rad_losses", "electron"), ("do_retro", "ion"),
         ("do_tcuts", "ion"), ("do_energy_transfer", "ion"),
         ("do_energy_transfer", "electron"), ("use_custom_eps_b", "ion"),
         ("all", "ion"), ("all", "electron"),
         ("frg", "ion"), ("frg", "electron"),
         ("frg_alpha1", "ion"), ("frg_alpha1", "electron")]
# the custom f(r_g) law's cases: alpha and the reference radius in r_g0
# (tests/test_switches.py); alpha = 1 is the standard law
FRG = {"frg": (1.5, 2.0), "frg_alpha1": (1.0, 2.0)}
IDS = [f"{f}-{s}" for f, s in CASES]
RECV_PER_ZONE = 3.0e-7     # erg
I_PCUT = 11                # pcut 1000 m_p c: above every lane


def build(tmp_dir, p_dtype):
    """(cfg, setup, engine, grids) of the JAX package for the baseline
    with electron density 1, grids carrying eps_target and the flat
    received pool."""
    text = open(CFG).read()
    text = re.sub(r"DENZ_ION = \[1\.0, 0\.0\]", "DENZ_ION = [1.0, 1.0]", text)
    path = tmp_dir / "baseline_e.toml"
    path.write_text(text)
    cfg = load_config(str(path))
    setup = build_setup(cfg)
    eng = TransportEngine(setup, p_dtype=p_dtype)
    prof = setup.profile
    eps = populate_eps_target(cfg.energy_transfer_frac, cfg.u0, cfg.gamma0,
                              setup.u2, setup.gamma2, prof)
    grids = eng.segment_grids(prof, eps_target=eps,
                              recv_pool=np.full(setup.nb, RECV_PER_ZONE))
    return cfg, setup, eng, grids


def population(cfg, setup, i_ion, p_dtype, e_top=6.0, near=1.0e-3,
               lanes=LANES, seed=0):
    """The JAX ParticleState of the four groups (module docstring), the
    second group within `near` r_g0 downstream of the shock."""
    g = np.random.default_rng(seed)
    s = cfg.species[i_ion]
    mc = s.mass * K.C_CGS
    prof = setup.profile
    n = lanes // 4
    rg0, x_stop = cfg.rg0, setup.x_grid_stop
    x = np.concatenate([
        -100.0 * near * rg0 * (s.mass / cfg.species[0].mass)
        * g.random(n),
        near * rg0 * g.random(n),
        x_stop * (1.0 + 0.5 * g.random(2 * n))])
    ptot = np.concatenate([
        0.05 * mc * (1.0 + g.random(n)),
        3.0 * mc * np.ones(n),
        mc * 10.0 ** g.uniform(0.5, e_top if s.is_electron else 1.5,
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
    state = jst.init_state(
        np.ones(lanes), ptot, ptot * mu, x, ig, prof.ux_sk[ig],
        cfg.xn_per_fine, x_stop, jax.random.key(seed),
        downstream=dw, inj=dw & (x > x_stop), acctime=acct,
        tcut=slot.astype(np.int32), p_dtype=p_dtype)
    prp = np.where(x > x_stop, x * g.uniform(1.01, 1.03, lanes), x_stop)
    # mid-segment lanes: the last step was a fine one in the lane's zone
    gamma = np.hypot(ptot / mc, 1.0)
    t_step = (2.0 * np.pi * gamma * mc / (abs(s.charge) * prof.btot[ig])
              / cfg.xn_per_fine)
    return state._replace(prp_x=jax.numpy.asarray(prp),
                          t_step=jax.numpy.asarray(t_step, p_dtype))


def static(eng, i_ion, flag):
    """The config's StepStatic with `flag` on (every flag for "all",
    none for "none", the custom f(r_g) law for a key of FRG) and the
    other static flags off."""
    on = {f: flag == "all" or f == flag for f in FLAGS}
    if flag in FRG:
        alpha, rg0_rg = FRG[flag]
        on.update(frg_alpha=alpha, frg_rg0_cm=rg0_rg * eng.setup.cfg.rg0)
    return dataclasses.replace(eng.step_static(i_ion), **on)


def np_tree(nt):
    """A JAX NamedTuple's fields as NumPy arrays (the key as its data)."""
    d = {k: np.asarray(v) for k, v in nt._asdict().items() if k != "key"}
    if "key" in nt._fields:
        d["key"] = np.asarray(jax.random.key_data(nt.key))
    return d
