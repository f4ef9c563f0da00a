"""The port's emission pass against a plain photon reference
(benchmark/checks/electron_synch_ic.py, the electron SED cell's own
check, loaded by path: plain torch and NumPy, a per-zone loop written
from the upstream formulas), on the CPU at
float64.

Inputs are made with NumPy from a seed on examples/03's setup, with
coarser PSD bins: every zone's thermal and CR dN/dp of the protons and
of the electrons spanning 1e90 ... 1e134 (as a run's do) with empty
bins and an empty zone, the electrons' ISM-frame d2N cube, a B-field a
zone (one below the 1e-20 G floor) and random shells over the grid.

* ``photon_calcs`` with a torch device (the batched path a run takes)
  and with ``device=None`` (the per-zone NumPy oracle): every per-zone
  grid, every shell spectrum, the merged total and the photon axes
  within 1e-12 of the reference's, over each array's largest entry
  (the reference's own measure); the two differ by the rounding of
  hypot, exp, log and the summation order.  The grids' floors (1e-99 in
  a zone without particles) agree exactly.
* The electrons' ISM-frame d2N (the IC input), as the driver makes it
  from a PSD, within 1e-12 of the reference's plain per-zone version.
* The reference's synchrotron kernel table matches the port's
  (SciPy's K_5/3 there, its integral representation here).
* The cell's configuration (benchmark/configs/electron_synch_ic.toml)
  is examples/03 but for the three particle counts in its `reduced`.
* The port's dN/dp and photon writers (engine/io.py, a column at a
  time) write the bytes of the JAX package's (a row at a time) from the
  same spectra.
"""

import dataclasses
import filecmp
import importlib.util
import json
import os
import tomllib
import types

import numpy as np
import pytest
import torch

from montecarloscattering_jl_tpu.engine import io as jio
from montecarloscattering_jl_tpu_torch.engine import io as tio
from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
from montecarloscattering_jl_tpu_torch.models.emission import photon_calcs
from montecarloscattering_jl_tpu_torch.models.emission import synchrotron
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl
from montecarloscattering_jl_tpu_torch.utils import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "03_electron_synch_ic.toml")
COARSE = (("num-psd-bins-per-decade = [10, 5]",
           "num-psd-bins-per-decade = [5, 5]"),
          ("psd-linear-cosine-bins = 30", "psd-linear-cosine-bins = 10"),
          ("psd-log-theta-decs = 2", "psd-log-theta-decs = 1"))
GAP = 1e-12
ARRAYS = ("pion_grid", "synch_grid", "ic_grid", "pion_shell", "synch_shell",
          "ic_shell", "tot_shell", "tot", "e_pion", "e_synch", "e_ic",
          "e_tot")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "photon_reference",
        os.path.join(ROOT, "benchmark", "checks", "electron_synch_ic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@dataclasses.dataclass
class _Final:
    dndp_therm: np.ndarray
    dndp_cr: np.ndarray
    d2n_ef: np.ndarray | None


def _spectra(g, shape, empty_zone, zone_axis):
    a = 10.0 ** g.uniform(90.0, 134.0, shape)
    a[g.random(shape) < 0.2] = 0.0
    np.moveaxis(a, zone_axis, 0)[empty_zone] = 0.0
    return a


def _inputs(seed):
    """(setup, profile, ion_finals) drawn from `seed`."""
    g = np.random.default_rng(seed)
    setup = build_setup(wl.load_variant(EXAMPLE, COARSE))
    nb, bins = setup.nb, setup.bins
    n_p, n_t = bins.n_mom + 1, bins.n_theta + 1
    ends = np.sort(g.choice(np.arange(1, nb), size=5, replace=False))
    setup = dataclasses.replace(setup, n_shell_endpoints=ends)
    prof = setup.profile.copy()
    prof.btot = 10.0 ** g.uniform(-6.0, -2.0, nb)
    prof.btot[ends[0]] = 1e-21
    empty = int(ends[0]) + 1
    finals = []
    for i_ion, s in enumerate(setup.cfg.species):
        th, cr = (_spectra(g, (n_p, nb, 3), empty, 1) for _ in range(2))
        d2n = (_spectra(g, (n_p, n_t, nb), empty, 2) * 1e-13
               if s.is_electron else None)
        finals.append(_Final(th, cr, d2n))
    return setup, prof, finals


@pytest.fixture(scope="module", params=[11, 2**31 + 5, 2**40 + 3])
def drawn(request):
    setup, prof, finals = _inputs(request.param)
    want = REF.emission(setup, prof, finals, torch.float64, "cpu")
    return setup, prof, finals, want


@pytest.mark.parametrize("device", ["cpu", None], ids=["batched", "oracle"])
def test_photon_calcs_against_the_reference(drawn, device):
    setup, prof, finals, want = drawn
    em = photon_calcs(setup, prof, finals, device=device)
    for k in ARRAYS:
        got = getattr(em, k)
        assert got.shape == want[k].shape, k
        assert REF.gap(got, want[k]) <= GAP, (k, REF.gap(got, want[k]))
    for k in ("pion_grid", "synch_grid", "ic_grid"):
        floor = want[k] <= 1e-90
        assert floor.any() and not floor.all(), k
        assert np.array_equal(getattr(em, k)[floor], want[k][floor]), k


@pytest.mark.parametrize("writer", ["write_dndp", "write_photons"])
def test_writers_write_the_reference_bytes(drawn, writer, tmp_path):
    setup, prof, finals, _ = drawn
    em = photon_calcs(setup, prof, finals, device="cpu")
    finals = [dataclasses.replace(f, dndp_cr=f.dndp_cr.copy())
              for f in finals]
    # a NaN and an infinity where a spectrum could hold one
    finals[0].dndp_cr[3, 5, 1] = np.nan
    em.synch_grid[7, 40] = np.inf
    result = types.SimpleNamespace(setup=setup, iterations=[
        types.SimpleNamespace(ion_finals=finals, emission=em)])
    names = set()
    for tag, mod in (("port", tio), ("jax", jio)):
        os.makedirs(tmp_path / tag)
        getattr(mod, writer)(result, str(tmp_path / tag))
        names.add(tuple(sorted(os.listdir(tmp_path / tag))))
    (files,) = names
    assert len(files) == (2 if writer == "write_dndp" else 8)
    for name in files:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_d2n_ef_against_the_reference(seed):
    """The electrons' ISM-frame d2N the driver hands the IC pass (the
    device reduction's boost, times the zones' normalization) against
    the reference's plain per-zone version, on seeded PSDs with empty zones
    and zones that no particle crossed."""
    from montecarloscattering_jl_tpu_torch.ops import reduce as red

    g = np.random.default_rng(seed)
    setup = build_setup(wl.load_variant(EXAMPLE, COARSE))
    cfg, bins, prof, nb = setup.cfg, setup.bins, setup.profile, setup.nb
    s = cfg.species[-1]
    shape = (bins.n_mom + 1, bins.n_theta + 1, nb)
    psd, therm = (g.uniform(0.0, 5.0, shape) * (g.random(shape) < 0.3)
                  for _ in range(2))
    psd[:, :, 7] = therm[:, :, 7] = 0.0
    crossings = g.integers(0, 3, nb)
    pop, _ = red.zone_populations(
        setup.x_grid_cm, setup.i_shock, s.number_density, cfg.beta0,
        cfg.gamma0, cfg.jet_rad_pc, cfg.jet_sph_frac, prof.ux_sk,
        prof.gamma_sf)
    d2n = red.ion_reduce_device(
        torch.from_numpy(psd), torch.from_numpy(therm), bins, s.rest_energy,
        prof.gamma_sf, prof.ux_sk, cfg.gamma0, want_ef=True)[3]
    got = d2n * red.ef_zone_norm(psd, therm, pop, crossings,
                                 s.number_density)[None, None, :]
    fi = types.SimpleNamespace(psd=psd, therm_psd=therm,
                               num_crossings=crossings)
    want = REF.d2n_ef(setup, prof, fi, s)
    assert (want > 0).sum() > 100 and (crossings == 0).any()
    assert REF.gap(got, want) <= GAP, REF.gap(got, want)
    # one misbinned cell reads
    got[3, 2, 11] += want.max()
    assert REF.gap(got, want) >= 0.5


def test_synchrotron_table_matches_the_port():
    lx, lf = REF.f_table()
    px, pf = synchrotron._f_table()
    assert np.array_equal(lx, px)
    assert np.abs(lf - pf).max() < 1e-13


def test_benchmark_config_is_examples_03_at_its_size():
    """The cell's configuration loads, and differs from examples/03 only
    in the three particle counts its `reduced` lists."""
    base = os.path.join(ROOT, "benchmark", "configs", "electron_synch_ic")
    with open(base + ".toml", "rb") as f:
        cell = tomllib.load(f)
    with open(EXAMPLE, "rb") as f:
        shipped = tomllib.load(f)
    with open(base + ".json") as f:
        reduced = json.load(f)["reduced"]
    assert sorted(reduced) == ["N_PTS_INJ", "N_PTS_PCUT", "N_PTS_PCUT_HI"]
    assert set(cell) == set(shipped)
    differ = sorted(k for k in cell if repr(cell[k]) != repr(shipped[k]))
    assert differ == sorted(reduced)
    assert all(cell[k] == 65536 for k in reduced)
    cfg = load_config(base + ".toml")
    assert (cfg.n_pts_inj, cfg.n_pts_pcut, cfg.n_pts_pcut_hi) == (65536,) * 3
