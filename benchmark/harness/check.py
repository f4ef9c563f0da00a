"""The comparison that decides ``correct``.

It judges the last run of the window, the run whose files are on disk,
once the window has closed and the device's peak has been read.  Each
number compared has its limit, by the momentum precision of the cell
(``LIMITS``; PERF.md gives the readings each was set from):

* the transport (harness/lanes.py), on one drain of the run drawn from
  the seed, every lane of its batch pushed again by the plain step to
  its end: ``lanes_diverged``, the share of the lanes that were ACTIVE
  at its start whose end state differs; ``psd_gap`` and ``flux_gap``,
  the drain's PSD and flux deposits against the plain step's (L1 over
  L1, per boundary); ``esc_gap``, its escape sums and retro entries;
* ``split_off``: one pcut split of the run drawn from the seed, made
  again by the plain split from the lanes it was handed: the share of
  the lanes on which any field differs (exact);
* ``pushes_gap`` and ``exits_gap``: the run's pushes and its exits by
  reason as the program counted them, against the lanes' own steps and
  end states after every drain (exact counts);
* ``smooth_gap``: every iteration's new shock profile against the plain
  smoothing (harness/smoothing.py), from the iteration's tallies;
* ``dndp_gap``: for every iteration and species of the run, the
  normalized dN/dp the program produced (thermal and CR, shock, plasma
  and ISM frames) against the plain reference's (harness/reference.py),
  worked out from the same iteration's phase-space tallies; the widest
  gap of an array, over its largest entry;
* ``file_gap``: the dN/dp files the run wrote
  (mc_dNdp_grid_{CR,therm}[_i].dat) against the reference's dN/dp of the
  iteration they hold: the widest gap of a log10 value, over the value's
  size (at least 1); missing where the files hold no row;
* ``idle_species``: the iterations and species of nonzero density in
  which the transport pushed nothing or tallied nothing (exact).

The reference follows the program stage by stage: the drawn drain from
the lanes and tables it was handed, the split from its lanes, dN/dp
and the smoothing from each iteration's tallies and shock profile.

A configuration may bring numbers of its own, for what the shared ones
cannot see (``checks/<configuration>.py``, found by harness/manifest.py:
its ``LIMITS`` and ``read``).  ``judge`` returns them after the shared
numbers, and a cell is judged against both tables of limits.  Their
names never repeat a shared number's (``manifest.problems`` refuses such
a file), so a configuration's check can add a judgement and never
override or loosen a shared one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import lanes
from . import reference as ref
from . import smoothing

# the reading of a file that is missing or has another shape
MISSING = 1.0e9
EXACT = {"split_off": 0, "pushes_gap": 0, "exits_gap": 0,
         "idle_species": 0}
LIMITS = {
    "float64": dict(EXACT, lanes_diverged=1.0e-4, psd_gap=1.0e-4,
                    flux_gap=1.0e-9, esc_gap=1.0e-9, smooth_gap=1.0e-10,
                    dndp_gap=1.0e-9, file_gap=2.0e-5),
    "float32": dict(EXACT, lanes_diverged=1.0e-4, psd_gap=1.0e-4,
                    flux_gap=1.0e-9, esc_gap=1.0e-9, smooth_gap=1.0e-10,
                    dndp_gap=1.0e-9, file_gap=2.0e-5),
}
C2 = ref.C_CGS ** 2


def _profile(result, i_iter: int):
    if i_iter == 0:
        return result.setup.profile
    return result.iterations[i_iter - 1].profile_after


def reference_dndp(result, i_iter: int, i_ion: int, dtype, device):
    """The reference's (thermal, CR) dN/dp of one iteration and species."""
    setup, cfg = result.setup, result.setup.cfg
    s = cfg.species[i_ion]
    fi = result.iterations[i_iter].ion_finals[i_ion]
    prof, bins = _profile(result, i_iter), setup.bins
    return ref.species_dndp(
        fi.psd, fi.therm_psd, e0=s.mass * C2, n0=s.number_density,
        gamma0=cfg.gamma0, beta0=cfg.beta0, gamma_sf=prof.gamma_sf,
        ux_sk=prof.ux_sk, x_grid_cm=setup.x_grid_cm, i_shock=setup.i_shock,
        jet_rad_pc=cfg.jet_rad_pc, jet_sph_frac=cfg.jet_sph_frac,
        mom_bounds_log=bins.mom_bounds_log, theta_bounds=bins.theta_bounds,
        n_theta=bins.n_theta, lin_cos_bins=bins.lin_cos_bins, dtype=dtype,
        device=device)


def gap(got, want) -> float:
    """The widest gap of `got` from `want` over each frame, over the
    frame's largest entry of `want` (absolute where that is 0)."""
    out = 0.0
    for f in range(want.shape[-1]):
        w = np.asarray(want[..., f], np.float64)
        g = np.asarray(got[..., f], np.float64)
        scale = np.abs(w).max()
        d = np.abs(g - w).max()
        if not (np.isfinite(d) and np.isfinite(scale)):
            return MISSING
        out = max(out, d / scale if scale > 0 else d)
    return float(out)


def dndp_file(out_dir: str, cfg, n_iters: int, kind: str):
    """(path, iteration index) of the dN/dp file of `kind` ('CR' or
    'therm') a run writes: one a iteration with separate-dNdp-write,
    else one that holds the first iteration's (engine/io.py
    write_dndp)."""
    if cfg.do_multi_dndps:
        return (os.path.join(out_dir, f"mc_dNdp_grid_{kind}_{n_iters}.dat"),
                n_iters - 1)
    return os.path.join(out_dir, f"mc_dNdp_grid_{kind}.dat"), 0


def read_dndp_file(path: str) -> dict:
    """{(zone, species index): [[sf, pf, ism] log10 rows]} of a dN/dp
    file."""
    rows = {}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) != 7 or line.startswith("#"):
                continue
            key = (int(tok[0]), int(tok[1]) - 1)
            rows.setdefault(key, []).append([float(v) for v in tok[4:]])
    return rows


def file_gap(rows: dict, by_ion: dict) -> float:
    """The widest gap of a file's log10 dN/dp rows from the reference's
    dN/dp of each species (`by_ion`), over the value's size (at least
    1); 0 for a file without rows."""
    out = 0.0
    for (zone, i_ion), vals in rows.items():
        want = np.log10(np.maximum(by_ion[i_ion][:, zone, :], 1e-99))
        got = np.asarray(vals)
        if got.shape != want.shape:
            return MISSING
        d = float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())
        if not np.isfinite(d):
            return MISSING
        out = max(out, d)
    return out


def readings(result, out_dir: str, device, program=None) -> dict:
    """The numbers compared, for the run `result` whose files are in
    `out_dir`.  `program(i_iter, i_ion)` gives the (thermal, CR) dN/dp
    judged; by default the program's own (IonFinal.dndp_therm,
    dndp_cr).  The control puts the reference at a lower precision in
    its place."""
    cfg = result.setup.cfg
    n = len(result.iterations)
    files = {kind: dndp_file(out_dir, cfg, n, kind)
             for kind in ("CR", "therm")}
    worst, idle, in_file = 0.0, 0, {"CR": {}, "therm": {}}
    for i_iter, itr in enumerate(result.iterations):
        for i_ion, fi in enumerate(itr.ion_finals):
            if cfg.species[i_ion].number_density > 0 and not (
                    fi.n_pushes > 0 and fi.psd.sum() + fi.therm_psd.sum()
                    > 0):
                idle += 1
            th, cr = reference_dndp(result, i_iter, i_ion, torch.float64,
                                    device)
            if program is None:
                got_th, got_cr = fi.dndp_therm, fi.dndp_cr
            else:
                got_th, got_cr = program(i_iter, i_ion)
            worst = max(worst, gap(got_th, th), gap(got_cr, cr))
            for kind, want in (("CR", cr), ("therm", th)):
                if i_iter == files[kind][1]:
                    in_file[kind][i_ion] = want
    f_gap, n_rows = 0.0, 0
    for kind, (path, _) in files.items():
        if not os.path.exists(path):
            f_gap = MISSING
            continue
        rows = read_dndp_file(path)
        n_rows += len(rows)
        f_gap = max(f_gap, file_gap(rows, in_file[kind]))
    return {"dndp_gap": worst, "file_gap": f_gap if n_rows else MISSING,
            "idle_species": idle}


def control(result, dtype, device):
    """`program` for ``readings`` that puts the reference, computed in
    `dtype`, in the program's place."""
    return lambda i_iter, i_ion: reference_dndp(result, i_iter, i_ion,
                                                dtype, device)


def cell_limits(cell: dict) -> dict:
    """The limits a cell (manifest.cell) is judged by: the shared
    numbers' at its precision, then its configuration's own."""
    p_dtype, own = cell["traffic"]["p_dtype"], cell["check"]
    return {**LIMITS[p_dtype], **(own.LIMITS[p_dtype] if own else {})}


def own_readings(own, names, result, out_dir: str, device,
                 low=None) -> dict:
    """{number: reading} of the configuration's own check module `own`
    (its ``read``) for each of `names`, the numbers its ``LIMITS``
    declares at the cell's precision: MISSING where ``read`` returns no
    finite reading of a number; what it returns beyond `names` is not
    judged."""
    got = own.read(result, out_dir, device, low=low)
    out = {}
    for k in names:
        v = got.get(k)
        v = MISSING if v is None else float(v)
        out[k] = v if np.isfinite(v) else MISSING
    return out


def judge(capture, result, out_dir: str, device, max_helix: int,
          low=None, own=None, own_names=()) -> tuple:
    """({number: reading}, {what the readings rest on}) of the run
    `result` whose drains and splits `capture` drew; with `low` (a torch
    dtype) the plain reference computed in that precision is judged in
    the program's place (the control).  `own`, the configuration's check
    module, adds its numbers `own_names` after the shared ones."""
    d = lanes.drain_readings(capture.drain, max_helix, dtype=low)
    numbers = {k: d[k] for k in ("lanes_diverged", "psd_gap", "flux_gap",
                                 "esc_gap")}
    numbers["split_off"] = lanes.split_reading(capture.split, dtype=low)
    numbers.update(lanes.count_readings(capture, result))
    cast = None if low is None else (
        lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(low).to(
            torch.float64).numpy())
    numbers["smooth_gap"] = smoothing.gap(result, cast)
    numbers.update(readings(result, out_dir, device, program=(
        None if low is None else control(result, low, device))))
    if own is not None:
        numbers.update(own_readings(own, own_names, result, out_dir, device,
                                    low=low))
    seen = {"lanes": d["lanes"], "steps": d.get("steps"),
            "off": d.get("off"), "kind": (capture.drain or {}).get("kind"),
            "drains": capture.n_drains, "splits": capture.n_splits}
    return numbers, seen


def verdict(numbers: dict, limits: dict) -> tuple:
    """({name: {"value", "limit"}}, whether every number is within its
    limit)."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return out, all(v <= limits[k] for k, v in numbers.items())
