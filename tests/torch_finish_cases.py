"""The finish kernel's cases (csrc/finish.cu, ops/finish.py): a
segment's lanes as ``finish_lanes`` hands them on, made from a seed, on
the benchmark cell's tallies, for tests/test_torch_finish_kernel.py on
the CPU and tests/test_torch_cuda.py on a card."""

import numpy as np
import torch

from montecarloscattering_jl_tpu_torch.ops import finish as fin

# each cell of the kernel's or the twin's tallies against index_put_'s,
# relative to the cell's value (tests/test_torch_finish_kernel.py)
TOL = 1e-12
N_MOM1, N_THETA1 = 54, 41           # the benchmark cell's tallies
LANES = 65_536


def lanes(n, seed, share_fin=0.4, cells=None, reasons=(1, 2)):
    """A segment's lanes as finish_particles hands them on: bins,
    reasons and float64 addends; about `share_fin` of the lanes finished
    (the rest SAVED or zero-weight padding, their addends zero),
    spectrum-like weights over twelve decades; `cells` ([(ip, jt)]) the
    cells the finished lanes fall in, else the whole histogram."""
    g = np.random.default_rng(seed)
    if cells is None:
        ip = g.integers(0, N_MOM1, n)
        jt = g.integers(0, N_THETA1, n)
    else:
        pick = g.integers(0, len(cells), n)
        ip = np.array([c[0] for c in cells])[pick]
        jt = np.array([c[1] for c in cells])[pick]
    done = g.random(n) < share_fin
    reason = np.where(done, g.choice(reasons, n), 0)
    w = np.where(done, 10.0 ** g.uniform(-6, 6, n), 0.0)
    wf = 10.0 ** g.uniform(-3, 3, n)
    e_kin = 10.0 ** g.uniform(-9, -2, n)
    is_dw, is_up = reason == 1, reason == 2
    t = torch.from_numpy
    return dict(ip=t(ip.astype(np.int64)), jt=t(jt.astype(np.int64)),
                is_dw=t(is_dw), is_up=t(is_up), wwf=t(w * wf),
                we=t(w * e_kin), wd=t(w.copy()))


def tallies(seed=None):
    """Fresh tallies, or (with `seed`) ones that already hold sums."""
    acc = fin.EscapeTallies.zeros(N_MOM1 - 1, N_THETA1 - 1, "cpu")
    if seed is not None:
        g = np.random.default_rng(seed)
        for f in ("esc_psd_dw", "esc_psd_up", "esc_energy_eff",
                  "esc_num_eff"):
            a = getattr(acc, f)
            a.copy_(torch.from_numpy(g.random(tuple(a.shape))
                                     * (g.random(tuple(a.shape)) < 0.5)))
    return acc


BINNED = ("esc_psd_dw", "esc_psd_up", "esc_energy_eff", "esc_num_eff")


def run(how, lanes_, start=None):
    """The four binned tallies after `how` (tally_index_put, tally_twin)
    added `lanes_` into `tallies(start)`."""
    acc = tallies(start)
    how(acc, **lanes_)
    return {f: getattr(acc, f).clone() for f in BINNED}


def assert_close(got, want):
    for f in BINNED:
        err = (got[f] - want[f]).abs()
        assert bool((err <= TOL * want[f].abs()).all()), (
            f, float((err / want[f].abs().clamp(min=1e-300)).max()))


def same_bits(a, b):
    return all(torch.equal(a[f].view(torch.int64), b[f].view(torch.int64))
               for f in BINNED)


CASES = {
    "one_cell": dict(n=LANES, cells=[(7, 3)], share_fin=1.0),
    "one_cell_upstream": dict(n=LANES, cells=[(0, 0)], share_fin=1.0,
                              reasons=(2,)),
    "mixed": dict(n=LANES),
    "hot_cells": dict(n=LANES, cells=[(1, 40), (2, 40), (2, 39), (53, 0)]),
    "one_d": dict(n=LANES, reasons=(2,), cells=[(k, 0) for k in range(54)]),
    "ragged": dict(n=LANES - 1000 + 37),
    "few": dict(n=5, share_fin=1.0),
}
