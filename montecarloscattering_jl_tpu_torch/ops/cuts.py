"""Particle splitting between pcut segments, on the host.

Counterpart of the JAX package's ops/cuts.py (``pcut_split``; new_pcut /
pcut_finalize, cuts.jl:34-124): the lanes that reached the splitting
momentum (status SAVED) are gathered on the host, each repeated
``multiplicity`` times in place (lane j of the new population replays
saved lane j // multiplicity, as ``split_on_device`` lays them out) with
its weight divided by the multiplicity, and padded to a fixed batch.
The engine's ``fused=False`` ladder (engine/run.py) rebuilds the next
segment's state from it; the default ladder splits on the device
(ops/split.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .state import FL_DW, FL_INJ, SAVED, ParticleState


@dataclass
class SplitPopulation:
    """Host arrays of the next pcut segment."""

    weight: np.ndarray
    pb: np.ndarray
    pperp: np.ndarray
    phi: np.ndarray
    x: np.ndarray
    igrid: np.ndarray
    ux_prev: np.ndarray
    downstream: np.ndarray
    inj: np.ndarray
    xn_per: np.ndarray
    prp_x: np.ndarray
    acctime: np.ndarray
    tcut: np.ndarray
    n: int                 # live lanes (the rest is padding)
    multiplicity: int


def pcut_split(state: ParticleState, n_pts_target: int,
               batch_size: int | None = None) -> SplitPopulation | None:
    """The next pcut's population from the saved lanes of `state`, or
    None when nothing was saved (pcut_finalize's break, cuts.jl:115-119).
    Multiplicity max(target // n_saved, 1) (cuts.jl:42); the weights
    divide by it."""
    saved = state.status.cpu().numpy() == SAVED
    n_saved = int(saved.sum())
    if n_saved == 0:
        return None
    i_mult = max(n_pts_target // n_saved, 1)
    n_new = n_saved * i_mult
    if batch_size is None:
        batch_size = n_new

    def rep(arr, fill=0):
        a = np.repeat(np.asarray(arr)[saved], i_mult, axis=0)
        if len(a) < batch_size:
            a = np.concatenate([a, np.full(batch_size - len(a), fill,
                                           a.dtype)])
        return a

    h = {k: v.cpu().numpy() for k, v in vars(state).items()}
    return SplitPopulation(
        weight=rep(h["weight"]) / i_mult,
        pb=rep(h["pb"]), pperp=rep(h["pperp"]), phi=rep(h["phi"]),
        x=rep(h["x"]), igrid=rep(h["igrid"]), ux_prev=rep(h["ux_prev"]),
        downstream=rep((h["flags"] & FL_DW) != 0),
        inj=rep((h["flags"] & FL_INJ) != 0),
        xn_per=rep(h["xn_per"]), prp_x=rep(h["prp_x"]),
        acctime=rep(h["acctime"]), tcut=rep(h["tcut"]),
        n=n_new, multiplicity=i_mult)
