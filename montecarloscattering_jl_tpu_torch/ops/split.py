"""Build the next pcut population from the SAVED lanes, on the device.

Counterpart of the JAX package's ``split_on_device``
(ops/fused_ion.py:30-79; new_pcut, cuts.jl:34-98).  Lane j of the new
population replays saved lane ``j // i_mult`` with weight / i_mult, the
SAVED lanes taken in their original order (a stable partition), and
gets the key ``fold_in(seg_key, lane_offset + j)``.  The result is
exact: the same lanes, weights and keys as the JAX function.  Nothing is
read back to the host: the multiplicity is computed on the device, as
the JAX function computes it (fused_ion.py:48-51), so the pcut ladder
can queue the next segment behind the split.
"""

from __future__ import annotations

import torch

from . import rng
from .state import ACTIVE, FINISHED, FL_DW, FL_INJ, SAVED, ParticleState


def split_on_device(state: ParticleState, n_target: int,
                    seg_key: tuple[int, int],
                    lane_offset: int = 0
                    ) -> tuple[ParticleState, torch.Tensor]:
    """Returns (new state, n_new) with n_new = n_saved * i_mult, a 0-dim
    int64 tensor on the state's device; with nothing saved every lane
    comes out FINISHED with zero weight."""
    b = state.weight.shape[0]
    dev = state.device
    saved = state.status == SAVED
    n_saved = saved.sum()
    order = torch.argsort((~saved).to(torch.int8), stable=True)
    i_mult = torch.clamp(int(n_target) // torch.clamp(n_saved, min=1),
                         min=1)
    j = torch.arange(b, device=dev)
    src = order[torch.clamp(j // i_mult, max=b - 1)]
    valid = j < n_saved * i_mult

    g = lambda a: a[src]
    p_dtype = state.pb.dtype
    key0, key1 = rng.fold_in_lanes(seg_key, b, dev, offset=lane_offset)
    zeros_i = torch.zeros(b, dtype=torch.int32, device=dev)
    # a device tensor divisor: torch turns division by a Python number
    # into a reciprocal multiply on CUDA, which would not be exact
    div = i_mult.to(p_dtype)
    new = ParticleState(
        weight=torch.where(valid, g(state.weight) / div, 0.0).to(p_dtype),
        pb=g(state.pb), pperp=g(state.pperp), phi=g(state.phi),
        x=g(state.x), igrid=g(state.igrid), ux_prev=g(state.ux_prev),
        xn_per=g(state.xn_per), prp_x=g(state.prp_x),
        acctime=g(state.acctime), tcut=g(state.tcut),
        status=torch.where(valid, ACTIVE, FINISHED).to(torch.int32),
        reason=zeros_i, nsteps=zeros_i.clone(),
        flags=g(state.flags) & (FL_DW | FL_INJ),
        key0=key0, key1=key1,
        t_step=torch.zeros(b, dtype=p_dtype, device=dev))
    return new, n_saved * i_mult
