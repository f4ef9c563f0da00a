"""Exit bookkeeping for finished lanes.

Counterpart of the JAX package's ops/finish.py (particle_finish!,
particle_finish.jl:46-107): after a segment drains, every FINISHED lane
is transformed to the shock frame once and added into the escape PSDs
and flux accumulators by its exit reason; SAVED lanes go on to the next
pcut.  The sums are float64.  The four binned tallies (the two escape
PSDs, esc_energy_eff, esc_num_eff):

* on the CPU, ``tally_index_put``: ``index_put_(accumulate=True)``,
  which sums each cell serially in lane order;
* on a CUDA device, ``tally_escapes``: one call of csrc/finish.cu on the
  current stream, no host wait, which skips every zero addend and sums
  each cell in a fixed order of its own (the lanes' kernel order: see
  the source's header).  ``tally_twin`` is its plain version, the same
  sums in the same order in plain torch, for the tests and chip_smoke.py
  (it runs on the CPU).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from ..utils.constants import C_CGS
from ..utils.params import E_REL_PT, PF_SPIKE_AWAY
from ..models.psd_bins import psd_bin_angle, psd_bin_momentum
from . import build
from .state import (FINISHED, R_DOWNSTREAM, R_UPSTREAM_PMAX,
                    ParticleState, SegmentGrids, SegmentScalars,
                    StepStatic)
from .transforms import transform_p_ps

F64 = torch.float64

# launches of the finish kernel (csrc/finish.cu, one call a finish) since
# import: the engine counts them as RunResult.launches["finish"]
LAUNCHES = 0
# the kernel's summation order (csrc/finish.cu kLanes, kThreads * kLanes):
# a group's consecutive lanes, a chunk's, and a chunk's most records
GROUP_LANES = 4
CHUNK_LANES = 1024
CHUNK_SLOTS = 2 * CHUNK_LANES

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.library("finish")
        p = ctypes.c_void_p
        lib.mcs_finish_tally.argtypes = [p] * 14 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
        lib.mcs_finish_tally.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@dataclass
class EscapeTallies:
    esc_psd_up: torch.Tensor      # [n_mom+1, n_theta+1] upstream/pmax
    esc_psd_dw: torch.Tensor      # [n_mom+1, n_theta+1] downstream
    esc_flux: torch.Tensor        # escaped weight (reason 2)
    px_esc_feb: torch.Tensor
    energy_esc_feb: torch.Tensor
    esc_energy_eff: torch.Tensor  # [n_mom+1]
    esc_num_eff: torch.Tensor     # [n_mom+1]

    @staticmethod
    def zeros(n_mom: int, n_theta: int, device) -> "EscapeTallies":
        z = lambda *s: torch.zeros(s, dtype=torch.float64, device=device)
        return EscapeTallies(
            esc_psd_up=z(n_mom + 1, n_theta + 1),
            esc_psd_dw=z(n_mom + 1, n_theta + 1),
            esc_flux=z(), px_esc_feb=z(), energy_esc_feb=z(),
            esc_energy_eff=z(n_mom + 1), esc_num_eff=z(n_mom + 1))

    def to_numpy(self) -> "EscapeTallies":
        return EscapeTallies(**{
            f.name: getattr(self, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(self)})


@dataclass
class FinishScratch:
    """csrc/finish.cu's device scratch for up to ``chunks * CHUNK_LANES``
    lanes: each chunk's count of records, and its records' keys and
    (first, second) sums.  Made once a species' ladder on a card."""

    counts: torch.Tensor       # [chunks] int32
    keys: torch.Tensor         # [chunks * CHUNK_SLOTS] int32
    vals: torch.Tensor         # [chunks * CHUNK_SLOTS, 2] float64

    @staticmethod
    def for_lanes(n_lanes: int, device) -> "FinishScratch":
        chunks = max(-(-n_lanes // CHUNK_LANES), 1)
        return FinishScratch(
            torch.empty(chunks, dtype=torch.int32, device=device),
            torch.empty(chunks * CHUNK_SLOTS, dtype=torch.int32,
                        device=device),
            torch.empty(chunks * CHUNK_SLOTS, 2, dtype=F64, device=device))


def tally_index_put(acc: EscapeTallies, ip, jt, is_dw, is_up, wwf, we,
                    wd) -> None:
    """The CPU's binned tallies: each lane's addends (float64 [n]) into
    `acc`'s escape PSDs at (ip, jt) and its 1-D tallies at ip (int64
    [n]) by its reason (bool [n]), by accumulating ``index_put_``."""
    zero = torch.zeros((), dtype=F64, device=ip.device)
    acc.esc_psd_dw.index_put_((ip, jt), torch.where(is_dw, wwf, zero),
                              accumulate=True)
    acc.esc_psd_up.index_put_((ip, jt), torch.where(is_up, wwf, zero),
                              accumulate=True)
    acc.esc_energy_eff.index_put_((ip,), torch.where(is_up, we, zero),
                                  accumulate=True)
    acc.esc_num_eff.index_put_((ip,), torch.where(is_up, wd, zero),
                               accumulate=True)


def _in_order(ids, vals, init=None):
    """(the distinct `ids` ascending, each one's rows of `vals` [r, 2]
    added one at a time in the rows' order, onto `init(ids)` where given,
    else onto 0)."""
    order = torch.sort(ids, stable=True).indices
    ids, vals = ids[order], vals[order]
    uniq, counts = torch.unique_consecutive(ids, return_counts=True)
    seg = torch.repeat_interleave(torch.arange(len(uniq)), counts)
    rank = torch.arange(len(ids)) - (torch.cumsum(counts, 0) - counts)[seg]
    out = (torch.zeros((len(uniq), 2), dtype=F64) if init is None
           else init(uniq))
    for r in range(int(counts.max()) if len(uniq) else 0):
        m = rank == r
        out[seg[m]] = out[seg[m]] + vals[m]     # a distinct id a row
    return uniq, out


def tally_twin(acc: EscapeTallies, ip, jt, is_dw, is_up, wwf, we,
               wd) -> None:
    """csrc/finish.cu in plain torch on the CPU, `tally_index_put`'s
    arguments: the same sums in the kernel's order, so bit for bit its
    result.  A record is a lane's (2-D cell, wwf) where it finished
    downstream or upstream and (momentum bin, we, wd) where upstream,
    dropped where its addends are zero or its bins lie outside the
    tallies; a key's records sum in lane order within each group of
    GROUP_LANES lanes, the groups' sums in group order within each
    chunk of CHUNK_LANES lanes, and the chunks' sums in chunk order onto
    the tally."""
    n = ip.shape[0]
    n_mom1, n_theta1 = acc.esc_psd_dw.shape
    cells = n_mom1 * n_theta1
    lane = torch.arange(n)
    ok = (ip >= 0) & (ip < n_mom1) & (jt >= 0) & (jt < n_theta1)
    a = ok & (is_dw | is_up) & (wwf != 0)
    b = ok & is_up & ((we != 0) | (wd != 0))
    key = torch.cat([torch.where(is_up, cells, 0)[a] + ip[a] * n_theta1
                     + jt[a], 2 * cells + ip[b]])
    vals = torch.cat([torch.stack([wwf[a], torch.zeros_like(wwf[a])], 1),
                      torch.stack([we[b], wd[b]], 1)])
    lanes = torch.cat([lane[a], lane[b]])
    groups = max(-(-n // GROUP_LANES), 1)
    chunks = max(-(-n // CHUNK_LANES), 1)
    ids, f = _in_order(key * groups + lanes // GROUP_LANES, vals)
    chunk = ids % groups // (CHUNK_LANES // GROUP_LANES)
    ids, f = _in_order(ids // groups * chunks + chunk, f)
    table = torch.stack([
        torch.cat([acc.esc_psd_dw.flatten(), acc.esc_psd_up.flatten(),
                   acc.esc_energy_eff]),
        torch.cat([torch.zeros(2 * cells, dtype=F64), acc.esc_num_eff])], 1)
    ids, f = _in_order(ids // chunks, f, init=lambda u: table[u])
    table[ids] = f
    acc.esc_psd_dw.copy_(table[:cells, 0].view(n_mom1, n_theta1))
    acc.esc_psd_up.copy_(table[cells:2 * cells, 0].view(n_mom1, n_theta1))
    acc.esc_energy_eff.copy_(table[2 * cells:, 0])
    acc.esc_num_eff.copy_(table[2 * cells:, 1])


def _check_tally(acc: EscapeTallies, lanes: dict,
                 scratch: FinishScratch) -> None:
    """Raise ValueError on what the finish kernel does not take: its
    dtype, shape and contiguity first, missing scratch or scratch for
    fewer lanes, then its device."""
    if scratch is None:
        raise ValueError("scratch: the finish kernel takes a FinishScratch "
                         "(FinishScratch.for_lanes)")
    n = lanes["ip"].shape[0]
    n_mom1, n_theta1 = acc.esc_psd_dw.shape
    chunks = scratch.counts.shape[0]
    want = [(k, a, torch.int64 if k in ("ip", "jt") else
             torch.bool if k.startswith("is_") else F64, (n,))
            for k, a in lanes.items()]
    psd = (n_mom1, n_theta1)
    want += [(f, getattr(acc, f), F64, shape) for f, shape in (
        ("esc_psd_dw", psd), ("esc_psd_up", psd),
        ("esc_energy_eff", (n_mom1,)), ("esc_num_eff", (n_mom1,)))]
    want += [("counts", scratch.counts, torch.int32, (chunks,)),
             ("keys", scratch.keys, torch.int32, (chunks * CHUNK_SLOTS,)),
             ("vals", scratch.vals, F64, (chunks * CHUNK_SLOTS, 2))]
    for name, a, dtype, shape in want:
        if a.dtype != dtype:
            raise ValueError(f"{name}: want dtype {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: want a contiguous tensor")
    if chunks * CHUNK_LANES < n:
        raise ValueError(f"scratch: {chunks} chunks hold "
                         f"{chunks * CHUNK_LANES} lanes, got {n}")
    dev = lanes["ip"].device
    for name, a, _, _ in want:
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"{name}: the finish kernel runs on the lanes' "
                             f"CUDA device, got {a.device} (lanes on {dev})")


def tally_escapes(acc: EscapeTallies, ip, jt, is_dw, is_up, wwf, we, wd,
                  scratch: FinishScratch) -> None:
    """`tally_index_put` on a CUDA device: one call of csrc/finish.cu on
    the current stream, no host wait, summing as ``tally_twin`` does.
    `scratch`: a ``FinishScratch`` for at least the lanes on their
    device."""
    global LAUNCHES
    n = ip.shape[0]
    _check_tally(acc, dict(ip=ip, jt=jt, is_dw=is_dw, is_up=is_up, wwf=wwf,
                           we=we, wd=wd), scratch)
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())
    n_mom1, n_theta1 = acc.esc_psd_dw.shape
    err = _lib().mcs_finish_tally(
        ptr(ip), ptr(jt), ptr(is_dw), ptr(is_up), ptr(wwf), ptr(we),
        ptr(wd), ptr(acc.esc_psd_dw), ptr(acc.esc_psd_up),
        ptr(acc.esc_energy_eff), ptr(acc.esc_num_eff), ptr(scratch.counts),
        ptr(scratch.keys), ptr(scratch.vals), ctypes.c_longlong(n),
        ctypes.c_int(n_mom1), ctypes.c_int(n_theta1),
        ctypes.c_void_p(torch.cuda.current_stream(ip.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"finish launch failed: CUDA error {err}")
    LAUNCHES += 1


def finish_lanes(state: ParticleState, grids: SegmentGrids,
                 sc: SegmentScalars, ss: StepStatic,
                 m: torch.Tensor | None = None) -> dict:
    """Each lane of a drained segment as the tallies take it, on the
    state's device: its shock-frame bins ``ip``, ``jt`` (int64), whether
    it finished downstream or upstream / past pmax (``is_dw``,
    ``is_up``), its float64 addends ``wwf`` (the PSDs', weight times
    1/|v_x|), ``we`` (weight times kinetic energy) and ``wd`` (weight),
    zero where it did not finish, and ``px`` (|p_x| in the shock frame,
    float64).  `m`: the species' mass as a 0-dim tensor of the momentum
    dtype on the state's device, where the caller has it there already
    (else made from ``sc.m``, a host-to-device copy)."""
    c = C_CGS
    if m is None:
        m = torch.tensor(sc.m, dtype=state.pb.dtype, device=state.device)
    e0 = m * c * c

    fin = (state.status == FINISHED) & (state.weight > 0.0)
    w = torch.where(fin, state.weight, 0.0)

    ig = state.igrid.long()
    ptot = torch.hypot(state.pb, state.pperp)
    sk = transform_p_ps(
        state.pb, state.pperp,
        torch.hypot(ptot / (m * c), torch.ones_like(ptot)),
        state.phi, grids.ux[ig], grids.uz[ig], grids.utot[ig],
        grids.gamma_sf[ig], grids.b_cos[ig], grids.b_sin[ig], m, c)

    ip = psd_bin_momentum(sk.ptot_sk, ss.psd_mom_min, ss.bins_per_dec_mom,
                          ss.n_mom).long()
    jt = psd_bin_angle(sk.px_sk, sk.ptot_sk, ss.cos_fine, ss.dcos,
                       ss.theta_min, ss.bins_per_dec_theta,
                       ss.n_theta).long()

    # 1/|v_x| weighting with the spike clamp (particle_finish.jl:74-78)
    spike = sk.ptot_sk > (PF_SPIKE_AWAY * sk.px_sk).abs()
    wf = torch.where(
        spike,
        sk.gamma_sk * m * PF_SPIKE_AWAY
        / torch.clamp(sk.ptot_sk, min=1.0e-300),
        sk.gamma_sk * m / torch.clamp(sk.px_sk.abs(), min=1.0e-300))

    rel = (sk.gamma_sk - 1.0) >= E_REL_PT
    e_kin = torch.where(rel, (sk.gamma_sk - 1.0) * e0,
                        sk.ptot_sk * sk.ptot_sk / (2.0 * m))

    return dict(ip=ip, jt=jt, is_dw=fin & (state.reason == R_DOWNSTREAM),
                is_up=fin & (state.reason == R_UPSTREAM_PMAX),
                wwf=(w * wf).double(), we=(w * e_kin).double(),
                wd=w.double(), px=sk.px_sk.abs().double())


def finish_particles(state: ParticleState, acc: EscapeTallies,
                     grids: SegmentGrids, sc: SegmentScalars,
                     ss: StepStatic, m: torch.Tensor | None = None,
                     scratch: FinishScratch | None = None) -> EscapeTallies:
    """Accumulate exit tallies for all FINISHED lanes of a segment into
    `acc` (in place; returned for chaining); `m` as ``finish_lanes``
    takes it.  The binned tallies go through ``tally_index_put`` on the
    CPU (`scratch` unused) and through ``tally_escapes`` (`scratch`
    required, made once a species' ladder) on a CUDA device, which
    skips the zero addends: a segment the pcut ladder queued after its
    chain died (engine/run.py), whose lanes all have zero weight, adds
    nothing."""
    x = finish_lanes(state, grids, sc, ss, m)
    px = x.pop("px")
    if state.device.type == "cpu":
        tally_index_put(acc, **x)
    else:
        tally_escapes(acc, **x, scratch=scratch)
    zero = torch.zeros((), dtype=torch.float64, device=state.device)
    is_up, wd = x["is_up"], x["wd"]
    acc.esc_flux += torch.where(is_up, wd, zero).sum()
    acc.px_esc_feb += torch.where(is_up, px * wd, zero).sum()
    acc.energy_esc_feb += torch.where(is_up, x["we"], zero).sum()
    return acc
