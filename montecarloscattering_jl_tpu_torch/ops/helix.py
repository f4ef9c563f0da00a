"""K5: the XLA engine's helix step as one hand-written kernel.

Replaces the JAX package's XLA-compiled ``helix_step``
(montecarloscattering_jl_tpu/ops/step.py:198-684, with
``_downstream_logic`` and ``_retro_step``) on an NVIDIA Hopper card,
in place of the plain step's ~300 small kernels a step.  It is the
engine of every configuration K1 refuses (engine/run.py ``uses_k1``):
float64 momenta, the CLI's default, and float32 with x_spec detectors.
Parallel field only (theta_B = 0, the only geometry the config
admits); the oblique step stays ops/step.py's plain one.

* ``pack(tb)``: ``StepTables.k`` and the plain step's Python constants
  as one float64 vector in the order of KV_NAMES (the ``KV`` enum of the
  source), the integer statics as one int32 vector (KI_NAMES, ``KI``),
  the flag word and the instance that runs it.
* ``HelixDrain``: the engine's path, one persistent launch of
  csrc/helix_step.cu a pcut segment: the card's resident threads claim
  lanes from a device cursor and step each until it leaves ACTIVE.
  ``enqueue`` launches on the current stream and waits for nothing;
  ``finish`` reads the segment's one integer (the steps the 64-step
  block loop would have taken; see ``drain_plain``).
* ``HelixLaunch``: K5 on one window of lanes for n steps (the block
  loop's 64-step block), one thread a lane: the comparisons' entry and
  ``run_segment(..., blocks=True)``'s.
* ``drain`` and ``block``: the wrappers.  Lanes on the CPU take the plain
  versions, ``drain_plain`` and ops/step.py ``_block`` (``helix_step`` n
  times), which are K5's spec and what chip_smoke.py and the tests hold
  it against on the card; lanes on a CUDA device launch K5 or raise.
* ``uniforms``: the XLA stream's eight uniforms of each lane, from the
  kernel's own generator on a CUDA device (its debug entry), from
  rng.lane_uniforms_xla on the CPU.
* ``INSTANCES``: K5 is compiled once per (momentum dtype, flag word) of
  this table; CT_RUNTIME reads the flags at run time and serves every
  configuration of its dtype, and the float64 flagship's word (x_spec
  detectors alone) has an instance of its own, compiled without the
  other branches.  Words with the custom f(r_g) law run a build of
  their own (``FRG_BUILD``).  The source's other compile-time knobs
  (block size, blocks an SM) keep their defaults in the engine's
  builds; scripts/probe_k5.py builds and binds (``bind``) the others.

Counters (plain integers; chip_smoke.py sets them to 0 around a driven
run): ``LAUNCHES`` (K5 launches: drains and windows), ``DRAINS`` (the
drains among them), ``DEPOSIT_STEPS``
(the helix steps whose PSD records K5 deposited through K2's warp
deposit, csrc/psd_deposit.cuh, where K2 was launched once a step: a
drain's pushes, a window's n steps), ``HOST_READS`` (the host's reads
of the lanes inside a K5 segment: the block loop's check every 64
steps; none on the drain) and ``PLAIN_CALLS`` (plain blocks on a CUDA
device, ops/step.py ``_block``: the oblique step and the comparisons).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import re
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.constants import RAD_LOSS_FAC
from ..utils.params import E_REL_PT, MAX_HELIX_STEPS
from . import build, rng
from .state import ACTIVE, FL_JRET, upload

LAUNCHES = 0
DRAINS = 0
DEPOSIT_STEPS = 0
HOST_READS = 0
PLAIN_CALLS = 0

# the build of K5 that runs the custom f(r_g) law (csrc/helix_step.cu
# K5_FRG): torch.pow's bits need csrc/helix_pow.cu, built with FMA
# contraction on and device-linked, which costs the relocatable build
# registers and spills; every other flag word runs the default build
FRG_BUILD = dict(defines={"K5_FRG": 1}, unit=("helix_pow", "-fmad=true"))

# the float64 scalar vector (csrc/helix_step.cu enum KV, the same order):
# StepTables.k, then the plain step's Python scalars
K_NAMES = ("m", "mc", "e0", "two_m", "abs_charge", "qb2", "pcut",
           "pcut_prev", "pmax", "u2", "g0u0", "pe_crit", "gamma_e_crit",
           "inj_frac", "b_cmbz", "one", "three", "ten", "c", "two_pi",
           "spike", "tiny", "tiny30", "cmax_coarse", "cmax_fine",
           "xn_coarse", "xn_fine", "eta", "twelve_pi", "frg_rg0", "frg_am1",
           "feb_up", "feb_dw", "x_stop", "age_max", "ux_dw", "gsf_dw",
           "gef_dw", "b_dw", "bcos_dw", "bsin_dw")
S_NAMES = ("eta3", "rad", "e_rel", "psd_mom_min", "log_pmin", "dcos",
           "cos_fine", "theta_min", "log_tmin", "ewf", "ftiny")
KV_NAMES = K_NAMES + S_NAMES
# the int vector (enum KI)
KI_NAMES = ("nb", "i_grid_feb", "i_shock", "n_mom", "n_theta", "bpd_mom",
            "bpd_theta", "n_xspec", "nx", "n_slots", "flags")
# the launch's pointers (enum PTR): ParticleState, StepTables and Tallies
# fields by name, and the packed vectors
STATE_NAMES = ("weight", "pb", "pperp", "phi", "ux_prev", "xn_per",
               "t_step", "x", "prp_x", "acctime", "igrid", "tcut", "status",
               "reason", "nsteps", "flags", "key0", "key1")
TABLE_NAMES = ("x_grid", "ux", "gamma_sf", "gamma_ef", "btot", "eps_target",
               "x_spec", "tcuts", "recv_prefix", "kv", "ki")
TALLY_NAMES = ("psd_diff", "flux_diff", "esc", "spectra_sf", "spectra_pf",
               "pool_diff", "weight_coupled", "spectra_coupled", "counts")
PTR_NAMES = STATE_NAMES + TABLE_NAMES + TALLY_NAMES

# bits of the flag word (enum of FLAG_* in the source)
(FLAG_DONT_SCATTER, FLAG_DONT_DSA, FLAG_RAD_LOSSES, FLAG_RETRO, FLAG_TCUTS,
 FLAG_ENERGY_TRANSFER, FLAG_CUSTOM_EPS_B, FLAG_CUSTOM_FRG, FLAG_ELECTRON,
 FLAG_REFLECT, FLAG_AGE_CUT, FLAG_FEB_DW, FLAG_XSPEC) = (
     1 << b for b in range(13))
_SS_FLAGS = (("dont_scatter", FLAG_DONT_SCATTER), ("dont_dsa", FLAG_DONT_DSA),
             ("do_rad_losses", FLAG_RAD_LOSSES), ("do_retro", FLAG_RETRO),
             ("do_tcuts", FLAG_TCUTS),
             ("do_energy_transfer", FLAG_ENERGY_TRANSFER),
             ("use_custom_eps_b", FLAG_CUSTOM_EPS_B),
             ("is_electron", FLAG_ELECTRON))
CT_RUNTIME = -1
# the drain's workspace (csrc/helix_step.cu enum WS_*): int32 words, a
# header, then a (lane, steps) pair a lane at most
WS_TAKEN, WS_PUSHES, WS_HEADER = 4, 6, 8
# K5's instances (csrc/helix_step.cu kInstances): (float64 momenta, word);
# the run-time instance of each dtype, and the float64 flagship's word
# (x_spec detectors, no other flag)
INSTANCES = ((True, CT_RUNTIME), (False, CT_RUNTIME), (True, FLAG_XSPEC))

_MOMENTUM_DTYPES = (torch.float64, torch.float32)


def flag_word_of(ss, reflect: bool, age_cut: bool, feb_dw_on: bool) -> int:
    """The flag word of a step configuration: its StepStatic switches,
    the custom f(r_g) law, the shock's reflection, the age cut, the
    downstream FEB and the x_spec detectors."""
    word = 0
    for name, bit in _SS_FLAGS:
        if getattr(ss, name):
            word |= bit
    for on, bit in ((ss.frg_rg0_cm > 0.0, FLAG_CUSTOM_FRG),
                    (reflect, FLAG_REFLECT), (age_cut, FLAG_AGE_CUT),
                    (feb_dw_on, FLAG_FEB_DW), (ss.n_xspec > 0, FLAG_XSPEC)):
        if on:
            word |= bit
    return word


def flag_word(tb) -> int:
    """The flag word of a StepTables (``flag_word_of``)."""
    return flag_word_of(tb.ss, tb.reflect, tb.age_cut, tb.feb_dw_on)


def instance_of(f64: bool, word: int) -> int:
    """Index into INSTANCES of the instance that runs `word` at this
    momentum dtype: the one compiled for it, else the run-time one."""
    if (f64, word) in INSTANCES:
        return INSTANCES.index((f64, word))
    return INSTANCES.index((f64, CT_RUNTIME))


def python_scalars(ss, pdt: torch.dtype) -> dict:
    """The Python constants of the plain step (ops/step.py and the bin
    functions of models/psd_bins.py), as float64 values: the kernel
    rounds each to the momentum dtype where the plain step's torch op
    rounds it."""
    return dict(eta3=ss.eta_mfp / 3.0, rad=RAD_LOSS_FAC, e_rel=E_REL_PT,
                psd_mom_min=ss.psd_mom_min,
                log_pmin=math.log10(ss.psd_mom_min), dcos=ss.dcos,
                cos_fine=ss.cos_fine, theta_min=ss.theta_min,
                log_tmin=math.log10(ss.theta_min),
                ewf=ss.electron_weight_fac, ftiny=torch.finfo(pdt).tiny)


@dataclass
class Packed:
    """One StepTables packed for K5."""

    tb: object              # the StepTables (the kernel reads its tables)
    kv: torch.Tensor        # [len(KV_NAMES)] float64
    ki: torch.Tensor        # [len(KI_NAMES)] int32
    word: int
    instance: int
    p_dtype: torch.dtype

    @property
    def frg(self) -> bool:
        """The word runs the f(r_g) law: K5's FRG_BUILD runs it."""
        return bool(self.word & FLAG_CUSTOM_FRG)


def pack_statics(ss, pdt: torch.dtype, n_slots: int,
                 word: int) -> tuple:
    """The host half of a packing: the S_NAMES values (float64) and the
    int vector (KI_NAMES, int32) of a step configuration."""
    scal = python_scalars(ss, pdt)
    ints = dict(nb=ss.nb, i_grid_feb=ss.i_grid_feb, i_shock=ss.i_shock,
                n_mom=ss.n_mom, n_theta=ss.n_theta,
                bpd_mom=ss.bins_per_dec_mom,
                bpd_theta=ss.bins_per_dec_theta, n_xspec=ss.n_xspec,
                nx=max(ss.n_xspec, 1), n_slots=n_slots, flags=word)
    return (np.array([scal[n] for n in S_NAMES], np.float64),
            np.array([ints[n] for n in KI_NAMES], np.int32))


def kv_rows(k: dict, s: torch.Tensor, n: int) -> torch.Tensor:
    """The [n, len(KV_NAMES)] float64 scalar vectors of n segments: each
    K_NAMES entry of `k` (a 0-dim tensor, or an [n] one that differs by
    segment) in float64, then the S_NAMES values `s` (on the device)."""
    f64 = torch.float64
    return torch.cat([
        torch.stack([k[name].to(f64).expand(n) for name in K_NAMES], 1),
        s.to(f64).expand(n, -1)], 1).contiguous()


def pack(tb) -> Packed:
    """`tb`'s scalars and statics in the order the kernel reads them, on
    the tables' device (the 0-dim ``k`` tensors are stacked there; the
    statics take one host-to-device copy).  Raises NotImplementedError
    for the oblique step."""
    ss = tb.ss
    if not ss.parallel:
        raise NotImplementedError(
            "K5 runs the parallel-field step; the oblique step is "
            "ops/step.py's plain one")
    pdt = tb.ux.dtype
    if pdt not in _MOMENTUM_DTYPES:
        raise ValueError(f"momenta in {pdt}: K5 takes float64 or float32")
    word = flag_word(tb)
    s, ki = upload(pack_statics(ss, pdt, tb.tcuts.shape[0], word),
                   tb.x_grid.device)
    return Packed(tb=tb, kv=kv_rows(tb.k, s, 1)[0], ki=ki, word=word,
                  instance=instance_of(pdt == torch.float64, word),
                  p_dtype=pdt)


# ---------------------------------------------------------------------------
# K5: build, bind, launch
# ---------------------------------------------------------------------------

_LIBS: dict = {}


def targets() -> list:
    """build.build_all's targets of K5's two builds: the default one and
    the f(r_g) law's (FRG_BUILD)."""
    return [("helix_step", None, None),
            ("helix_step", FRG_BUILD["defines"], FRG_BUILD["unit"])]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib`, a build of csrc/helix_step.cu, with its entries' argument
    types set; raises RuntimeError if its instances are not INSTANCES."""
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(i)
    lib.mcs_helix_launch.argtypes = [p] + [i] * 6 + [p]
    lib.mcs_helix_launch.restype = i
    lib.mcs_helix_drain.argtypes = [p] + [i] * 7 + [p, p]
    lib.mcs_helix_drain.restype = i
    lib.mcs_helix_uniforms.argtypes = [p] * 4 + [i, p]
    lib.mcs_helix_uniforms.restype = i
    lib.mcs_helix_instance.argtypes = [i, ip, ip]
    lib.mcs_helix_instance_attrs.argtypes = [i, i, ip, ip]
    lib.mcs_helix_drain_residency.argtypes = [i, i, ip, ip]
    lib.mcs_helix_build.argtypes = [ip] * 3
    built = []
    for k in range(lib.mcs_helix_num_instances()):
        f64, word = i(), i()
        lib.mcs_helix_instance(k, ctypes.byref(f64), ctypes.byref(word))
        built.append((bool(f64.value), word.value))
    if tuple(built) != INSTANCES:
        raise RuntimeError(f"K5 was built with the instances {built}, "
                           f"ops/helix.py lists {INSTANCES}")
    return lib


def _lib(frg: bool = False):
    """The library of K5's default build (or of the f(r_g) law's:
    FRG_BUILD), bound."""
    if frg not in _LIBS:
        _LIBS[frg] = bind(build.library(*targets()[frg]))
    return _LIBS[frg]


def ptxas_report(log: str) -> dict:
    """What ``-Xptxas -v`` said of K5's kernels in a build's log:
    {(float64 momenta, word): {"window" or "drain": registers, stack
    frame and spill bytes}}."""
    out = {}
    for blk in re.split(r"Compiling entry function '", log)[1:]:
        m = re.match(r"\w*helix_(step|drain)_kernelI([df])Li(n?)(\d+)E",
                     blk)
        regs = re.search(r"Used (\d+) registers", blk)
        mem = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads", blk)
        if m and regs and mem:
            word = -int(m.group(4)) if m.group(3) else int(m.group(4))
            kind = "drain" if m.group(1) == "drain" else "window"
            out.setdefault((m.group(2) == "d", word), {})[kind] = dict(
                registers=int(regs.group(1)), stack=int(mem.group(1)),
                spill_stores=int(mem.group(2)), spill_loads=int(mem.group(3)))
    return out


def _ints(fn, *args, n: int) -> list:
    out = [ctypes.c_int() for _ in range(n)]
    err = fn(*args, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"K5: CUDA error {err}")
    return [v.value for v in out]


def instance_attrs(i: int, nz: int | None = None, frg: bool = False,
                   lib: ctypes.CDLL | None = None) -> dict:
    """Registers and bytes of local memory (stack and spills) a thread of
    K5's instance `i` in the default build (or the f(r_g) one, or the
    bound build `lib`), its window kernel's and its drain's, from the
    CUDA runtime; with `nz` (zone boundaries), the drain's blocks an SM
    and the card's SMs.  Also the build's knobs."""
    lib = lib or _lib(frg)
    regs, local = _ints(lib.mcs_helix_instance_attrs, i, 0, n=2)
    d_regs, d_local = _ints(lib.mcs_helix_instance_attrs, i, 1, n=2)
    block, min_blocks, frg_on = _ints(lib.mcs_helix_build, n=3)
    f64, word = INSTANCES[i]
    out = dict(f64=f64, word=word, registers=regs, local_bytes=local,
               drain_registers=d_regs, drain_local_bytes=d_local,
               block=block, min_blocks=min_blocks, frg=frg_on)
    if nz is not None:
        per_sm, sms = _ints(lib.mcs_helix_drain_residency, i, nz, n=2)
        out.update(drain_blocks_per_sm=per_sm, sms=sms)
    return out


def _want(a: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if a.dtype != dtype or tuple(a.shape) != tuple(shape) \
            or a.device != dev or not a.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} on "
                         f"{dev}, got {a.dtype} {tuple(a.shape)} on "
                         f"{a.device}")


def _check(st, tl, p: Packed) -> None:
    """Raise ValueError on what the kernel does not take."""
    tb, ss = p.tb, p.tb.ss
    pdt, f64, i32 = p.p_dtype, torch.float64, torch.int32
    n = st.weight.shape[0]
    dev = st.weight.device
    for name in STATE_NAMES:
        dt = (f64 if name in ("x", "prp_x", "acctime") else
              i32 if name in ("igrid", "tcut", "status", "reason", "nsteps",
                              "flags", "key0", "key1") else pdt)
        _want(getattr(st, name), f"state.{name}", dt, (n,), dev)
    nb, nz, n_slots = ss.nb, ss.nb + 1, tb.tcuts.shape[0]
    nx = max(ss.n_xspec, 1)
    for name, dt, shape in (
            ("x_grid", f64, (nb,)), ("ux", pdt, (nb,)),
            ("gamma_sf", pdt, (nb,)), ("gamma_ef", pdt, (nb,)),
            ("btot", pdt, (nb,)), ("eps_target", pdt, (nb,)),
            ("x_spec", f64, (ss.n_xspec,)), ("tcuts", f64, (n_slots,)),
            ("recv_prefix", f64, (nz,))):
        _want(getattr(tb, name), name, dt, shape, dev)
    _want(p.kv, "kv", f64, (len(KV_NAMES),), dev)
    _want(p.ki, "ki", i32, (len(KI_NAMES),), dev)
    n_cells = (ss.n_mom + 1) * 2 * (ss.n_theta + 1)
    for name, dt, shape in (
            ("psd_diff", torch.float32, (n_cells, nz)),
            ("flux_diff", f64, (4, nz)), ("esc", f64, (4,)),
            ("spectra_sf", f64, (ss.n_mom + 1, nx)),
            ("spectra_pf", f64, (ss.n_mom + 1, nx)),
            ("pool_diff", f64, (nz,)), ("weight_coupled", f64, (n_slots,)),
            ("spectra_coupled", f64, (ss.n_mom + 1, n_slots)),
            ("counts", f64, (3,))):
        _want(getattr(tl, name), name, dt, shape, dev)
    if n_cells * nz >= 2 ** 31:
        raise ValueError(f"psd: K5 indexes fewer than 2^31 entries, got "
                         f"{n_cells} x {nz}")
    if 4 * nz * 8 > 227 * 1024:
        raise ValueError(f"{nz} zone boundaries: K5's block flux array "
                         f"holds at most {227 * 1024 // 32}")


def _pointers(st, tl, p: Packed) -> ctypes.Array:
    """The kernel's N_PTR device pointers (enum PTR), checked."""
    _check(st, tl, p)
    dev = st.weight.device
    if dev.type != "cuda":
        raise ValueError(f"no helix kernel for device {dev}")
    tensors = dict(kv=p.kv, ki=p.ki)
    ptrs = []
    for name in PTR_NAMES:
        src = (st if name in STATE_NAMES else
               tl if name in TALLY_NAMES else None)
        a = (getattr(src, name) if src is not None else
             tensors[name] if name in tensors else getattr(p.tb, name))
        ptrs.append(a.data_ptr())
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


class HelixLaunch:
    """K5 on one window of lanes `st`, tallies `tl` and packed tables `p`
    on a CUDA device, validated once: ``enqueue(n, max_helix)`` runs n
    helix steps of every lane in place, adding to the tallies, on the
    current stream.  The tensors must outlive the object."""

    def __init__(self, st, tl, p: Packed):
        self._ptrs = _pointers(st, tl, p)
        self.device = st.weight.device
        self._n = st.weight.shape[0]
        self._nz = p.tb.ss.nb + 1
        self.instance, self._word = p.instance, p.word
        self._fn = _lib(p.frg).mcs_helix_launch

    def enqueue(self, n_steps: int, max_helix: int) -> None:
        global LAUNCHES, DEPOSIT_STEPS
        if n_steps < 1:
            raise ValueError(f"n_steps = {n_steps}")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._fn(self._ptrs, self._n, n_steps, max_helix, self._nz,
                       self.instance, self._word, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"K5 launch failed: CUDA error {err}")
        LAUNCHES += 1
        DEPOSIT_STEPS += n_steps


def block_loop_steps(max_steps: int, max_helix: int, sync_every: int) -> int:
    """The steps the block loop (ops/step.py run_segment, `sync_every`
    steps a block, at most max_helix // sync_every + 2 blocks) takes on
    a segment whose longest lane takes `max_steps` steps."""
    if max_steps <= 0:
        return 0
    blocks = min(-(-max_steps // sync_every), max_helix // sync_every + 2)
    return blocks * sync_every


class HelixDrain:
    """K5 as one persistent launch a pcut segment, on lanes `st`, tallies
    `tl` and packed tables `p` on a CUDA device, validated once.
    ``enqueue(max_helix, sync_every)`` steps every ACTIVE lane until it
    leaves ACTIVE, in place, adding to the tallies, on the current
    stream, and leaves the lanes as the block loop of `sync_every`-step
    blocks leaves them (``drain_plain``); ``finish()`` then reads the
    segment's result from the card, its one host read: the block loop's
    steps (``block_loop_steps`` of the longest lane's).  The tensors
    must outlive the object."""

    def __init__(self, st, tl, p: Packed):
        self._ptrs = _pointers(st, tl, p)
        self.device = st.weight.device
        self._n = st.weight.shape[0]
        self._nz = p.tb.ss.nb + 1
        self.instance, self._word = p.instance, p.word
        self._ws = torch.empty(WS_HEADER + 2 * self._n, dtype=torch.int32,
                               device=self.device)
        self._fn = _lib(p.frg).mcs_helix_drain

    def enqueue(self, max_helix: int, sync_every: int) -> None:
        global LAUNCHES, DRAINS
        if sync_every < 1:
            raise ValueError(f"sync_every = {sync_every}")
        cap = min(sync_every * (max_helix // sync_every + 2), 2 ** 31 - 1)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._fn(self._ptrs, self._n, max_helix, sync_every, cap,
                       self._nz, self.instance, self._word,
                       ctypes.c_void_p(self._ws.data_ptr()),
                       ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"K5 drain failed: CUDA error {err}")
        LAUNCHES += 1
        DRAINS += 1

    def header(self) -> torch.Tensor:
        """The last enqueued drain's header, a copy on the device (int32
        words: WS_TAKEN its block loop's steps, ``header_pushes`` its
        pushes), without waiting: the caller reads it later and adds the
        pushes to DEPOSIT_STEPS itself."""
        return self._ws[:WS_HEADER].clone()

    def finish(self) -> int:
        """The block loop's steps of the last enqueued drain (waits for
        it); adds its pushes to DEPOSIT_STEPS."""
        global DEPOSIT_STEPS
        head = self._ws[:WS_HEADER].cpu()
        DEPOSIT_STEPS += int(header_pushes(head))
        return int(head[WS_TAKEN])


def header_pushes(head: torch.Tensor) -> torch.Tensor:
    """The pushes of drain headers [..., WS_HEADER] (int32 words), int64
    [...]: the uint64 at WS_PUSHES."""
    return head[..., WS_PUSHES:WS_PUSHES + 2].contiguous().view(
        torch.int64)[..., 0]


def _lanes(st, idx: torch.Tensor):
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).index_select(0, idx)
        for f in dataclasses.fields(st)})


def drain_plain(st, tl, tb, max_helix: int, sync_every: int) -> int:
    """K5's drain in plain PyTorch, its spec: step the ACTIVE lanes (and
    only them) one step at a time until none is ACTIVE, then apply the
    block loop's FL_JRET rule: the block loop clears the bit on a lane
    that is not ACTIVE at every step it runs, so a lane keeps it only if
    it stepped to the loop's last step (``block_loop_steps``; a lane that
    was not ACTIVE took 0 steps).  Returns the block loop's steps.
    In place; each step's tallies deposit as the plain step's do."""
    from .step import helix_step

    n0 = st.nsteps.clone()
    while True:
        idx = torch.nonzero(st.status == ACTIVE).flatten()
        if idx.numel() == 0:
            break
        sub = _lanes(st, idx)
        helix_step(sub, tl, tb,
                   rng.lane_uniforms_xla(sub.key0, sub.key1, sub.nsteps),
                   max_helix)
        for f in dataclasses.fields(st):
            getattr(st, f.name).index_copy_(0, idx, getattr(sub, f.name))
    steps = st.nsteps - n0
    taken = block_loop_steps(int(steps.max()) if steps.numel() else 0,
                             max_helix, sync_every)
    st.flags.copy_(torch.where(steps < taken, st.flags & ~FL_JRET,
                               st.flags))
    return taken


def drain(st, tl, tb, max_helix: int, sync_every: int) -> int:
    """One pcut segment of `st`, in place, deposited into `tl`: the plain
    version (``drain_plain``) for lanes on the CPU, one K5 drain for
    lanes on a CUDA device.  Returns the block loop's steps."""
    if st.weight.device.type == "cpu":
        return drain_plain(st, tl, tb, max_helix, sync_every)
    d = HelixDrain(st, tl, pack(tb))
    d.enqueue(max_helix, sync_every)
    return d.finish()


def block(st, tl, tb, n: int, max_helix: int | None = None) -> None:
    """`n` helix steps of every lane of `st`, in place, deposited into
    `tl`: the plain version (ops/step.py ``_block``) for lanes on the
    CPU, one K5 launch for lanes on a CUDA device."""
    if max_helix is None:
        max_helix = MAX_HELIX_STEPS
    if st.weight.device.type == "cpu":
        from .step import _block
        _block(st, tl, tb, n, max_helix)
        return
    HelixLaunch(st, tl, pack(tb)).enqueue(n, max_helix)


def uniforms(key0: torch.Tensor, key1: torch.Tensor,
             nsteps: torch.Tensor) -> torch.Tensor:
    """The XLA stream's eight float32 uniforms of each lane at its step
    count nsteps, [8, B]: K5's own generator (its debug entry) on a CUDA
    device, rng.lane_uniforms_xla on the CPU."""
    if key0.device.type == "cpu":
        return rng.lane_uniforms_xla(key0, key1, nsteps)
    n = key0.shape[0]
    for name, a in (("key0", key0), ("key1", key1), ("nsteps", nsteps)):
        _want(a, name, torch.int32, (n,), key0.device)
    out = torch.empty(8, n, dtype=torch.float32, device=key0.device)
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())
    err = _lib().mcs_helix_uniforms(
        ptr(key0), ptr(key1), ptr(nsteps), ptr(out), n,
        ctypes.c_void_p(torch.cuda.current_stream(key0.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"K5 uniforms failed: CUDA error {err}")
    return out
