"""Run orchestration: the species / pcut loop nest of one iteration.

Counterpart of the JAX package's engine/run.py on one device:
``TransportEngine.run_ion`` transports one species through the pcut
ladder of [drain -> finish -> split] segments, ending when a segment
saves nothing (pcut_finalize, cuts.jl:115-119).  The split runs on the
device (ops/split.py) in the fused ladder, which queues every segment
without a host wait on ops/mega.py ``drive_ladder_async`` (the JAX
package's scheduler, pallas_step.py:2057-2127): the host reads the
chain every MCS_HYBRID_SYNC_EVERY segments (default 8, 0 never), after a
segment where a mid checkpoint is due, and at the end, and a segment
queued after the chain died is a no-op that counts nothing.  With
``fused=False`` the split runs on the host (ops/cuts.py pcut_split, the
JAX package's host-split loop, run.py:640-700), which rebuilds the next
segment's state from the saved lanes with the same keys, a host loop
that reads every segment.  Two
engines drain a segment, chosen as the JAX package chooses them
(megakernel_supported's static gate, pallas_step.py:1237-1239):

* K1 (ops/mega.py), the megakernel's counterpart
  (run_ion_mega_hybrid, pallas_step.py:2130-2247): float32 momenta, no
  x_spec detectors, a parallel field and nb + 1 <= 128 zones;
* otherwise the XLA engine (ops/step.py run_segment; run_ion_xla_hybrid,
  fused_ion.py:162-218, and on the CPU the scan ladder run_ion_fused,
  run.py:520-536, with the same segment semantics): float64 momenta by
  default, x_spec detectors and oblique fields.  On a CUDA card a
  segment of the parallel-field step is one K5 drain (ops/helix.py).
  The block loop (the CPU's, the oblique step's) runs the live-lane
  compaction ladder (``compact_levels``, -1 auto as in the JAX package,
  run.py:104-142; moot on K5's drain).  The state, tallies and segment
  tables live in buffers that stay for the engine's life, so that the
  oblique step's CUDA graphs, captured once per window size, replay
  across segments, species and iterations (``graphs``).

``TransportEngine.launches`` counts the kernels the ladders launched
(K1, K2, K5 and K5's steps, the finish kernel) and the plain blocks on a
CUDA device, over the engine's life (``RunResult.launches``).

Keys are derived as the JAX package derives them, so both packages hand
every lane the same random stream on either engine.

The ion -> electron energy transfer follows the JAX package's plumbing
(run.py:186-208, 658-669, 717-750): ``new_iteration_tallies(prof)``
fills the electrons' heating target ``eps_target``, the ions' pool
accumulates into ``it.energy_pool``, and a later species (the electrons)
reads its prefix sum from the segment grids.

A segment-boundary checkpoint (parallel/checkpoint.py) can be taken
after any split (a due one makes its segment a sync point) and resumed
bit for bit where the device's sums are ordered (the CPU).

With a ``mesh`` of more than one rank (parallel/shard.py; run.py:92-182,
358-456) every rank builds the whole population and keeps its shard of
the lanes.  K1 with ``fused`` runs the mesh hybrid ladder on the same
scheduler (run_ion_mega_hybrid_sharded, shard.py:256-307): each rank
drains, finishes and splits its own lanes to its share of the target,
its keys offset by its first lane, and writes the split's small
counters into a row on its device; the rows of every rank cross ranks
in one gather a sync point and one at the end (every rank's split,
``IonResult.splits``), from which the chain's new lanes are summed.
Otherwise (``fused=False``, and the XLA engine whatever ``fused`` says,
run.py:376) the host-split ladder: each rank drains its shard, the
lanes of every rank are gathered, and every rank runs the same split on
the whole batch and keeps its shard, so every lane is the bits of the
single-process run.  The species' accumulators are summed over the
ranks once, after its last segment.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import constants as K
from ..utils.config import RunConfig
from ..utils.params import E_REL_PT
from ..utils.tracing import span
from ..models.injection import init_pop
from ..ops import finish, helix, hist, mega, rng
from ..ops import step as xla_step
from ..ops import state as stt
from ..ops.cuts import pcut_split
from ..ops.finish import EscapeTallies, FinishScratch, finish_particles
from ..ops.split import split_on_device
from ..parallel import multihost, shard
from .setup import RunSetup

log = logging.getLogger("mcs.torch.engine")


# the auto compaction depth halves the window while the lanes number
# more than this (and are a multiple of 256), as the JAX package does
COMPACT_FLOOR = 4096


def _round_up(n: int, m: int = 128) -> int:
    return ((n + m - 1) // m) * m


def launch_counts() -> dict:
    """The kernels' launch counters and the plain blocks on a CUDA
    device, as they stand."""
    return dict(k1=mega.LAUNCHES, k2=hist.LAUNCHES, k5=helix.LAUNCHES,
                k5_steps=helix.DEPOSIT_STEPS, plain_blocks=helix.PLAIN_CALLS,
                finish=finish.LAUNCHES)


def auto_compact_levels(batch_size: int) -> int:
    """The compaction depth of ``compact_levels=-1`` (run.py:131-142)."""
    b, levels = batch_size, 0
    while b > COMPACT_FLOOR and b % 256 == 0:
        b //= 2
        levels += 1
    return levels


@dataclass
class IonResult:
    """Per-(iteration, species) tallies after all pcuts.  `psd` and
    `therm_psd` stay on the device for the reduction."""

    psd: torch.Tensor          # [n_mom+1, n_theta+1, nb]
    therm_psd: torch.Tensor
    num_crossings: np.ndarray  # [nb]
    esc: EscapeTallies         # NumPy fields
    spectra_sf: np.ndarray     # [n_mom+1, max(n_xspec, 1)]
    spectra_pf: np.ndarray
    n_pushes: int = 0
    n_trajectories: int = 0
    # new lanes of each segment run, over every rank
    n_new: list = None
    # the mesh hybrid ladder: each segment's split, every rank's
    # (parallel/shard.gather_splits, with the segment's n_target)
    splits: list = None
    # the port's own counters: FINISHED lanes by exit reason (index 1-4,
    # stt.R_*), entries into the retro walk, energy [erg, weighted] the
    # electrons received from the pool and radiated
    reason_counts: np.ndarray = None
    retro_entries: float = 0.0
    energy_received: float = 0.0
    energy_radiated: float = 0.0


@dataclass
class IterationTallies:
    """Per-iteration flux accumulators (zeroed at main_loops.jl:56-87)."""

    pxx_flux: np.ndarray
    pxz_flux: np.ndarray
    energy_flux: np.ndarray
    px_esc_upstream: float = 0.0
    energy_esc_upstream: float = 0.0
    sum_p_downstream: float = 0.0
    sum_ke_downstream: float = 0.0
    weight_coupled: np.ndarray = None    # [n_tcut_slots, n_ions]
    spectra_coupled: np.ndarray = None   # [n_mom+1, n_tcut_slots, n_ions]
    # ion -> electron energy pool [erg per zone], filled by ion species
    # and consumed by electrons later in the same iteration
    # (main_loops.jl:83-84,164)
    energy_pool: np.ndarray = None
    eps_target: np.ndarray = None


@dataclass
class TransportEngine:
    """Builds the device-side segment inputs of a run and transports
    species through the pcut ladder on `device`, with momenta in
    `p_dtype` (float64, as the JAX package's default).  `fused` False
    splits between segments on the host; `compact_levels` is the XLA
    engine's compaction depth (ops/step.run_segment): halve the window
    up to this many times as lanes end, -1 auto (down to a
    COMPACT_FLOOR-lane floor, per shard under a mesh), 0 off.  K1
    ignores it: its lane cursor keeps its warps full (the megakernel
    path, run.py:150-152).  `mesh` (parallel/shard.Mesh, on `device`)
    shards the lanes over its ranks; the batch is then padded to a
    multiple of 128 lanes a rank (run.py:126-129)."""

    setup: RunSetup
    device: torch.device
    p_dtype: torch.dtype = torch.float64
    batch_size: int = 0
    fused: bool = True
    compact_levels: int = -1
    mesh: shard.Mesh = None
    n_pushes_total: int = 0
    n_trajectories_total: int = 0

    def __post_init__(self):
        cfg = self.setup.cfg
        self.device = torch.device(self.device)
        self.batch_size = _round_up(
            max(cfg.n_pts_inj + 64, cfg.n_pts_pcut, cfg.n_pts_pcut_hi))
        if self.batch_size > 8192:
            self.batch_size = _round_up(self.batch_size, 4096)
        self.world = 1 if self.mesh is None else self.mesh.size
        if self.world > 1:
            if self.mesh.device != self.device:
                raise ValueError(f"the engine runs on {self.device}, its "
                                 f"mesh rank on {self.mesh.device}")
            self.batch_size = shard.pad_to_devices(self.batch_size,
                                                   self.world)
        self.base_key = rng.key(cfg.random_seed)
        self.n_tcut_slots = max(len(cfg.tcuts), 1)
        self.subtimers = defaultdict(float)    # MCS_SUBTIMERS=1
        self.launches = defaultdict(int)       # launch_counts() of the ladders
        # the fused ladders' sync points (their reads of the chain) over
        # the engine's life
        self.sync_points = 0
        if self.compact_levels < 0:
            self.compact_levels = auto_compact_levels(
                self.batch_size // self.world)
        # the XLA engine's fixed buffers (made at first use) and graphs
        self._xla_bufs, self._xla_tables = {}, {}
        self.graphs = xla_step.GraphCache()

    # -- per-segment input builders -----------------------------------------

    def segment_grids(self, prof, eps_target=None,
                      recv_pool=None) -> stt.SegmentGrids:
        """The zone fields, detector positions, tcut times (+inf padded
        to n_tcut_slots), the electron heating target and the prefix
        sum of the received-energy pool (run.py:186-208)."""
        cfg, nb, dev = self.setup.cfg, self.setup.nb, self.device
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
            dev, self.p_dtype)
        d = lambda a: torch.tensor(np.asarray(a, np.float64),
                                   dtype=stt.X_DTYPE, device=dev)
        x_spec = cfg.x_spec or [0.0]
        tcuts = np.full(self.n_tcut_slots, np.inf)
        tcuts[:len(cfg.tcuts)] = cfg.tcuts
        if eps_target is None:
            eps_target = np.zeros(nb)
        prefix = np.zeros(nb + 1)
        if recv_pool is not None:
            prefix[1:] = np.cumsum(recv_pool)
        return stt.SegmentGrids(
            x_grid=torch.as_tensor(self.setup.x_grid_cm,
                                   dtype=stt.X_DTYPE).to(dev),
            ux=f(prof.ux_sk), uz=f(prof.uz_sk), utot=f(prof.utot),
            gamma_sf=f(prof.gamma_sf), gamma_ef=f(prof.gamma_ef),
            btot=f(prof.btot), b_cos=f(np.cos(prof.theta)),
            b_sin=f(np.sin(prof.theta)), x_spec=d(x_spec), tcuts=d(tcuts),
            eps_target=f(eps_target), recv_prefix=d(prefix))

    def segment_scalars(self, i_ion: int, i_pcut: int, bmag2: float
                        ) -> stt.SegmentScalars:
        """Host floats; each engine's table function puts them on the
        device in its dtypes (mega.mega_tables, step.step_tables)."""
        cfg = self.setup.cfg
        s = cfg.species[i_ion]
        pcut = cfg.pcuts[i_pcut]
        pcut_prev = cfg.pcuts[i_pcut - 1] if i_pcut > 0 else 0.0
        return stt.SegmentScalars(
            aa=s.aa, abs_charge=abs(s.charge), m=s.mass, pcut=pcut,
            pcut_prev=pcut_prev, pmax_cutoff=pmax_cutoff(cfg, s.mass),
            u2=self.setup.u2, bmag2=bmag2, b_cmbz=self.setup.b_cmbz,
            gamma0_u0=cfg.gamma0 * cfg.u0, feb_up=cfg.feb_upstream,
            feb_dw=cfg.feb_downstream, x_grid_stop=self.setup.x_grid_stop,
            age_max=cfg.age_max, pe_crit=cfg.pe_crit,
            gamma_e_crit=cfg.gamma_e_crit, inj_frac=cfg.inj_fracs[i_ion])

    def step_static(self, i_ion: int) -> stt.StepStatic:
        cfg = self.setup.cfg
        b = self.setup.bins
        return stt.StepStatic(
            eta_mfp=cfg.eta_mfp, xn_per_coarse=cfg.xn_per_coarse,
            xn_per_fine=cfg.xn_per_fine, dont_scatter=cfg.dont_scatter,
            frg_alpha=(cfg.frg_alpha if cfg.use_custom_frg else 1.0),
            frg_rg0_cm=(cfg.frg_rg0_rg * cfg.rg0
                        if cfg.use_custom_frg else 0.0),
            dont_dsa=cfg.dont_dsa, do_rad_losses=cfg.do_rad_losses,
            do_retro=cfg.do_retro, do_tcuts=cfg.do_tcuts,
            use_custom_eps_b=cfg.use_custom_eps_b,
            is_electron=cfg.species[i_ion].is_electron,
            do_energy_transfer=(cfg.energy_transfer_frac > 0
                                and cfg.n_ions > 1),
            electron_weight_fac=self.setup.electron_weight_fac,
            n_xspec=len(cfg.x_spec), i_grid_feb=self.setup.i_grid_feb,
            i_shock=self.setup.i_shock,
            nb=self.setup.nb, psd_mom_min=b.psd_mom_min,
            bins_per_dec_mom=b.bins_per_dec_mom, n_mom=b.n_mom,
            cos_fine=b.cos_fine, dcos=b.dcos, theta_min=b.theta_min,
            bins_per_dec_theta=b.bins_per_dec_theta, n_theta=b.n_theta)

    def uses_k1(self, ss: stt.StepStatic) -> bool:
        """The JAX package's engine selection (megakernel_supported,
        pallas_step.py:1237-1239, without its TPU memory test)."""
        return (self.p_dtype == torch.float32 and ss.n_xspec == 0
                and ss.parallel and ss.nb + 1 <= mega.ZMAX)

    # -- the ladder ---------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _stretch(self, name: str, subt: bool, sync: bool = True):
        """One stretch of ``run_ion``: the span ``transport.<name>`` and,
        with MCS_SUBTIMERS=1 (`subt`), its seconds in self.subtimers,
        ended by a device synchronize where `sync` (measurement runs
        only)."""
        with span("transport." + name):
            t0 = time.perf_counter()
            yield
            if subt:
                if sync:
                    self._sync()
                self.subtimers[name] += time.perf_counter() - t0

    def _fixed(self, obj):
        """`obj` (the lane state or the tallies) copied into the XLA
        engine's fixed buffers of its kind."""
        buf = self._xla_bufs.get(type(obj))
        if buf is None:
            buf = self._xla_bufs[type(obj)] = stt.clone(obj)
            return buf
        return stt.copy_into(buf, obj)

    def _fixed_tables(self, tb: xla_step.StepTables) -> xla_step.StepTables:
        """The fixed tables of `tb`'s static configuration, loaded with
        its values."""
        fixed = self._xla_tables.get(tb.static())
        if fixed is None:
            fixed = self._xla_tables[tb.static()] = tb.clone()
            return fixed
        return fixed.load(tb)

    def run_ion(self, i_iter: int, i_ion: int, prof, it: IterationTallies,
                ckpt=None, resume_mid=None) -> IonResult:
        """All pcuts for one species (main_loops.jl:95-341 inner part).

        ``ckpt`` (parallel/checkpoint.MidCheckpointer) saves a
        segment-boundary checkpoint every ``ckpt.every`` pcut segments,
        right after the split (in the fused ladder such a segment is a
        sync point): the saved population is exactly what the
        next segment consumes, and a segment's keys depend only on (seed,
        iteration, species, pcut), so a resume continues on the same
        lanes.  ``resume_mid`` is a payload of load_mid_checkpoint for
        THIS (i_iter, i_ion), engine, momentum dtype and batch size; the
        population, the species' tallies and the segment index are
        restored and the ladder goes on from the saved boundary.  `it`
        is then the restored species-start copy, which already holds the
        injection's fast-push flux backfill.

        Under a mesh the host-split ladder saves the whole batch (and the
        accumulators summed over the ranks), so its checkpoint resumes on
        any world size; the mesh hybrid ladder saves nothing, and a resume
        into it raises (run.py:418-434)."""
        setup, cfg, bins = self.setup, self.setup.cfg, self.setup.bins
        s = cfg.species[i_ion]
        nb, b, dev = setup.nb, self.batch_size, self.device
        mesh, world = self.mesh, self.world
        ss = self.step_static(i_ion)
        k1 = self.uses_k1(ss)
        # the mesh hybrid ladder: K1 splitting each rank's own lanes
        hybrid = world > 1 and k1 and self.fused
        host = not self.fused or (world > 1 and not hybrid)
        mode = ("k1" if k1 else "xla") + ("-host" if host else "")
        if resume_mid is not None:
            if hybrid:
                raise ValueError(
                    "a mid checkpoint cannot resume into the mesh hybrid "
                    "ladder, which splits each rank's lanes on its own; "
                    "resume with fused=False (--no-fused)")
            _check_resume(resume_mid, i_iter, i_ion, mode, self.p_dtype,
                          None if host else b)
        if k1:
            mega.check_supported(ss)
        if ckpt is not None and hybrid:
            log.warning("mid checkpointing inactive for iter %d ion %d: the "
                        "mesh hybrid ladder splits each rank's lanes on "
                        "its own", i_iter, i_ion)
            ckpt = None
        if ckpt is not None:
            ckpt.reset(resume_mid["next_seg"] if resume_mid else 0)
        # MCS_SUBTIMERS=1: the transport phase split into population
        # setup, ladder and tally fetch in self.subtimers (_stretch)
        subt = os.environ.get("MCS_SUBTIMERS", "0") == "1"
        with self._stretch("pop_setup", subt):
            grids = self.segment_grids(prof, eps_target=it.eps_target,
                                       recv_pool=it.energy_pool)
            ion_key = rng.fold_in(rng.fold_in(self.base_key, i_iter), i_ion)

            if resume_mid is None:
                # injected population (main_loops.jl:126-153), host rng keyed
                # like the JAX package's
                pop = init_pop(
                    np.random.default_rng((cfg.random_seed, i_iter, i_ion)),
                    cfg.species, i_ion, cfg.inp_distr, cfg.energy_inj,
                    cfg.inj_weight, cfg.n_pts_inj, setup.x_grid_start,
                    cfg.rg0, cfg.eta_mfp, cfg.do_fast_push,
                    cfg.x_fast_stop_rg, cfg.beta0, cfg.gamma0, cfg.u0,
                    setup.x_grid_rg, prof.ux_sk, prof.gamma_sf)
                # fast-push analytic flux backfill (zeros when not applicable)
                it.pxx_flux += pop.pxx_flux
                it.pxz_flux += pop.pxz_flux
                it.energy_flux += pop.energy_flux

                n0 = len(pop.ptot_pf)
                pad = lambda a: np.concatenate(
                    [np.asarray(a), np.zeros(b - len(a), np.asarray(a).dtype)])
                state = stt.init_state(
                    pad(pop.weight), pad(pop.ptot_pf), pad(pop.pb_pf),
                    pad(pop.x_cm), pad(pop.i_grid).astype(np.int32),
                    pad(prof.ux_sk[pop.i_grid]), cfg.xn_per_fine,
                    setup.x_grid_stop, rng.fold_in(ion_key, 0), dev,
                    p_dtype=self.p_dtype)
                tal = stt.make_tallies(nb, bins.n_mom, bins.n_theta, dev,
                                       n_xspec=ss.n_xspec,
                                       n_tcut_slots=self.n_tcut_slots)
                reasons = torch.zeros(5, dtype=torch.int64, device=dev)
                esc = EscapeTallies.zeros(bins.n_mom, bins.n_theta, dev)
                start = pushes = 0
                trajectories = n0
                seg_new = []
            else:
                r = resume_mid
                state, tal, esc = r["state"], r["tal"], r["esc"]
                if state.device != dev:
                    # a kernel's wrapper would run its plain version there
                    raise ValueError(f"mid checkpoint state on "
                                     f"{state.device}, the engine on {dev}")
                reasons = r["reasons"]
                start = int(r["next_seg"])
                pushes, trajectories = int(r["pushes"]), int(r["trajectories"])
                # the segments before the save (a checkpoint of an older
                # port has no record of them)
                seg_new = list(r.get("n_new", ()))
                if host:
                    state = _fit_lanes(state, b)
                if world > 1 and mesh.rank > 0:
                    # the saved sums are every rank's: rank 0 carries them
                    for a in [*vars(tal).values(), *vars(esc).values(),
                              reasons]:
                        if isinstance(a, torch.Tensor):
                            a.zero_()
            if world > 1:
                state = multihost.global_state(state, mesh)
            splits = None
            if not k1:
                state, tal = self._fixed(state), self._fixed(tal)

        with self._stretch("ladder", subt):
            launched = launch_counts()
            if host:
                state, pushes, trajectories = self._ladder_per_segment(
                    i_iter, i_ion, prof, grids, ss, k1, ion_key, state, tal,
                    esc, reasons, start, pushes, trajectories, seg_new, ckpt,
                    mode, it)
            else:
                (state, pushes, trajectories, seg_new,
                 splits) = self._ladder_async(
                    i_iter, i_ion, prof, grids, ss, k1, ion_key, state, tal,
                    esc, reasons, start, (pushes, trajectories, seg_new), ckpt,
                    mode, it)
            for k, v in launch_counts().items():
                self.launches[k] += v - launched[k]
            if world > 1:
                shard.reduce_ion_accumulators(mesh, tal, esc, reasons)

        with self._stretch("tally_fetch", subt, sync=False):
            fin = stt.finalize_tallies(tal)
            it.pxx_flux += fin.pxx_flux.cpu().numpy()
            it.pxz_flux += fin.pxz_flux.cpu().numpy()
            it.energy_flux += fin.energy_flux.cpu().numpy()
            it.px_esc_upstream += float(fin.px_esc_up)
            it.energy_esc_upstream += float(fin.en_esc_up)
            it.sum_p_downstream += float(fin.sum_p_dw) * s.number_density
            it.sum_ke_downstream += float(fin.sum_ke_dw) * s.number_density
            if cfg.do_tcuts:
                it.weight_coupled[:, i_ion] += fin.weight_coupled.cpu().numpy()
                it.spectra_coupled[:, :, i_ion] += (
                    fin.spectra_coupled.cpu().numpy())
            if it.energy_pool is not None and not ss.is_electron:
                it.energy_pool += fin.energy_pool.cpu().numpy()
            self.n_pushes_total += pushes
            self.n_trajectories_total += trajectories
            out = IonResult(
                psd=fin.psd, therm_psd=fin.therm_psd,
                num_crossings=fin.num_crossings.cpu().numpy(),
                esc=esc.to_numpy(), spectra_sf=fin.spectra_sf.cpu().numpy(),
                spectra_pf=fin.spectra_pf.cpu().numpy(), n_pushes=pushes,
                n_trajectories=trajectories, n_new=seg_new, splits=splits,
                reason_counts=reasons.cpu().numpy(),
                retro_entries=float(fin.retro_entries),
                energy_received=float(fin.energy_received),
                energy_radiated=float(fin.energy_radiated))
        return out

    def _ladder_per_segment(self, i_iter, i_ion, prof, grids, ss, k1,
                            ion_key, state, tal, esc, reasons, start,
                            pushes, trajectories, seg_new, ckpt, mode, it):
        """The host-split ladder: a host loop of [drain -> finish -> split]
        a pcut that splits each segment's lanes on the host (ops/cuts.py)
        before it queues the next, on every rank the whole batch.
        Returns (state, pushes, trajectories); `seg_new` grows in
        place."""
        cfg, nb, b, dev = self.setup.cfg, self.setup.nb, self.batch_size, \
            self.device
        mesh, world = self.mesh, self.world
        p_pcut_hi = pcut_hi_momentum(cfg.energy_pcut_hi,
                                     cfg.species[i_ion].mass)
        scratch = (FinishScratch.for_lanes(state.weight.shape[0], dev)
                   if dev.type == "cuda" else None)
        for i_pcut in range(start, len(cfg.pcuts)):
            with span("ladder.segment"):
                sc = self.segment_scalars(i_ion, i_pcut, prof.bmag2)
                if k1:
                    mega.drain(state, mega.mega_tables(grids, sc, ss, dev),
                               tal)
                    # K1 derives the zone from position; restore it for the
                    # exit bookkeeping
                    ig = torch.searchsorted(grids.x_grid, state.x,
                                            right=True) - 1
                    state.igrid = ig.clamp(0, nb - 2).to(torch.int32)
                else:
                    xla_step.run_segment(
                        state, tal, self._fixed_tables(
                            xla_step.step_tables(grids, sc, ss, dev)),
                        compact_levels=self.compact_levels, graphs=self.graphs)
                with span("finish"):
                    finish_particles(state, esc, grids, sc, ss,
                                     scratch=scratch)
                    _count_exits(reasons, state)
                n_target = (cfg.n_pts_pcut if cfg.pcuts[i_pcut] < p_pcut_hi
                            else cfg.n_pts_pcut_hi)
                # every rank splits the whole batch alike and keeps its
                # shard; the next segment's population stays whole for a
                # checkpoint
                full = shard.gather_state(state, mesh) if world > 1 else state
                pushes += int(full.nsteps.sum(dtype=torch.int64))
                full, n_new = self._host_split(
                    full, n_target, rng.fold_in(ion_key, i_pcut + 1))
                state = (multihost.global_state(full, mesh) if world > 1
                         else full)
                seg_new.append(n_new)
                trajectories += n_new
                if n_new == 0:
                    log.info("iter %d ion %d: pcut chain ended at %d",
                             i_iter, i_ion, i_pcut)
                    break
                if not k1:
                    state = self._fixed(state)
                if ckpt is not None:
                    ckpt.maybe(i_pcut + 1, lambda: dict(
                        mode=mode, p_dtype=str(self.p_dtype), batch_size=b,
                        i_iter=i_iter, i_ion=i_ion, next_seg=i_pcut + 1,
                        state=full,
                        **self._summed(tal=tal, esc=esc, reasons=reasons),
                        pushes=pushes, trajectories=trajectories,
                        n_new=list(seg_new), it=it))
        return state, pushes, trajectories

    def _ladder_async(self, i_iter, i_ion, prof, grids, ss, k1, ion_key,
                      state, tal, esc, reasons, start, before, ckpt, mode,
                      it):
        """The fused ladder, K1's (run_ion_mega_hybrid,
        pallas_step.py:2232) or the XLA engine's (run_ion_xla_hybrid,
        fused_ion.py:216) on one process, and K1's mesh hybrid ladder
        (run_ion_mega_hybrid_sharded, shard.py:307) on every rank of a
        mesh, on mega.drive_ladder_async: every segment's [drain ->
        finish -> split] is queued without a host wait, and the host
        reads the chain's state only at the sync points (every
        MCS_HYBRID_SYNC_EVERY segments, and after a segment where the
        mid checkpointer `ckpt` is due) and at the end.  On one process
        on a card the host also stops queueing once a finished split it
        can see without waiting made no lane, which spares most dead
        segments (each ~5 ms of host work); on the CPU, and on every
        rank of a mesh, every dead segment up to the next sync point
        runs, as in the reference.

        Under a mesh each rank splits its own lanes to its share of the
        target and writes the split's counters (shard.SPLIT_FIELDS) into
        a row of a [segments, 6] float64 tensor on its device, with no
        host read; the rows since the last read at a sync point, and
        every row at the end, cross ranks in one gather
        (shard.gather_splits), and the chain's new lanes and pushes a
        segment are their sums over the ranks.  Every rank sees the same sums, so every rank stops
        at the same sync point and makes the same collectives; a rank's
        own dead split does not say that the chain died, so a mesh has
        no ``stop``.

        Every segment's tables go to the device in one copy before the
        first (mega.ladder_tables, ops/step.ladder_tables).  The exits by
        reason, pushes, new lanes and K5's drain headers accumulate on
        the device; a segment dispatched after the chain died, or after
        this rank's own split made no lane, adds to no counter (its
        exits are gated by the previous split's "made lanes", its pushes
        and new lanes are zero).  K5's headers are copied to pinned host
        memory behind each drain and read at the sync points, where the
        read of n_new has waited for them (helix.DEPOSIT_STEPS).
        `before` holds (pushes, trajectories, new lanes a segment) of the
        segments before `start`.  Returns (state, pushes, trajectories,
        new lanes a segment, splits), as the per-segment loop did: the
        list stops at the first zero; splits (every rank's split a
        segment, as long as that list) under a mesh, else None."""
        cfg, nb, b, dev = self.setup.cfg, self.setup.nb, self.batch_size, \
            self.device
        pushes0, trajectories0, seg_new0 = before
        n_seg = len(cfg.pcuts)
        scs = [self.segment_scalars(i_ion, i, prof.bmag2)
               for i in range(n_seg)]
        p_pcut_hi = pcut_hi_momentum(cfg.energy_pcut_hi,
                                     cfg.species[i_ion].mass)
        targets = [cfg.n_pts_pcut if pc < p_pcut_hi else cfg.n_pts_pcut_hi
                   for pc in cfg.pcuts]
        mesh = self.mesh if self.world > 1 else None
        if mesh is not None:
            # this rank's share of each target, its keys offset by its
            # first lane; the rows of its splits and their gathers
            shares = [shard.shard_target(t, mesh.size, mesh.rank)
                      for t in targets]
            offset = mesh.rank * state.weight.shape[0]
            rows = torch.zeros((n_seg, len(shard.SPLIT_FIELDS)),
                               dtype=torch.float64, device=dev)
            gathered = {}
        k5 = not k1 and dev.type == "cuda" and ss.parallel
        if k1:
            dw = tuple(float(torch.tensor(a[nb - 2], dtype=self.p_dtype))
                       for a in (prof.btot, prof.gamma_sf, prof.gamma_ef,
                                 prof.ux_sk))
            table = mega.ladder_tables(grids, scs, ss, dev, dw)
        else:
            table = xla_step.ladder_tables(grids, scs, ss, dev, packed=k5)
        heads = (torch.zeros((n_seg, helix.WS_HEADER), dtype=torch.int32,
                             pin_memory=True) if k5 else None)
        read = start        # the drains whose pushes DEPOSIT_STEPS holds
        # on one process on a card each split's n_new also lands in
        # pinned memory behind it, an event after it: the host stops
        # queueing once it sees a finished split that made no lane
        # (``died``), without a wait
        watch = dev.type == "cuda" and mesh is None
        news = (torch.zeros(n_seg, dtype=torch.int64, pin_memory=True)
                if watch else None)
        done, seen = [], start
        alive = torch.ones((), dtype=torch.int64, device=dev)
        scratch = (FinishScratch.for_lanes(state.weight.shape[0], dev)
                   if dev.type == "cuda" else None)

        def dispatch(i):
            nonlocal state, alive
            with span("ladder.segment"):
                if k1:
                    mt = table(i)
                    mass = mt.sf[mega.SF_M]
                    mega.drain(state, mt, tal)
                    # K1 derives the zone from position; restore it for the
                    # exit bookkeeping
                    ig = torch.searchsorted(grids.x_grid, state.x,
                                            right=True) - 1
                    state.igrid = ig.clamp(0, nb - 2).to(torch.int32)
                else:
                    tb, packed = table(i)
                    mass = tb.k["m"]
                    if k5:
                        head = xla_step.run_segment(
                            state, tal, tb, graphs=self.graphs, packed=packed,
                            wait=False)
                        if torch.is_tensor(head):
                            # (K5's block loop, run for comparisons, returns
                            # its steps and has counted its deposits)
                            heads[i].copy_(head, non_blocking=True)
                    else:
                        xla_step.run_segment(
                            state, tal, self._fixed_tables(tb),
                            compact_levels=self.compact_levels,
                            graphs=self.graphs)
                with span("finish"):
                    finish_particles(state, esc, grids, scs[i], ss, m=mass,
                                     scratch=scratch)
                    _count_exits(reasons, state, alive)
                nsteps = state.nsteps.sum(dtype=torch.int64)
                key = rng.fold_in(ion_key, i + 1)
                if mesh is None:
                    state, n_new = split_on_device(state, targets[i], key)
                else:
                    saved = state.status == stt.SAVED
                    n_saved = saved.sum()
                    # a masked sum: weight[saved] would wait on a nonzero
                    w_saved = torch.where(saved, state.weight, 0.0).sum(
                        dtype=torch.float64)
                    state, n_new = split_on_device(state, shares[i], key,
                                                   lane_offset=offset)
                    target = torch.full((), shares[i], dtype=torch.float64,
                                        device=dev)
                    # shard.SPLIT_FIELDS
                    rows[i] = torch.stack([v.to(torch.float64) for v in (
                        n_saved, target, n_new, nsteps, w_saved,
                        state.weight.sum(dtype=torch.float64))])
                alive = (n_new > 0).to(torch.int64)
                if watch:
                    news[i].copy_(n_new, non_blocking=True)
                    done.append(torch.cuda.Event())
                    done[-1].record()
                if not k1:
                    state = self._fixed(state)
                return n_new, nsteps

        def gather(i0, i1):
            got = shard.gather_splits(mesh, rows[i0:i1])
            for k, v in got.items():
                gathered.setdefault(k, np.zeros((n_seg, mesh.size),
                                                v.dtype))[i0:i1] = v
            return got["n_new"].sum(axis=1), got["nsteps"].sum(axis=1)

        def died(i):
            nonlocal seen
            while seen <= i and done[seen - start].query():
                if int(news[seen]) == 0:
                    return True
                seen += 1
            return False

        def check(i):
            nonlocal read
            self.sync_points += 1
            if k5:
                helix.DEPOSIT_STEPS += int(
                    helix.header_pushes(heads[read:i + 1]).sum())
                read = i + 1

        def capture(i, n_new, nsteps):
            if n_new[-1] == 0:
                return      # the chain has died: nothing to resume
            ckpt.maybe(i + 1, lambda: dict(
                mode=mode, p_dtype=str(self.p_dtype), batch_size=b,
                i_iter=i_iter, i_ion=i_ion, next_seg=i + 1, state=state,
                **self._summed(tal=tal, esc=esc, reasons=reasons),
                pushes=pushes0 + int(nsteps.sum()),
                trajectories=trajectories0 + int(n_new.sum()),
                n_new=seg_new0 + [int(v) for v in n_new], it=it))

        n_new, nsteps = mega.drive_ladder_async(
            dispatch, n_seg, check=check,
            capture=None if ckpt is None else capture, start=start,
            sync_at=None if ckpt is None else lambda i: ckpt.due(i + 1),
            stop=died if watch else None,
            read=None if mesh is None else gather)
        if k5:
            # the final read of n_new waited for every drain
            helix.DEPOSIT_STEPS += int(helix.header_pushes(heads[read:]).sum())
        ran = n_new[start:]
        dead = np.flatnonzero(ran == 0)
        if dead.size:
            ran = ran[:dead[0] + 1]
            log.info("iter %d ion %d: pcut chain ended at %d", i_iter, i_ion,
                     start + int(dead[0]))
        splits = None
        if mesh is not None:
            splits = [dict({k: v[i] for k, v in gathered.items()},
                           n_target=targets[i])
                      for i in range(start, start + len(ran))]
        return (state, pushes0 + int(nsteps.sum()),
                trajectories0 + int(ran.sum()),
                seg_new0 + [int(v) for v in ran], splits)

    def _summed(self, **acc) -> dict:
        """The accumulators `acc` summed over the ranks, as copies (for a
        checkpoint: the run goes on with this rank's own)."""
        if self.world == 1:
            return acc
        out = {k: (v.clone() if isinstance(v, torch.Tensor)
                   else stt.clone(v)) for k, v in acc.items()}
        shard.reduce_ion_accumulators(self.mesh, out["tal"], out["esc"],
                                      out["reasons"])
        return out

    def _host_split(self, state, n_target: int, seg_key):
        """The host-split ladder's step (run.py:674-693): the next
        segment's state from pcut_split's population, its momenta
        rebuilt from (|p|, pb), the saved PRP kept; (state, n_new)."""
        split = pcut_split(state, n_target, self.batch_size)
        if split is None:
            return state, 0
        cfg = self.setup.cfg
        new = stt.init_state(
            split.weight, np.hypot(split.pb, split.pperp), split.pb,
            split.x, split.igrid, split.ux_prev, cfg.xn_per_fine,
            self.setup.x_grid_stop, seg_key, self.device, phi=split.phi,
            downstream=split.downstream, inj=split.inj,
            acctime=split.acctime, tcut=split.tcut, xn_per=split.xn_per,
            p_dtype=self.p_dtype)
        new.prp_x = torch.from_numpy(split.prp_x).to(self.device, stt.X_DTYPE)
        return new, split.n

    def new_iteration_tallies(self, prof=None) -> IterationTallies:
        """Zeroed per-iteration accumulators (main_loops.jl:56-87), with
        the electrons' heating target when energy transfer is on
        (run.py:717-733)."""
        cfg, nb = self.setup.cfg, self.setup.nb
        n_mom = self.setup.bins.n_mom
        eps = np.zeros(nb)
        if cfg.energy_transfer_frac > 0 and prof is not None:
            eps = populate_eps_target(
                cfg.energy_transfer_frac, cfg.u0, cfg.gamma0,
                self.setup.u2, self.setup.gamma2, prof)
        return IterationTallies(
            pxx_flux=np.zeros(nb), pxz_flux=np.zeros(nb),
            energy_flux=np.zeros(nb),
            weight_coupled=np.zeros((self.n_tcut_slots, cfg.n_ions)),
            spectra_coupled=np.zeros((n_mom + 1, self.n_tcut_slots,
                                      cfg.n_ions)),
            energy_pool=np.zeros(nb), eps_target=eps)


def _count_exits(reasons: torch.Tensor, state: stt.ParticleState,
                 gate: torch.Tensor | None = None) -> None:
    """Add a segment's FINISHED lanes to `reasons` by exit reason and
    every other lane (SAVED, and the split's FINISHED reason-0 padding)
    to index 0, on the device with no host read; each lane counts `gate`
    (a 0-dim int64 tensor on the device) where given, else 1.

    The fused ladders gate on whether the split before the segment made
    lanes on this process, or under a mesh on this rank: so index 0
    counts the lanes of the segments that follow a split of this rank
    that made lanes (and of the first), and a rank whose own split made
    none, or a segment queued after the chain died, adds nothing to any
    index (their lanes are all padding).  Indices 1-4 are the same with
    and without the gate."""
    idx = torch.where(state.status == stt.FINISHED, state.reason, 0).long()
    one = torch.ones((), dtype=torch.int64, device=idx.device)
    reasons.index_add_(0, idx, (one if gate is None else gate).expand(
        idx.shape[0]))


def _check_resume(r: dict, i_iter: int, i_ion: int, mode: str,
                  p_dtype: torch.dtype, batch_size: int | None) -> None:
    """A mid checkpoint resumes only the (iteration, species), engine,
    momentum dtype and batch size that wrote it (the JAX package's
    run.py:284-290, 464-469); a host-split population (`batch_size`
    None) fits any batch that holds its lanes (_fit_lanes)."""
    if (r["i_iter"], r["i_ion"]) != (i_iter, i_ion):
        raise ValueError(
            "mid checkpoint is for (iter %d, ion %d), not (%d, %d)"
            % (r["i_iter"], r["i_ion"], i_iter, i_ion))
    got = (r["mode"], r["p_dtype"], int(r["batch_size"]))
    want = (mode, str(p_dtype),
            got[2] if batch_size is None else batch_size)
    if got != want:
        raise ValueError(
            "mid checkpoint was written by engine %r with %s momenta and "
            "%d lanes, but this run selects engine %r with %s momenta and "
            "%d lanes; rerun with the same configuration" % (got + want))


def _fit_lanes(state: stt.ParticleState, b: int) -> stt.ParticleState:
    """A host-split population (its lanes first, zero-weight FINISHED
    padding after them) cut or padded to `b` lanes, so that a mid
    checkpoint of one world size resumes on another."""
    n = state.weight.shape[0]
    if n == b:
        return state
    pad = (state.weight[b:] != 0) | (state.status[b:] != stt.FINISHED)
    if n > b and bool(pad.any()):
        raise ValueError(f"the mid checkpoint's population has lanes "
                         f"beyond this run's {b}")
    return stt.ParticleState(**{
        k: (v[:b] if n > b else torch.cat([v, torch.full(
            (b - n,), stt.FINISHED if k == "status" else 0,
            dtype=v.dtype, device=v.device)]))
        for k, v in vars(state).items()})


def populate_eps_target(energy_transfer_frac: float, u0: float,
                        gamma0: float, u2: float, gamma2: float,
                        prof) -> np.ndarray:
    """Electron energy-transfer target fraction per zone
    (populate_eps_target!, iter_init.jl:1-15): eps ~ (z - 1) scaled so
    the full compression reaches energy_transfer_frac (Ardaneh+ 2015)."""
    beta0 = u0 / K.C_CGS
    beta2 = u2 / K.C_CGS
    z_max = gamma0 * beta0 / (gamma2 * beta2)
    prefac = energy_transfer_frac / max(z_max - 1.0, 1e-30)
    eps = np.zeros(len(prof.ux_sk))
    moving = prof.ux_sk != u0
    z_curr = gamma0 * u0 / (prof.gamma_sf * prof.ux_sk)
    eps[moving] = prefac * (z_curr[moving] - 1.0)
    return eps


def pmax_cutoff(cfg: RunConfig, mass: float) -> float:
    """Per-species maximum momentum (get_pmax_cutoff, ion_init.jl:55-72)."""
    e0 = mass * K.C_CGS**2
    if cfg.emax > 0:
        g = 1.0 + cfg.emax / e0
        return mass * K.C_CGS * math.sqrt(g * g - 1.0)
    if cfg.emax_per_aa > 0:
        g = 1.0 + cfg.emax_per_aa / e0
        return mass * K.C_CGS * math.sqrt(g * g - 1.0)
    if cfg.pmax > 0:
        return cfg.pmax
    raise ValueError("maximum energy not set")


def pcut_hi_momentum(energy_pcut_hi_kev: float, mass: float) -> float:
    """Momentum above which the high-E particle count applies
    (pcut_hi, ion_init.jl:74-82)."""
    e_rm = energy_pcut_hi_kev * K.KEV_ERG / (K.MP_C2)
    if e_rm < E_REL_PT:
        return mass * K.C_CGS * math.sqrt(2.0 * e_rm)
    return mass * K.C_CGS * math.sqrt((e_rm + 1.0) ** 2 - 1.0)
