"""Top-level run driver: iteration fixed point + per-ion reductions.

Counterpart of the JAX package's engine/driver.py (run, ion_finalize;
MonteCarloScattering.jl:600-654, iter_finalize.jl:1-146,
ion_finalize.jl:1-84), with iteration and segment-boundary checkpoints,
resume, the per-species reductions overlapped with the next species'
transport on one device, and a mesh of ranks (parallel/shard.py) that
shards the particle batch: every rank reduces and smooths the same
summed tallies, and rank 0 writes the files.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.config import RunConfig, load_config
from ..utils.tracing import PhaseTimers, span
from ..models.emission import photon_calcs
from ..models.rankine_hugoniot import q_esc_calcs
from ..models.smoothing import (
    SmoothDiagnostics, set_gamma_adiab_grid, smooth_grid)
from ..ops import reduce as red
from ..ops.finish import EscapeTallies
from ..parallel import checkpoint as ck
from ..parallel import shard
from .run import IonResult, IterationTallies, TransportEngine
from .setup import RunSetup, build_setup

log = logging.getLogger("mcs.torch.driver")


@dataclass
class IonFinal:
    """Per-(iteration, ion) reduction products (ion_finalize.jl:1-84)."""

    dndp_therm: np.ndarray      # [n_mom+1, nb, 3] normalized dN/dp
    dndp_cr: np.ndarray         # [n_mom+1, nb, 3]
    zone_pop: np.ndarray        # [nb]
    zone_vol: np.ndarray
    p_psd_par: np.ndarray       # [nb]
    p_psd_perp: np.ndarray
    energy_density_psd: np.ndarray
    d2n_ef: np.ndarray | None   # ISM-frame d2N/(dp dcos)
    esc: EscapeTallies
    psd: np.ndarray
    therm_psd: np.ndarray
    num_crossings: np.ndarray
    spectra_sf: np.ndarray      # x_spec detector spectra [n_mom+1, nx]
    spectra_pf: np.ndarray
    n_pushes: int
    n_trajectories: int
    # the port's own counters (engine/run.py IonResult)
    n_new: list = None
    splits: list = None
    reason_counts: np.ndarray = None
    retro_entries: float = 0.0
    energy_received: float = 0.0
    energy_radiated: float = 0.0


@dataclass
class IterationResult:
    ion_finals: list
    tallies: IterationTallies
    diag: SmoothDiagnostics
    gamma_downstream: float
    q_esc_px: float
    q_esc_en: float
    px_esc_frac: float
    en_esc_frac: float
    profile_after: object = None
    emission: object = None     # models.emission.EmissionResult


@dataclass
class RunResult:
    setup: RunSetup
    iterations: list = field(default_factory=list)
    wall_time: float = 0.0
    n_pushes: int = 0
    n_trajectories: int = 0
    timers: object = None
    subtimers: dict | None = None     # MCS_SUBTIMERS=1 transport split
    # the XLA engine's drain blocks (ops/step.py GraphCache): the oblique
    # step's graph captures and their seconds, and the blocks' device
    # times under GraphCache.timing
    graphs: object = None
    # the kernel launches on this rank: the ladders' K1, K2, K5 and K5's
    # helix steps and plain blocks, and the finish kernel under "finish"
    # (ops/finish.py tally_escapes, one a segment) on a CUDA device
    # (engine/run.py launch_counts), and the reductions' rebinning
    # (ops/reduce.py rebin_dndp) under "rebin"
    launches: dict | None = None
    # this rank's mesh (parallel/shard.Mesh.summary): world size, rank,
    # device, backend, collectives (a species' gathers of the splits, a
    # sync point's and the end's on the mesh hybrid, a segment's on the
    # host split, and its reductions; barriers) and their seconds; None
    # on one device
    mesh: dict | None = None

    @property
    def last(self) -> IterationResult:
        return self.iterations[-1]


class _HostCopies:
    """Tensors copied to host memory without blocking the caller: on a
    CUDA device into pinned buffers with ``non_blocking`` and one event
    recorded after them on the current stream, so another thread can
    wait for the copies (``arrays``) without queueing a copy of its own
    behind work the main thread has enqueued since; on the CPU the
    tensors' own memory."""

    def __init__(self, tensors):
        self.event = None
        self.host = []
        for t in tensors:
            if t is None or t.device.type != "cuda":
                self.host.append(t)
                continue
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t.contiguous(), non_blocking=True)
            self.host.append(buf)
        if any(t is not None and t.device.type == "cuda" for t in tensors):
            self.event = torch.cuda.Event()
            self.event.record()

    def arrays(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return [None if t is None else t.numpy() for t in self.host]


def ion_finalize_start(setup: RunSetup, res: IonResult, prof, i_ion: int,
                       want_d2n_ef: bool):
    """Enqueue the per-species device reduction now and return
    ``finish() -> IonFinal``, which does the host work: the JAX
    package's split (driver.py:84-161), so that the driver can run
    species i's host reductions on a worker thread while species i+1
    transports.  The device half (the rebinning, and the copies of its
    outputs and of the PSDs to pinned host buffers) runs here on the
    caller's stream; ``finish`` waits on the copies' event, never on the
    stream, and then normalizes in float64 on the host: dN/dp in 3
    frames, zone populations, pressures, ISM-frame d2N
    (ion_finalize.jl:25-59).  The cell spreading of the rebinning is
    chosen by the environment variable MCS_I_APPROX (0, 1, 2 or 3;
    default 2)."""
    cfg, bins = setup.cfg, setup.bins
    s = cfg.species[i_ion]
    e0 = s.rest_energy

    # cell-weight spreading mode, read as the JAX driver reads it
    # (driver.py:112): 2, the reference's scalene triangle
    # (particle_counter.jl:72), unless MCS_I_APPROX says otherwise
    i_approx = int(os.environ.get("MCS_I_APPROX", "2"))

    zone_pop, zone_vol = red.zone_populations(
        setup.x_grid_cm, setup.i_shock, s.number_density, cfg.beta0,
        cfg.gamma0, cfg.jet_rad_pc, cfg.jet_sph_frac, prof.ux_sk,
        prof.gamma_sf)
    out = red.ion_reduce_device(
        res.psd, res.therm_psd, bins, e0, prof.gamma_sf, prof.ux_sk,
        cfg.gamma0, i_approx=i_approx, want_ef=want_d2n_ef, fetch=False)
    copies = _HostCopies(out + (res.psd, res.therm_psd))

    def finish() -> IonFinal:
        dn_cr, dn_th, d2n_tot, d2n_ef, psd, therm = copies.arrays()
        if want_d2n_ef:
            ef_norm = red.ef_zone_norm(psd, therm, zone_pop,
                                       res.num_crossings, s.number_density)
            d2n_ef = d2n_ef * ef_norm[None, None, :]

        dn_th, dn_cr = red.normalize_dndp(
            dn_cr, dn_th, bins.mom_edges, zone_pop, s.number_density,
            cfg.gamma0, prof.ux_sk, prof.gamma_sf)

        p_par, p_perp, e_dens = red.thermo_calcs(
            psd, therm, bins, s.mass, zone_pop, res.num_crossings,
            s.number_density, s.temperature, s.zz, cfg.beta0, cfg.gamma0,
            prof.ux_sk, prof.gamma_sf, d2n=d2n_tot)

        return IonFinal(
            dndp_therm=dn_th, dndp_cr=dn_cr, zone_pop=zone_pop,
            zone_vol=zone_vol, p_psd_par=p_par, p_psd_perp=p_perp,
            energy_density_psd=e_dens, d2n_ef=d2n_ef, esc=res.esc,
            psd=psd, therm_psd=therm, num_crossings=res.num_crossings,
            spectra_sf=res.spectra_sf, spectra_pf=res.spectra_pf,
            n_pushes=res.n_pushes, n_trajectories=res.n_trajectories,
            n_new=res.n_new, splits=res.splits,
            reason_counts=res.reason_counts,
            retro_entries=res.retro_entries,
            energy_received=res.energy_received,
            energy_radiated=res.energy_radiated)

    return finish


def ion_finalize(setup: RunSetup, res: IonResult, prof, i_ion: int,
                 want_d2n_ef: bool) -> IonFinal:
    """Per-species reductions, synchronously (ion_finalize_start)."""
    return ion_finalize_start(setup, res, prof, i_ion, want_d2n_ef)()


def _result(p):
    return p.result() if hasattr(p, "result") else p


def run(cfg: RunConfig | str, device="cuda", out_dir: str | None = None,
        p_dtype: torch.dtype = torch.float64, emission_hook=None,
        checkpoint: str | None = None, resume: str | None = None,
        mid_every: int = 0, fused: bool = True,
        compact_levels: int = -1, mesh=None) -> RunResult:
    """Full nonlinear run (main_loops.jl:52-391) on `device` (the CUDA
    card unless the caller asks for "cpu").  `p_dtype` is the momentum
    precision, float64 by default as in the JAX package
    (driver.py:173-210); float32 runs the configs K1 accepts on K1
    (engine/run.py).  Positions, PRP and times stay float64.
    `emission_hook(setup, prof, ion_finals, i_iter)` is called after
    each iteration's emission pass when photon production is enabled.
    `fused` False splits between pcut segments on the host, and
    `compact_levels` is the XLA engine's compaction depth (-1 auto, 0
    off): TransportEngine's.

    `checkpoint` writes the fixed-point state there after every
    iteration (an NPZ; ``.npz`` is appended to a name that lacks it);
    `resume` continues a run from such a file, or from a
    segment-boundary checkpoint, told apart by its content.
    `mid_every` > 0 (or MCS_MID_CKPT_EVERY), with `checkpoint`, also
    writes a segment-boundary checkpoint to ``checkpoint + '.mid'``
    every that many pcut segments, so that a run killed inside one
    species' ladder resumes there; MCS_MID_STOP_AFTER=1 stops the run
    (MidCheckpointStop) right after the first such save.

    Species i's host reductions run on a worker thread while species
    i+1 transports, unless MCS_OVERLAP_REDUCE=0 or the run has a mesh;
    the results are the same bits either way.  MCS_SUBTIMERS=1 fills
    ``RunResult.subtimers`` (population setup, ladder, tally fetch).

    `mesh` (parallel/shard.make_mesh, world above 1) shards the
    particle batch over ranks; every rank calls ``run`` alike and runs
    on ``mesh.device`` (`device` is then unused).  Every rank computes
    the reductions and smoothing from the summed tallies, the result's
    push and trajectory totals are global, and only rank 0 writes
    `out_dir`, checkpoints and calls `emission_hook`, the others
    waiting for it."""
    with span("run"):
        timers = PhaseTimers()
        t_start = time.time()
        if isinstance(cfg, str):
            cfg = load_config(cfg)
        with timers.phase("setup"):
            setup = build_setup(cfg)
        if mesh is not None and mesh.size == 1:
            mesh = None
        writer = mesh is None or mesh.rank == 0
        engine = TransportEngine(setup, device=device if mesh is None
                                 else mesh.device, p_dtype=p_dtype,
                                 fused=fused, compact_levels=compact_levels,
                                 mesh=mesh)
        prof = setup.profile
        nb = setup.nb
        if cfg.do_old_prof:
            from .old_profile import read_old_profile
            prof = read_old_profile(
                "mc_grid_old.dat", cfg, setup.x_grid_cm, cfg.n_old_skip,
                cfg.n_old_profs, cfg.n_old_per_prof)
            log.info("restarted profile from mc_grid_old.dat")

        gamma_grid = np.zeros((nb, 2))
        q_px_hist = np.zeros(cfg.n_itrs)
        q_en_hist = np.zeros(cfg.n_itrs)
        px_esc_hist = np.zeros(cfg.n_itrs)
        en_esc_hist = np.zeros(cfg.n_itrs)
        gamma_dw_hist = np.zeros(cfg.n_itrs)
        prof_weight_fac = cfg.prof_weight_fac
        i_start = 0

        mid_resume = None
        if resume is not None:
            if ck.is_mid_checkpoint(resume):
                mid_resume = ck.load_mid_checkpoint(resume, engine.device)
                got = mid_resume["driver"]
                engine.n_pushes_total = int(got["engine_pushes"])
                engine.n_trajectories_total = int(got["engine_trajs"])
            else:
                got = ck.load_checkpoint(resume)
            prof = got["profile"]
            gamma_grid = np.array(got["gamma_grid"])
            n = min(len(got["q_px_hist"]), cfg.n_itrs)
            for dst, key in ((q_px_hist, "q_px_hist"),
                             (q_en_hist, "q_en_hist"),
                             (px_esc_hist, "px_esc_hist"),
                             (en_esc_hist, "en_esc_hist"),
                             (gamma_dw_hist, "gamma_dw_hist")):
                dst[:n] = got[key][:n]
            prof_weight_fac = float(got["prof_weight_fac"])
            i_start = int(got["i_iter"])
            log.info("resumed from %s at iteration %d%s", resume, i_start,
                     (" (mid-iteration, species %d segment %d)"
                      % (mid_resume["i_ion"], mid_resume["next_seg"]))
                     if mid_resume is not None else "")

        mid_ckpt = None
        mid_every = mid_every or int(os.environ.get("MCS_MID_CKPT_EVERY", "0"))
        if checkpoint is not None and mid_every > 0:
            mid_ckpt = ck.MidCheckpointer(
                checkpoint + ".mid", every=mid_every,
                stop_after_save=os.environ.get("MCS_MID_STOP_AFTER",
                                               "0") == "1", mesh=mesh)

        rho0 = sum(sp.number_density * sp.mass for sp in cfg.species)
        result = RunResult(setup=setup)
        # a mesh's ranks keep their collectives in one order: no overlap
        # (driver.py:269-273)
        overlap = (mesh is None
                   and os.environ.get("MCS_OVERLAP_REDUCE", "1") == "1")
        pool = ThreadPoolExecutor(max_workers=1) if overlap else None
        rebin_launches = 0
        try:
            for i_iter in range(i_start, cfg.n_itrs):
                log.info("iteration %d/%d", i_iter + 1, cfg.n_itrs)
                it = engine.new_iteration_tallies(prof)
                pending = []
                i_ion_start = 0
                resume_tr = None
                if mid_resume is not None:
                    # the completed species' reductions come from the
                    # checkpoint; the species in flight restores its
                    # population and goes on at the saved segment
                    it = mid_resume["it"]
                    i_ion_start = int(mid_resume["i_ion"])
                    pending = list(mid_resume["driver"]["ion_finals"])
                    resume_tr, mid_resume = mid_resume, None
                for i_ion in range(i_ion_start, cfg.n_ions):
                    if mid_ckpt is not None:
                        def _ctx(pend=list(pending), ii=i_iter):
                            return dict(
                                profile=prof, gamma_grid=gamma_grid.copy(),
                                q_px_hist=q_px_hist.copy(),
                                q_en_hist=q_en_hist.copy(),
                                px_esc_hist=px_esc_hist.copy(),
                                en_esc_hist=en_esc_hist.copy(),
                                gamma_dw_hist=gamma_dw_hist.copy(),
                                prof_weight_fac=prof_weight_fac, i_iter=ii,
                                random_seed=cfg.random_seed,
                                engine_pushes=engine.n_pushes_total,
                                engine_trajs=engine.n_trajectories_total,
                                ion_finals=[_result(p) for p in pend])
                        mid_ckpt.context_fn = _ctx
                    with timers.phase("transport"), (
                            span("transport.electrons")
                            if cfg.species[i_ion].is_electron
                            else contextlib.nullcontext()):
                        res = engine.run_ion(i_iter, i_ion, prof, it,
                                             ckpt=mid_ckpt,
                                             resume_mid=resume_tr)
                    resume_tr = None
                    want_2d = (cfg.species[i_ion].is_electron
                               or i_ion == cfg.n_ions - 1)
                    with timers.phase("reductions"):
                        launched = red.LAUNCHES
                        fin = ion_finalize_start(setup, res, prof, i_ion,
                                                 want_2d)
                        rebin_launches += red.LAUNCHES - launched
                        pending.append(pool.submit(fin) if pool else fin())
                with timers.phase("reductions"), span("reductions.wait"):
                    ion_finals = [_result(p) for p in pending]

                # ---- iteration close-out (iter_finalize.jl:20-54) ----------
                px_esc_hist[i_iter] = it.px_esc_upstream / setup.f_px_upstream
                en_esc_hist[i_iter] = (it.energy_esc_upstream
                                       / setup.f_energy_upstream)
                p_par = sum(f.p_psd_par for f in ion_finals)
                p_perp = sum(f.p_psd_perp for f in ion_finals)
                e_dens = sum(f.energy_density_psd for f in ion_finals)
                gamma_grid = set_gamma_adiab_grid(
                    gamma_grid, i_iter, setup.x_grid_cm, setup.gamma2_rh,
                    p_par, p_perp, e_dens)
                gamma_dw_hist[i_iter] = 1.0 + (
                    it.sum_p_downstream / max(it.sum_ke_downstream, 1e-300))
                q_px, q_en = q_esc_calcs(
                    gamma_dw_hist[i_iter], setup.r_comp, setup.r_rh, cfg.u0,
                    cfg.beta0, cfg.gamma0, cfg.species, setup.gamma2,
                    setup.beta2, setup.u2)
                q_px_hist[i_iter] = q_px
                q_en_hist[i_iter] = q_en
                n_avg = min(i_iter + 1, 4)
                q_px_avg = q_px_hist[i_iter - n_avg + 1:i_iter + 1].mean()
                q_en_avg = q_en_hist[i_iter - n_avg + 1:i_iter + 1].mean()

                with timers.phase("smoothing"):
                    prof_new, diag, prof_weight_fac = smooth_grid(
                        i_iter, setup.i_shock, prof, cfg, setup.x_grid_rg,
                        gamma_grid, p_par, p_perp, it.pxx_flux, it.energy_flux,
                        q_px_avg, q_en_avg, setup.f_px_upstream,
                        setup.f_energy_upstream, setup.gamma2_rh, setup.u2,
                        setup.beta2, setup.gamma2, prof_weight_fac,
                        cfg.species[0].number_density,
                        cfg.species[0].temperature, rho0, cfg.use_custom_eps_b)

                itres = IterationResult(
                    ion_finals=ion_finals, tallies=it, diag=diag,
                    gamma_downstream=gamma_dw_hist[i_iter], q_esc_px=q_px_avg,
                    q_esc_en=q_en_avg, px_esc_frac=px_esc_hist[i_iter],
                    en_esc_frac=en_esc_hist[i_iter], profile_after=prof_new)
                if cfg.do_photons:
                    # photon production per shell/zone (ion_finalize.jl:72-78)
                    with timers.phase("emission"):
                        itres.emission = photon_calcs(
                            setup, prof, ion_finals, i_iter,
                            device=engine.device)
                    if emission_hook is not None and writer:
                        emission_hook(setup, prof, ion_finals, i_iter)
                result.iterations.append(itres)
                prof = prof_new

                if checkpoint is not None:
                    with timers.phase("checkpoint"):
                        if writer:
                            ck.save_checkpoint(
                                checkpoint, i_iter=i_iter + 1, profile=prof,
                                gamma_grid=gamma_grid, q_px_hist=q_px_hist,
                                q_en_hist=q_en_hist, px_esc_hist=px_esc_hist,
                                en_esc_hist=en_esc_hist,
                                gamma_dw_hist=gamma_dw_hist,
                                prof_weight_fac=prof_weight_fac,
                                random_seed=cfg.random_seed)
                    if (writer and mid_ckpt is not None
                            and os.path.exists(mid_ckpt.path)):
                        # the iteration checkpoint supersedes the mid state
                        # of this iteration
                        os.remove(mid_ckpt.path)
                    if mesh is not None:
                        shard.barrier(mesh)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)

        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        result.wall_time = time.time() - t_start
        result.n_pushes = engine.n_pushes_total
        result.n_trajectories = engine.n_trajectories_total
        result.timers = timers
        if mid_ckpt is not None:
            timers.totals["mid_checkpoint"] += mid_ckpt.seconds
            timers.counts["mid_checkpoint"] += mid_ckpt.n_saved
        result.subtimers = dict(engine.subtimers) or None
        result.graphs = engine.graphs
        result.launches = dict(engine.launches, rebin=rebin_launches)

        if out_dir is not None:
            from .io import write_outputs
            with timers.phase("io"):
                if writer:
                    write_outputs(result, out_dir)
                if mesh is not None:
                    shard.barrier(mesh)
        if mesh is not None:
            result.mesh = mesh.summary()
        return result
