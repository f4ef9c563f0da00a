"""Rank functions of the mesh tests (tests/test_torch_mesh*.py and the
two-rank tests of tests/test_torch_cuda.py).

Each runs in a rank process started by the port's
``parallel.multihost.spawn`` (or in the test process with ``mesh`` None
for the single-process reference) and returns plain NumPy results.  They
import torch and the port only; ``jax_loaded`` in every result says
whether a rank imported JAX after all.

The config is tests/test_parallel.py's small one (48 injected, 64 a
pcut, its first 3 pcuts) at a helix cap of CAP steps in both engines.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "tests", "data", "dsa_nonrel.toml")
CAP = 128
CASES = {
    # p_dtype, fused
    "xla-f64": ("float64", True),
    "xla-f64-host": ("float64", False),
    "k1-f32-host": ("float32", False),
    "k1-f32": ("float32", True),
    "k1-f32-wide": ("float32", True),
    "k1-f32-tail": ("float32", True),
}
# the config's own fields a case changes: 192 injected lanes, so that a
# world-2 mesh's ranks both hold injected lanes (48 lie in rank 0's
# shard)
CASE_FIELDS = {"k1-f32-wide": dict(n_pts_inj=192),
               "k1-f32-tail": dict(n_pts_inj=192)}
# pcuts above pmax a case appends to the config's (_dead_tail): its
# chain dies inside the ladder, off a sync point at 8 segments a sync,
# and the segments after the death are dispatched as no-ops
TAIL = {"k1-f32-tail": 2}


def small_cfg(**fields):
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(CFG)
    cfg.n_pts_inj = 48
    cfg.n_pts_pcut = cfg.n_pts_pcut_hi = 64
    cfg.pcuts = cfg.pcuts[:3]
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def _dead_ladder(cfg):
    """Pcuts above the highest momentum any lane can reach (pmax), so no
    segment saves a lane."""
    from montecarloscattering_jl_tpu_torch.engine.run import pmax_cutoff

    top = pmax_cutoff(cfg, cfg.species[0].mass) * 1e3
    cfg.pcuts = [top, 3 * top, 9 * top]


def _dead_tail(cfg, n: int):
    """`n` pcuts above the highest momentum any lane can reach appended
    to the config's."""
    from montecarloscattering_jl_tpu_torch.engine.run import pmax_cutoff

    top = pmax_cutoff(cfg, cfg.species[0].mass) * 1e3
    cfg.pcuts = list(cfg.pcuts) + [top * 3 ** k for k in range(n)]


def engine_case(mesh, case: str, dead: bool = False, device="cpu",
                sync_every: str | None = None):
    """One species of the small config through ``TransportEngine.run_ion``
    (`case` of CASES; `dead`: pcuts above pmax, the helix cap 24), on
    the mesh's device or, without one, on `device`, at
    MCS_HYBRID_SYNC_EVERY `sync_every` where given (else its default).
    With every population the host split was handed (the whole batch
    after each segment's drain) on rank 0, and on every rank the keys of
    the lanes each on-device split made (``split_keys``), every lane of
    each population it made (``split_lanes``: its output, one entry a
    dispatched segment), the mesh hybrid's record of every rank's split
    (``splits``) and the fused ladder's sync points."""
    import importlib

    import torch

    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    # the module: the package's `run` is the driver's function
    run_mod = importlib.import_module(
        "montecarloscattering_jl_tpu_torch.engine.run")
    torch.set_num_threads(1)
    pd, fused = CASES[case]
    cfg, cap = small_cfg(**CASE_FIELDS.get(case, {})), CAP
    if dead:
        _dead_ladder(cfg)
        cap = 24
    if case in TAIL:
        _dead_tail(cfg, TAIL[case])
    setup = build_setup(cfg)
    dev = device if mesh is None else mesh.device
    eng = run_mod.TransportEngine(setup, dev, p_dtype=getattr(torch, pd),
                                  fused=fused, mesh=mesh)
    split_inputs, split_keys, split_lanes = [], [], []
    real_split, real_device_split = run_mod.pcut_split, run_mod.split_on_device

    def recording_split(state, *a, **kw):
        # copies: on the CPU the arrays share the engine's buffers
        split_inputs.append({k: v.copy() for k, v in
                             state.to_numpy().items()})
        return real_split(state, *a, **kw)

    def recording_device_split(state, *a, **kw):
        # the keys of the lanes the split made, as one uint64 a lane
        new, n_new = real_device_split(state, *a, **kw)
        split_lanes.append({k: v.copy() for k, v in
                            new.to_numpy().items()})
        live = new.status == stt.ACTIVE
        word = lambda k: (k[live].cpu().numpy().view(np.uint32)
                          .astype(np.uint64))
        split_keys.append((word(new.key0) << np.uint64(32))
                          | word(new.key1))
        return new, n_new

    run_mod.pcut_split = recording_split
    run_mod.split_on_device = recording_device_split
    c0 = 0 if mesh is None else mesh.collectives
    env = os.environ.get("MCS_HYBRID_SYNC_EVERY")
    if sync_every is not None:
        os.environ["MCS_HYBRID_SYNC_EVERY"] = sync_every
    try:
        with wl.helix_cap(cap):
            it = eng.new_iteration_tallies(setup.profile)
            res = eng.run_ion(0, 0, setup.profile, it)
    finally:
        run_mod.pcut_split = real_split
        run_mod.split_on_device = real_device_split
        if env is None:
            os.environ.pop("MCS_HYBRID_SYNC_EVERY", None)
        else:
            os.environ["MCS_HYBRID_SYNC_EVERY"] = env
    rank = 0 if mesh is None else mesh.rank
    return dict(
        rank=rank, batch=eng.batch_size, levels=eng.compact_levels,
        pushes=res.n_pushes, trajectories=res.n_trajectories,
        n_new=list(res.n_new), splits=res.splits, split_keys=split_keys,
        split_lanes=split_lanes, sync_points=eng.sync_points,
        n_seg=len(cfg.pcuts),
        reasons=res.reason_counts,
        psd=res.psd.cpu().numpy(), therm_psd=res.therm_psd.cpu().numpy(),
        num_crossings=res.num_crossings, spectra_sf=res.spectra_sf,
        esc=vars(res.esc), pxx_flux=it.pxx_flux, pxz_flux=it.pxz_flux,
        energy_flux=it.energy_flux,
        split_inputs=split_inputs if rank == 0 else None,
        mesh=None if mesh is None else mesh.summary(),
        collectives=0 if mesh is None else mesh.collectives - c0,
        jax_loaded="jax" in sys.modules)


def engine_cases(mesh, cases):
    """engine_case for each (case, dead) or (case, dead, sync_every) of
    `cases`, in one rank process."""
    return [engine_case(mesh, c, d, sync_every=(s[0] if s else None))
            for c, d, *s in cases]


def mid_kill_case(mesh, out_root: str):
    """The small config at float64 through ``driver.run`` with a
    segment-boundary checkpoint after every segment, killed at the first
    save (MCS_MID_STOP_AFTER=1); returns whether the stop reached this
    rank."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.parallel import checkpoint as ck
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    torch.set_num_threads(1)
    os.environ["MCS_MID_STOP_AFTER"] = "1"
    try:
        with wl.helix_cap(CAP):
            run(small_cfg(n_itrs=1), "cpu", mesh=mesh, mid_every=1,
                checkpoint=os.path.join(out_root, "kill.npz"))
    except ck.MidCheckpointStop:
        return True
    finally:
        del os.environ["MCS_MID_STOP_AFTER"]
    return False


def driver_case(mesh, out_root: str):
    """The small config at float64 (the XLA engine), 1 iteration through
    ``driver.run`` with an iteration checkpoint, each rank given its own
    output directory and checkpoint path; then the same config resumed
    from rank 0's checkpoint to iteration 2 on the same mesh."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.parallel import shard
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    torch.set_num_threads(1)
    rank = 0 if mesh is None else mesh.rank
    out = os.path.join(out_root, f"rank{rank}")
    ck = os.path.join(out_root, f"ck{rank}.npz")
    with wl.helix_cap(CAP):
        a = run(small_cfg(n_itrs=1), "cpu", out_dir=out, checkpoint=ck,
                mesh=mesh)
        if mesh is not None:
            shard.barrier(mesh)
        b = run(small_cfg(n_itrs=2), "cpu",
                resume=os.path.join(out_root, "ck0.npz"), mesh=mesh)
    prof = a.iterations[0].profile_after
    killed = mid_kill_case(mesh, out_root)
    return dict(killed=killed,
        rank=rank, files=sorted(os.listdir(out)) if os.path.isdir(out)
        else [], ck_written=os.path.exists(ck),
        profile={k: np.asarray(getattr(prof, k)) for k in
                 ("ux_sk", "uz_sk", "utot", "gamma_sf", "btot")},
        pushes=a.n_pushes, trajectories=a.n_trajectories,
        resumed=(b.n_pushes, b.n_trajectories), mesh=a.mesh,
        jax_loaded="jax" in sys.modules)


def nccl_all_reduce_on_card_0(mesh):
    """An NCCL all_reduce of a tensor on card 0 (a rank of a mesh built
    for the CPU, so that make_mesh maps no card)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    t = torch.ones(1, device="cuda:0")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t)


def fail_on_rank_1(mesh):
    """Rank 1 raises while rank 0 waits for it in a barrier."""
    from montecarloscattering_jl_tpu_torch.parallel import shard

    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    shard.barrier(mesh)
