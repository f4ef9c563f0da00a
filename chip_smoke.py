"""Smoke test of montecarloscattering_jl_tpu_torch on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and builds every
   kernel of the port with nvcc for sm_90a, one nvcc per source, all
   started together: K1 (csrc/mega_step.cu, one instance per flag word
   of ops/mega.py INSTANCES), K2/K3 (csrc/psd_hist.cu), K5
   (csrc/helix_step.cu, the instances of ops/helix.py INSTANCES) and
   the rebinning (csrc/rebin.cu) and the finish kernel (csrc/finish.cu),
   with each kernel's registers, stack and spills.
2. ``k1``: holds K1 against its plain PyTorch version (ops/mega.py
   step_twin) on the card, on the flagship population:
   tests/data/dsa_nonrel.toml, 65,536 injected lanes at pcut index 2.
   First one 64-step launch from the same state (per-lane fields; timed
   enqueued only, and through ``mega.launch`` with its host wait), then
   a full drain with the helix cap lowered to 512 steps (status counts,
   step totals, tallies).  Then K1 alone drains the same population at
   the config's helix cap, and the science protons of phase 3 at the
   science cap: wall ms ending in a synchronize, launches, pushes,
   pushes/s, the host waits inside the drain (none).
3. ``flags``: the same with K1's static-flag branches on, on
   configs/baseline.toml (electron density set to 1) at 65,536 lanes
   placed to reach every branch (``flag_population``): protons of the
   science variant (tcuts, retro walk, custom eps_B, pool donation),
   electrons (radiative loss, received energy) and protons with the
   shipped no-scatter / no-DSA switches.  Window and drain as in 2, the
   pool, tcut and counter tallies included; each case must run the K1
   instance compiled for its flag word (the shipped switches: the one
   that reads the flags at run time).  Then the custom f(r_g)
   mean-free-path law (alpha = 1.5, r_ref = 2 r_g0) on the science
   protons and electrons, and a window at alpha = 1, where K1's
   per-lane cos_max must give the standard law's lanes back: after one
   step every float field within 16 float32 ulp, no lane divergent.
4. ``hist``: holds K2 and K3 (ops/hist.py) against their plain versions
   on the card, through the histogram probe (scripts/probe_hist.py): K2
   at the main path's shape (one record per lane of the 69,632-lane
   batch into the 4,428 x 102 PSD) and on the probe's 2^21 records, K3
   at bands 1,024 and 2,048 and on the edge cases of its contract (the
   band at cell 0, a band past the array's end, all weights zero, wild
   boundary indices, one address), K2 at the probe's 2^16-record P4
   shape; each timed beside its plain version and, for K2/K4, beside
   one ``index_add_`` of the same records (the library call, never used
   by the port), and checked against float64.  Every kernel and the
   ``index_add_`` are timed under CUDA-graph replay, the way the
   plain step's graphs launch K2, and eagerly; K2 also on the helix step's
   own tensors (int64 zones, float64 weights).
4b. ``k5``: holds K5 (ops/helix.py, the XLA engine's helix step: one
   persistent launch a pcut segment, the drain, or a window of n steps)
   against the plain step (ops/step.py) on the card: (a) its in-kernel
   uniforms against rng.lane_uniforms_xla, bit for bit, on 69,632 keys
   at counters 0, 1, 63, 1,000, 2^31 - 1 and random ones; (b) one
   64-step window of the f64 flagship population (phase f64's config,
   its 69,632 injected lanes at pcut 0) against the plain block; (c)
   the drain of the same lanes through run_segment (``hold_drain``): a
   full segment at the engine's helix cap, and one capped at K5_SEG_CAP
   steps, each against the plain step's CUDA graphs and K5's block loop
   (``blocks=True``) at the auto compaction depth: one K5 launch, no
   host read inside it, the loop's steps, every lane bit for bit against
   the loop (FL_JRET included) and equal to the plain step's; (d) a
   window and a drain capped at DRAIN_CAP of each flag case at float64
   (scripts/workloads.py helix_flag_case: the science protons and
   electrons, the shipped switches, the f(r_g) law on both) and of the
   f32 flagship with detectors.  Windows per lane within K5_TOL (integer
   fields equal on all but MAX_DIVERGENT of the lanes); the float64
   tallies within K5_TALLY_TOL of their largest entry, the PSD within
   HIST_TOL; each case prints the instance it ran, K5's ms (CUDA
   events), the plain step's under graph replay and the bound; a case
   with an instance of its own also runs the run-time instance (the same
   bits, its time); the drain's instance prints its registers and the
   blocks an SM holds.
4b. ``rebin``: the reductions' dN/dp rebinning (csrc/rebin.cu, ops/
   reduce.py ``rebin_dndp``) on the benchmark cell's shapes
   (benchmark/configs/nonrel_nonlinear.toml: 101 zones, 54 x 41 PSD
   cells, its profile's boosts; seeded spectrum-like CR and thermal
   PSDs) at i_approx 2: the kernel against the plain version on the CPU
   (``_dn_frames_plain``) to REBIN_TOL of each output's largest entry,
   two launches bit for bit; its ms (CUDA events around REBIN_REPS
   launches queued behind a sleeping kernel), its bound (the PSDs read and the rows written once, or
   the corner transforms and the nonzero fractions at the float64
   rate) and the plain version's ms on the card (host clock ending in a
   synchronize: its launches and host waits).
4c. ``finish``: the finish kernel (csrc/finish.cu, ops/finish.py
   ``tally_escapes``) on the main path's data: of one iteration of the
   nonrel cell (65,536 protons a pcut, K5, 54 x 41 PSD cells), the
   finish with the most upstream finishers, and the same lanes all in
   one cell; each case must touch all four binned tallies.  Bit for bit
   against its
   twin on the CPU (``tally_twin``) and on a second launch, within
   FINISH_TOL of each cell against index_put_ (``tally_index_put``); its
   ms and the index_put_ path's on the card (CUDA events around
   FINISH_REPS calls queued behind a sleeping kernel) beside its byte
   bound.  Every driven run below counts one finish launch a segment
   its ladders queued (``check_finish``).
5. ``f32``: drives the K1 path: ``engine.driver.run`` on the flagship
   nonlinear config with float32 momenta (65,536 particles per pcut,
   smoothing on, 2 iterations); checks that every transport launch went
   through K1 and none through the twin, that the output files are
   written, and the test-particle power-law slope of iteration 1.  Its
   fused ladders run under torch's sync debug mode
   (``counted_ladders``, here and in phases science and f64): a species'
   ladder may wait on the host once a sync point (drive_ladder_async's
   read of the chain, every MCS_HYBRID_SYNC_EVERY segments) plus
   LADDER_WAITS_EXTRA, and not between two sync points; the waits, sync
   points and the lines that waited are printed.
6. ``science``: the gamma0 = 5 baseline's science variant on K1 (f32):
   configs/baseline.toml with scattering, DSA and smoothing on, 4 pcuts
   per decade, the helix cap at 200,000 steps and 4x the particle
   counts (scripts/flagship_baseline.py --dsa --pcuts-per-decade 4
   --max-helix-steps 200000 --n-pts-mult 4), 1 iteration.  Every drain
   must launch K1; the coupled CSVs are written; per species the exit
   reasons, tcut weights, pool, retro entries and radiated energy are
   printed, and the proton side must show tcut weight and retro or age
   activity.
7. ``electrons32``: examples/03_electron_synch_ic.toml as shipped,
   photon production on, on K1 (float32), every pcut at the default
   helix cap: both species' drains launch K1 (none the twin or the XLA
   engine), the electrons' rad-loss branch runs inside it, the electron
   species must push and exit, and the photon files are written.
8. ``sed``: the SED flagship (scripts/flagship_sed.py of the port):
   examples/04_hadronic_sed.toml, gamma0 = 5, protons and electrons,
   radiative losses, 9 pcuts, photons on, 16,384 particles per pcut,
   float32 momenta, from config to the photon files.  Every drain must
   launch K1; the synchrotron, IC and pion shells and the total SED
   must be non-empty; L_synch / L_IC must lie within a factor 30 of
   U_B / U_CMB; and the emission pass on the card must agree with the
   per-zone NumPy loop on the same reductions to rtol 1e-5 on every bin
   above 1e-90.
9. ``electrons``: examples/03 with photon production off and the
   baseline's energy-transfer fraction 0.1 at float64 momenta (the XLA
   engine, K5), cut to its first 4 pcuts and a 2,000-step helix cap: the
   ions' pool, the electrons' received and radiated energy must be
   positive.  Float64, because a thermal proton's gamma - 1 (~2e-8) and
   an electron's loss in a step (~1e-10 of its momentum) are below a
   float32 ulp, so at float32 they read 0.  The reference removes a
   lane as radiated only when its momentum after the loss is <= 0,
   which p / (1 + dlnp) never is, so the exit count is printed, not
   required.
10. ``f64``: drives the XLA-engine path, the JAX CLI's default: the
   flagship config with float64 momenta and two x_spec detectors at
   -/+0.5 r_g0, 1 iteration, cut to its first 4 pcuts; checks that every
   segment was one K5 drain (its PSD deposits through K2's warp deposit
   inside it; no host read inside it, no plain block, no standalone K2,
   no K1) and that the drains' pushes are the run's, that the output files
   with mc_xspec.dat are written, that both detectors' spectra are
   positive, and the slope; prints the pushes against the same run on
   the plain step (PR 8).
11. ``resume``: phase f64's run again, with a segment-boundary
    checkpoint after every segment, stopped by MCS_MID_STOP_AFTER=1 at
    the first save (before the second of its 4 segments) and resumed
    from it to the end: every segment of both runs a K5 drain; against
    phase f64's run, pushes, trajectories and exit reasons exactly (one
    iteration of protons: no lane reads an atomically summed value),
    fluxes and spectra within 1e-9 of their largest entry, the PSDs
    within 1e-4 of max |psd|; the checkpoint's bytes and save times.
12. ``shipped``: configs/baseline.toml as shipped (no-scatter, no-DSA)
    at float64 on the XLA engine, 1 iteration: every segment a K5
    drain, the coupled CSVs written, pushes and trajectories
    printed; both chains die at their first segment, and the run again
    at MCS_HYBRID_SYNC_EVERY=1 (no dead segment queued) gives every
    species' new lanes, pushes, exits and escape tallies in the same
    bits (``dead_tail``).
13. ``nonlinear``: the nonlinear flagship (scripts/flagship_nonlinear.py
    of the port) at 65,536 a pcut, 10 iterations on K1, an iteration
    checkpoint each; uninterrupted, killed by the stop hook at its first
    segment-boundary save of iteration 5, and resumed to iteration 10.
    The max pxx_norm of the last odd iteration is below iteration 1's
    and nearer 1 in both runs; iterations 1-4 of the killed run have the
    uninterrupted run's pushes and trajectories; iterations 5-10 of the
    resumed run agree with the uninterrupted run's within 3 times the
    spread of two uninterrupted runs (NONLINEAR_SPREAD).
14. ``compact``: the XLA engine's live-lane compaction ladder, which
    K5's drain makes moot (no lane moves).  This phase runs phase f64's
    config again at compact_levels=0 and holds it to phase f64's run
    (the auto depth, the CLI's default) as phase resume does, prints
    both runs' wall, transport and graph captures, then runs one segment
    of the flagship's injected population (69,632 lanes, pcut 0) through
    K5's drain and through K5's block loop at levels 0 and auto
    (``run_segment(..., blocks=True)``: windows down to 2,176): every
    per-lane field bit-identical, each one's device ms and the loop's ms
    a step at each window size (CUDA events around each launch).
15. ``oblique``: the oblique step at float64 on the flagship population
   (the plain step: the oblique branches are not in K5):
    64 steps at theta_B = 0 through the oblique branches against the
    parallel ones (integer fields equal, float fields within 1e-12
    relative), and 64 steps at theta_B = 30 degrees in a uniform flow
    (each ACTIVE lane's |p| within 1e-12).
16. ``kw``: the Keshet-Waxman run (scripts/flagship_keshet_waxman.py) at
    float32 on K1 with the host split: N_g = 8,000, 8,192 particles a
    pcut, the helix cap 800,000, pmax 2,400 m_p c; every drain launches
    K1 (each timed, a synchronize around it); the fitted index within
    0.25 of s_KW.
17. ``endurance``: scripts/flagship_endurance.py on K1 at 65,536 a pcut
    for about 8 blocks: allocated device memory drifts by less than 1%
    from block 2 to the last; the rate per block is printed.
18. ``mesh``: the particle batch sharded over MESH_RANKS ranks
    (parallel/multihost.spawn, one process a rank) on the one card,
    joined by gloo: two processes sharing a card, which is what one card
    can check (NCCL takes one card a rank).  Any rank's failure fails
    the phase.  (1) and (2) run ``engine.driver.run`` on every rank.
    (1) K1 with the host split: phase f32's config, 1 iteration,
    ``fused=False``, against the same run in this process: pushes,
    trajectories and exit reasons exactly, fluxes within RESUME_FLUX_TOL
    and the PSDs within HIST_TOL of their largest entry.  (2) The mesh
    hybrid ladder (K1, fused, each rank splitting its own lanes, on
    ``drive_ladder_async``: every rank's splits gathered once a sync
    point and once at the end): phase f32's run again on the mesh, held
    to phase f32's run statistically (the slope gate; pushes and
    trajectories of iteration 1 within MESH_HYBRID_TOL) and every
    segment's split to its contract (``split_faults``: each rank's share
    of the target, its new lanes, and its new lanes' weight within
    MESH_SPLIT_WEIGHT_TOL of its saved lanes'); each rank's ladders
    under ``counted_ladders`` (host waits at most a sync point's plus
    LADDER_WAITS_EXTRA a species, printed with the sync points), and its
    collectives exactly a gather a sync point and one at the end, the
    17 reductions a species and MESH_BARRIERS.  (2b) The same at
    MCS_HYBRID_SYNC_EVERY=1: every rank's pushes, new lanes and splits'
    integers those of (2).  (3) The XLA engine: phase compact's segment (the
    flagship's 69,632 injected lanes, pcut 0, f64) with each rank
    draining its shard at the per-shard auto compaction depth; the
    gathered lanes bit-identical in every field to phase compact's.
    Every rank's drains launch K1 (none the twin) in (1) and (2), and
    its segment in (3) is one K5 drain on every rank.  Each part prints its
    wall, pushes, pushes/s, launches a rank and the collectives with
    their seconds.  (4) With two cards or more, (1) again under NCCL, a
    card a rank; with one, a line says it did not run.
19. ``cli``: the port's CLI as a user runs it, ``python -m
    montecarloscattering_jl_tpu_torch CONFIG -o DIR``, one process a
    config, on configs/baseline.toml and examples/01-04 as shipped (no
    cut: each fits CLI_TIMEOUT), at the CLI's default float64 (K5's
    drain) and with ``--f32`` (K1): exit code 0, the completion line
    with the config's iterations and nonzero pushes, and the file set;
    each wall time; then scripts/pod_scale.py as shipped (every visible
    card, one here: world 1, float64 on K5) and with ``--f32`` (K1):
    exit code 0, its two result lines, pushes, its wall.

The float64 phases' segments (f64, resume, shipped, electrons, compact,
mesh part 3) are K5 drains, one launch a segment with no host read
inside it (``check_engine``), and a driven run's pushes are its
drains'.  Every phase that fails raises, so the script exits non-zero; it also
exits non-zero without a CUDA device.  The line before the last is a
JSON summary of the kernels, the last line the device record.
"""

import contextlib
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ELECTRONS = os.path.join(ROOT, "examples", "03_electron_synch_ic.toml")
WINDOW = 64
DRAIN_CAP = 512
# per-lane bounds of K1 against the twin on the card: both round every
# f32 operation once (nvcc -fmad=false) and call the same CUDA libm, so
# state agrees to a few ulp; lanes whose step count or status differ
# (a transcendental one ulp apart on the other side of a threshold)
# are counted and may be at most 0.1% of the lanes
ULP_BOUND = 16 * 2.0 ** -23    # relative; momenta relative to |p|
MAX_DIVERGENT = 1e-3
TALLY_RTOL = 1e-4                          # f32 atomics in any order
# K2/K3 against their plain versions: f32 sums in another order
HIST_TOL = 1e-4                            # of max |psd|
# the f64 paths' cuts: pcut segments kept, and examples/03's helix cap
F64_PCUTS = 4
ELECTRON_CAP = 2_000
# the SED flagship's particles per pcut (scripts/flagship_sed.py), and
# the bound of the card's emission pass against the per-zone NumPy loop
# on every bin above EMISSION_FLOOR (tests/test_device_emission.py)
SED_PER_PCUT = 16_384
EMISSION_RTOL, EMISSION_FLOOR = 1e-5, 1e-90
# phase resume: fluxes and spectra of the resumed f64 run against phase
# f64's, relative to their largest entry (float64 atomics in another
# order; the PSDs take HIST_TOL, float32 atomics)
RESUME_FLUX_TOL = 1e-9
# phase nonlinear: iterations, the kill at the first mid save of
# iteration KILL_ITER + 1, the mid cadence in segments, and the spread
# of two uninterrupted runs: the largest difference between two of eight
# runs over iterations 1-10 (scripts/probe_driver.py --spread 8, NVIDIA
# H100 80GB HBM3, 700 W).  After iteration 1 the profile is smoothed from
# tallies that K1 sums with atomics in no fixed order, so two runs could
# part; measured, they differ only in the last bits of the float64 flux
# sums (max pxx_norm within 20 ulps), which the float32 zone fields K1
# reads do not resolve: pushes, trajectories and escaping fractions are
# the same in every run
NONLINEAR_ITERS, KILL_ITER, NONLINEAR_MID_EVERY = 10, 4, 2
NONLINEAR_SPREAD = dict(pushes=0, trajectories=0, px_esc_frac=0.0,
                        en_esc_frac=0.0, pxx_norm_max=4.440892098500626e-15)
# phase oblique: steps of each block, and the bound of the per-lane
# comparisons (tests/test_torch_oblique.py's)
OBLIQUE_STEPS, OBLIQUE_TOL = 64, 1e-12
# phase kw: the sweep's N_g = 8000 point (kw_sweep.json: the JAX package
# measured s_fit 4.214 against s_KW 4.202 there, on a TPU) and the
# script's own tolerance
KW_NG, KW_PER_PCUT, KW_CAP, KW_PMAX, KW_TOL = 8000.0, 8192, 800_000, 2400.0, 0.25
# phase endurance: about 8 blocks of the flagship at wl.LANES a pcut
ENDURANCE_TRAJECTORIES = 3.5e6
# phase mesh: ranks; the bound of the mesh hybrid ladder's pushes and
# trajectories in iteration 1 against phase f32's run, written into
# PERF.md before the phase's first chip run (a split's new lanes
# n_saved * (target // n_saved) jump by up to 1/multiplicity); and the
# bound of each segment's split on weight, rank by rank: a new lane's
# weight is one float32 rounding of its saved lane's weight over the
# multiplicity (relative error <= 2^-24), so the new lanes' weight is the
# saved weight within 2^-24 of it, and 2^-23 leaves room for the float64
# sums.  Over the run the counts are not held to a bound: a rank that
# saves no lane makes no new lane, so the mesh's later segments may run
# on half the lanes of one process's (PERF.md, PR 9)
MESH_RANKS = 2
MESH_HYBRID_TOL = 0.10
MESH_SPLIT_WEIGHT_TOL = 2.0 ** -23
# phase mesh's parts, in order: "hybrid@1" is the mesh hybrid again at
# MCS_HYBRID_SYNC_EVERY=1
MESH_PARTS = ("host", "hybrid", "hybrid@1", "xla")
# the collectives of a mesh hybrid part on a rank: a species' ladder
# gathers its splits once a sync point and once at its end
# (engine/run.py _ladder_async), then sums its accumulators in 17
# all_reduces (parallel/shard.py reduce_ion_accumulators: 9 tally, 7
# escape and 1 exit-reason fields); the part adds 2 barriers, one before
# it (mesh_rank) and one after its files are written (engine/driver.py)
MESH_REDUCTIONS, MESH_BARRIERS = 17, 2
# the integer fields of a mesh hybrid split (parallel/shard.py
# SPLIT_FIELDS), held equal at MCS_HYBRID_SYNC_EVERY 8 and 1
SPLIT_INTS = ("n_saved", "target", "n_new", "nsteps")
# JAX CPU run of the shipped baseline (1 iteration, --f32, XLA engine),
# for comparison with the port's counts
SHIPPED_JAX_PUSHES, SHIPPED_JAX_TRAJECTORIES = 980_000, 196
# the H100 SXM's published peaks: HBM bytes/s and the
# float32 rate outside the tensor cores, which bound_ms also applies to
# K1's integer operations
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# K1's operations per helix step, counted from csrc/mega_step.cu on the
# flagship's branches: two threefry2x32 blocks (~230 integer ops), the
# eight uniforms (~32), the zone search (~28), ~8 hypot (~64), the frame
# transform, escapes and scattering (~75), the movement with one
# reflection try (~35), the PSD bins and tallies (~60) and the
# downstream logic (~30)
K1_OPS_PER_PUSH = 560
# bytes of one lane's state K1 reads (80) and writes (68)
K1_STATE_BYTES = 148
HIST_RECORD_BYTES = 16                     # cell, lo, hi, w
# phase k5: K5 against the plain step on the card, per lane (momenta
# relative to |p|) and in every float64 tally (of its largest entry;
# the PSD takes HIST_TOL), lanes whose integer fields differ counted and
# held to MAX_DIVERGENT; the uniforms' counters; timing repeats
K5_TOL = 1e-12
K5_TALLY_TOL = 1e-9
K5_INTS = ("status", "reason", "nsteps", "igrid", "tcut", "flags")
K5_COUNTERS = (0, 1, 63, 1000, 2 ** 31 - 1)
K5_CAP, K5_REPS = 10_000, 10
# phase k5's drains: the flag cases' segments capped at DRAIN_CAP steps
# (a multiple of 64: the capped lanes keep FL_JRET), and the flagship's
# capped at K5_SEG_CAP (not one: the block loop runs on to 1,024 and
# clears it)
K5_SEG_CAP = 1000
# phase cli: the shipped configs the CLI runs as they are, at its
# default (float64 momenta: the XLA engine, K5's drain), and each run's
# time limit
CLI_CONFIGS = ("configs/baseline.toml", "examples/01_test_particle.toml",
               "examples/02_nonlinear_smoothed.toml",
               "examples/03_electron_synch_ic.toml",
               "examples/04_hadronic_sed.toml")
CLI_TIMEOUT = 240
# the H100 SXM's float64 rate outside the tensor cores
F64_OPS_S = 34e12
# K5's floating-point operations a push, counted from csrc/helix_step.cu
# on the flagship's branches (a moving proton, two x_spec detectors,
# about one step in three crossing a boundary): the zone fields and the
# gyro radius (2), four hypot (~30), the pmax test, gyro period and
# scattering (~30 with cos and two sqrt), the acceleration time and
# movement (~20), the zone search (7 compares), the shock-frame momentum
# and its momentum bin (~30), the crossing's angle bin and flux values
# (~10 a step on average), the detector entries (~25), the downstream
# tests (~15) and the casts and selects around them (~60); the three
# Threefry blocks (~230 integer operations) are not counted
K5_OPS_PER_PUSH = 230
# bytes of one lane's state K5 reads and writes a launch (float64 and
# float32 momenta: 112 + 96, 84 + 72)
K5_STATE_BYTES = {8: 208, 4: 156}
# phase rebin: the kernel against the plain version (of each output's
# largest entry: the same float64 arithmetic summed in another order),
# and its timing launches; float64 operations counted a corner of a
# frame's table (a hypot, a sqrt and a log10 among ~14) and a nonzero
# (frame, cell, bin) fraction at i_approx 2 (two triangle CDFs, the
# peak and the span, ~25) and its product and sum a PSD (3)
REBIN_TOL = 1e-12
REBIN_REPS = 50
REBIN_SLEEP_CYCLES = 100_000_000       # ~50 ms at the H100's clocks
REBIN_OPS_CORNER, REBIN_OPS_FRACTION, REBIN_OPS_PSD = 14, 25, 3
# phase finish: the finish kernel against its twin (bit for bit) and
# against index_put_ (each cell within FINISH_TOL of its value: the same
# float64 addends summed in another order, tests/test_torch_finish_kernel
# .py), its timing launches, and the bytes it must move: every lane's two
# flags, a downstream finisher's two int64 bins and its wwf, an upstream
# one's bins and its wwf, we and wd, each touched cell read and written
FINISH_TOL = 1e-12
FINISH_REPS = 50
FINISH_LANE_BYTES, FINISH_CELL_BYTES = 2, 16
FINISH_DOWNSTREAM_BYTES, FINISH_UPSTREAM_BYTES = 24, 40
# phase f64's pushes on the plain step (PERF.md §5, PR 8)
F64_PLAIN_PUSHES = 536_113_343
# the host waits a species' fused ladder (engine/run.py _ladder_async)
# may make besides one a sync point, counted by torch's sync debug mode:
# the one copy of the species' segment tables to the card before its
# first segment (ops/state.py upload), and drive_ladder_async's read of
# the segments' counts after its last
LADDER_WAITS_EXTRA = 2


def fail(msg: str) -> None:
    raise RuntimeError(msg)


@contextlib.contextmanager
def sync_every(value: str):
    """MCS_HYBRID_SYNC_EVERY set to `value` within the block."""
    old = os.environ.get("MCS_HYBRID_SYNC_EVERY")
    os.environ["MCS_HYBRID_SYNC_EVERY"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["MCS_HYBRID_SYNC_EVERY"]
        else:
            os.environ["MCS_HYBRID_SYNC_EVERY"] = old


def bound(n_bytes: float, n_ops: float,
          ops_s: float = F32_OPS_S) -> tuple[float, str]:
    """The least time [ms] the card could take: bytes over the memory
    rate or operations over their rate (the float32 rate unless given),
    whichever is larger."""
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, n_ops / ops_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def compare_lanes(a, b, tol: float = ULP_BOUND,
                  ints=("status", "reason", "nsteps", "flags", "tcut")) -> dict:
    """Per-lane differences between two states (the kernel's = a, the
    plain version's = b): lanes whose integer fields `ints` differ, and
    float fields beyond `tol` relative on the others."""
    import torch
    out = {}
    same = torch.ones_like(a.status, dtype=torch.bool)
    for name in ints:
        eq = getattr(a, name) == getattr(b, name)
        out[f"mismatch_{name}"] = int((~eq).sum())
        same &= eq
    ptot = torch.hypot(b.pb.double(), b.pperp.double())
    worst = 0.0
    n_off = 0
    for name in ("pb", "pperp", "phi", "ux_prev", "xn_per", "t_step", "x",
                 "prp_x", "acctime"):
        va = getattr(a, name).double()
        vb = getattr(b, name).double()
        scale = ptot if name in ("pb", "pperp") else vb.abs()
        rel = ((va - vb).abs() / scale.clamp(min=1e-300))[same]
        rel = torch.where(va[same] == vb[same], 0.0, rel)
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
        n_off += int((rel > tol).sum())
        out[f"maxrel_{name}"] = float(rel.max()) if rel.numel() else 0.0
    out["float_lanes_over_bound"] = n_off
    out["divergent_lanes"] = int((~same).sum())
    return out


# the finalized tallies K1 and the twin must agree on, as totals
TALLY_FIELDS = ("psd", "therm_psd", "pxx_flux", "pxz_flux", "energy_flux",
                "num_crossings", "px_esc_up", "en_esc_up", "sum_p_dw",
                "sum_ke_dw", "weight_coupled", "spectra_coupled",
                "energy_pool", "retro_entries", "energy_received",
                "energy_radiated")


def compare_totals(tag, fk, ftw) -> dict:
    """Totals of every finalized tally, K1 (fk) against the twin (ftw);
    fails beyond TALLY_RTOL."""
    out = {}
    for name in TALLY_FIELDS:
        a = float(getattr(fk, name).double().sum())
        c = float(getattr(ftw, name).double().sum())
        out[name] = c
        if abs(a - c) > TALLY_RTOL * max(abs(c), 1e-300) and (a or c):
            fail(f"{tag} {name}: K1 {a!r} twin {c!r}")
    return out


def hold_k1(tag, tabs, st0, fresh_tal, drain: bool = True,
            word: int = 0) -> dict:
    """K1 against its twin from the same state: one WINDOW-step launch
    (per-lane fields, tally totals, both timed: plain, kernel, kernel,
    plain), then, with `drain`, a drain to DRAIN_CAP steps.  K1 must run
    the instance compiled for `word` (ops/mega.py INSTANCES)."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import mega, state as stt
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    clone_state, time_launches, LANES = (wl.clone_state, wl.time_launches,
                                         wl.LANES)
    inst = mega.instance_of(tabs.flags, tabs.is_electron)
    if mega.INSTANCES[inst] != word:
        fail(f"{tag}: flags {tabs.flags:#x} run K1's instance "
             f"{mega.INSTANCES[inst]:#x}, not {word:#x}")
    # ---- one 64-step launch from the same state -------------------------
    s_k, t_k = clone_state(st0), fresh_tal()
    s_t, t_t = clone_state(st0), fresh_tal()
    torch.cuda.synchronize()
    mega.launch(s_k, tabs, t_k, WINDOW, 10_000)
    mega.step_twin(s_t, tabs, t_t, WINDOW, 10_000)
    torch.cuda.synchronize()
    lanes = compare_lanes(s_k, s_t)
    print(f"{tag} window per-lane:", json.dumps(lanes))
    if lanes["divergent_lanes"] > MAX_DIVERGENT * LANES:
        fail(f"{tag} window: {lanes['divergent_lanes']} lanes diverge")
    if lanes["float_lanes_over_bound"] > MAX_DIVERGENT * LANES:
        fail(f"{tag} window: {lanes['float_lanes_over_bound']} float "
             f"fields beyond {ULP_BOUND:.3g} relative")
    psd_err = float((t_k.psd_diff - t_t.psd_diff).abs().max())
    # bytes of the tally entries the window added to, each read and
    # written once (the entries no lane touched need no traffic)
    touched = sum(2 * int(torch.count_nonzero(v)) * v.element_size()
                  for v in (getattr(t_t, f.name)
                            for f in dataclasses.fields(t_t))
                  if isinstance(v, torch.Tensor))
    win = compare_totals(f"{tag} window", stt.finalize_tallies(t_k),
                         stt.finalize_tallies(t_t))
    print(f"{tag} window psd: max_abs_err={psd_err:.6e}; twin totals "
          f"{json.dumps(win)}")
    pushes_w = int((s_t.nsteps - st0.nsteps).sum())

    def k1_window(prepared):
        # enqueued only: the events time the card (the launch and the
        # memset of its two counters), not a host wait
        prepared.enqueue(WINDOW, 10_000)

    def k1_window_waited(s, t):
        # through the wrapper that returns the ACTIVE count: validation
        # and one host wait a launch, as every earlier reading of this
        # window was taken
        mega.launch(s, tabs, t, WINDOW, 10_000)

    def twin_window(s, t):
        mega.step_twin(s, tabs, t, WINDOW, 10_000)

    prep = lambda n: [(clone_state(st0), fresh_tal()) for _ in range(n)]
    launches = lambda n: [(mega.K1Launch(s, tabs, t),) for s, t in prep(n)]
    # plain, kernel, kernel, plain
    tw1 = time_launches(twin_window, prep(2))
    k1a = time_launches(k1_window, launches(11))
    k1b = time_launches(k1_window, launches(11))
    k1w = time_launches(k1_window_waited, prep(11))
    tw2 = time_launches(twin_window, prep(2))
    k1_ms, tw_ms = (k1a + k1b) / 2, (tw1 + tw2) / 2
    print(f"{tag} window {WINDOW} steps x {LANES} lanes ({pushes_w} "
          f"pushes): K1 {k1a:.4f} / {k1b:.4f} ms "
          f"({pushes_w / k1_ms / 1e3:.1f} M pushes/s), with a host wait a "
          f"launch {k1w:.4f} ms, twin {tw1:.2f} / "
          f"{tw2:.2f} ms ({pushes_w / tw_ms / 1e3:.3f} M pushes/s)")
    out = dict(max_abs_err=psd_err, ms=k1_ms, waited_ms=k1w, plain_ms=tw_ms,
               pushes=pushes_w, tally_bytes=touched, window=win,
               instance=inst)
    if not drain:
        return out

    # ---- a full drain (helix cap lowered) ------------------------------
    res = {}
    for who in ("twin", "k1"):
        s, t = clone_state(st0), fresh_tal()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if who == "k1":
            mega.drain(s, tabs, t, max_helix=DRAIN_CAP)
        else:
            n_act = int((s.status == 0).sum())
            k = 0
            while n_act > 0 and k < DRAIN_CAP // mega.STEPS + 2:
                n_act = mega.step_twin(s, tabs, t, mega.STEPS, DRAIN_CAP)
                k += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res[who] = (s, stt.finalize_tallies(t), dt)
    (sk, fk, dk), (stw, ftw, dtw) = res["k1"], res["twin"]
    ck = torch.bincount(sk.status, minlength=3).tolist()
    ct = torch.bincount(stw.status, minlength=3).tolist()
    rk = torch.bincount(sk.reason, minlength=5).tolist()
    nk, nt = int(sk.nsteps.sum()), int(stw.nsteps.sum())
    div = compare_lanes(sk, stw)["divergent_lanes"]
    print(f"{tag} drain status K1 {ck} twin {ct}; reasons K1 {rk}; nsteps "
          f"K1 {nk} twin {nt}; divergent lanes {div}")
    if div > MAX_DIVERGENT * LANES:
        fail(f"{tag} drain: {div} lanes diverge")
    if any(abs(x - y) > div for x, y in zip(ck, ct)):
        fail(f"{tag} drain status counts differ beyond the divergent lanes")
    if abs(nk - nt) > div * DRAIN_CAP:
        fail(f"{tag} drain step totals differ beyond the divergent lanes")
    drained = compare_totals(f"{tag} drain", fk, ftw)
    print(f"{tag} drain to {DRAIN_CAP}-step cap: K1 {dk:.3f} s "
          f"({nk / dk / 1e6:.2f} M pushes/s), twin {dtw:.3f} s "
          f"({nt / dtw / 1e6:.3f} M pushes/s); twin totals "
          f"{json.dumps(drained)}")
    return dict(out, drain=drained, reasons=rk)


def k1_full_drain(tag, case, cap: int, repeats: int = 3):
    """K1 alone drains the case's population at the helix cap `cap`,
    `repeats` times (scripts/workloads.py timed_drain: wall ms ending in
    a synchronize, K1 launches, pushes and pushes/s; here also the host's
    waits for a launch inside the drain); returns the fastest."""
    from montecarloscattering_jl_tpu_torch.ops import mega
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    runs = []
    for _ in range(repeats):
        waits = mega.HOST_WAITS
        runs.append(dict(wl.timed_drain(case, cap),
                         host_waits=mega.HOST_WAITS - waits))
    print(f"{tag} full drain at a {cap}-step cap, K1 alone: "
          f"{json.dumps(runs)}")
    if any(r["host_waits"] >= r["launches"] for r in runs):
        fail(f"{tag}: the drain waits on the host once a launch")
    return max(runs, key=lambda r: r["pushes_per_s"])


def kernel_vs_twin(dev) -> dict:
    """K1 against its twin on the flagship population (phase k1), with
    the bound of its window, and K1's full drains."""
    from montecarloscattering_jl_tpu_torch.ops import mega
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    case = wl.flagship_case(dev)
    out = hold_k1("flagship", case["tabs"], case["st0"], case["fresh_tal"])
    out["bound_ms"], out["bound_by"] = bound(
        wl.LANES * K1_STATE_BYTES + out["tally_bytes"],
        out["pushes"] * K1_OPS_PER_PUSH)
    print(f"flagship window bound: {out['bound_ms']:.6f} ms "
          f"({out['bound_by']}; {out['tally_bytes']} B of tally entries "
          f"touched)")
    out["full_drain"] = k1_full_drain("flagship", case,
                                      mega.MAX_HELIX_STEPS)
    out["science_drain"] = k1_full_drain(
        "science protons", wl.flag_case(wl.FLAG_CASES[0], dev),
        wl.SCIENCE_CAP)
    return out


def hold_alpha1(tag, tabs, tabs_std, st0, fresh_tal) -> None:
    """One K1 step with the custom f(r_g) law at alpha = 1 (`tabs`)
    against one with the standard law (`tabs_std`) from the same state:
    exp(log(.) * 0) = 1, so the per-lane cos_max is the precomputed one
    to a float32 rounding, and so are the lanes."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import mega
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    s_f, s_s = wl.clone_state(st0), wl.clone_state(st0)
    mega.launch(s_f, tabs, fresh_tal(), 1, 10_000)
    mega.launch(s_s, tabs_std, fresh_tal(), 1, 10_000)
    torch.cuda.synchronize()
    lanes = compare_lanes(s_f, s_s)
    print(f"{tag} one step against the standard law:", json.dumps(lanes))
    if lanes["divergent_lanes"] or lanes["float_lanes_over_bound"]:
        fail(f"{tag}: alpha = 1 differs from the standard law: {lanes}")


def kernel_vs_twin_flags(dev) -> dict:
    """K1 against its twin with the static-flag branches on (phase
    flags): the baseline (electron density 1) at the science variant's
    switches for protons and electrons, and at the shipped switches for
    protons, on flag_population's lanes."""
    from montecarloscattering_jl_tpu_torch.ops import mega
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    out = {}
    for case in wl.FLAG_CASES:
        tag, i_ion, science, want, frg_alpha, word = case
        c = wl.flag_case(case, dev)
        tabs, st0, fresh_tal = c["tabs"], c["st0"], c["fresh_tal"]
        if frg_alpha == 1.0:
            # the window only, and one step against the standard law
            out[tag] = hold_k1(f"flags {tag}", tabs, st0, fresh_tal,
                               drain=False, word=word)
            std = dataclasses.replace(c["ss"], frg_rg0_cm=0.0)
            hold_alpha1(f"flags {tag}", tabs,
                        mega.mega_tables(c["grids"], c["sc"], std, dev), st0,
                        fresh_tal)
            continue
        r = out[tag] = hold_k1(f"flags {tag}", tabs, st0, fresh_tal,
                               word=word)
        w, d = r["window"], r["drain"]
        fired = {
            "tcut weight": d["weight_coupled"] if "do_tcuts" in want
            and i_ion == 0 else 1.0,
            "pool": d["energy_pool"] if "do_energy_transfer" in want
            and i_ion == 0 else 1.0,
            "received": d["energy_received"] if i_ion == 1 else 1.0,
            "radiated": w["energy_radiated"] if i_ion == 1 else 1.0,
            "retro entries": d["retro_entries"] if science and i_ion == 0
            else 1.0,
            "no-scatter exits": r["reasons"][1] if not science else 1.0}
        dead = [k for k, v in fired.items() if not v > 0]
        if dead:
            fail(f"flags {tag}: no {dead} (the branch did not fire)")
    return out


def expected_files(cfg):
    names = ["mc_out.dat", "mc_grid.dat", "mc_profile.json"]
    suffixes = ([f"_{i + 1}" for i in range(cfg.n_itrs)]
                if cfg.do_multi_dndps else [""])
    for sfx in suffixes:
        names += [f"mc_dNdp_grid_therm{sfx}.dat", f"mc_dNdp_grid_CR{sfx}.dat"]
    if cfg.do_tcuts:
        names += ["mc_coupled_weights.csv", "mc_coupled_spectra.csv"]
    if cfg.x_spec:
        names.append("mc_xspec.dat")
    if cfg.do_photons:
        names += ["photon_pion_decay_grid.dat", "photon_synch_grid.dat",
                  "photon_IC_grid.dat", "photon_pion_summed.dat",
                  "photon_synch_summed.dat", "photon_IC_summed.dat",
                  "photon_tot.dat", "photon_tot_summed.dat"]
    return names


def hist_phase(dev) -> dict:
    """K2, K3 and K4 (K2 at P4's shape) against their plain versions on
    the same records, with the histogram probe (scripts/probe_hist.py):
    ns/record of each, errors against the plain version and against
    float64."""
    from montecarloscattering_jl_tpu_torch.scripts import probe_hist as ph

    print("histogram kernels (scripts/probe_hist.py):")
    out = ph.run(dev)
    for name, r in out.items():
        err, scale = r["max_abs_err"], r["max_abs_psd"]
        # a record set that touches no entry (all weights zero) must
        # leave the PSD exactly zero: err 0 and, below, no error vs f64
        if (not (scale > 0 or r["touched_entries"] == 0)
                or not math.isfinite(err) or err > HIST_TOL * scale):
            fail(f"{name}: max abs err {err!r} against the plain version "
                 f"(max |psd| {scale!r})")
        if not r["rel_err_f64"] < 1e-4:
            fail(f"{name}: max rel err {r['rel_err_f64']!r} against "
                 f"float64")
    return out


def rebin_phase(dev) -> dict:
    """The rebinning kernel on the benchmark cell's shapes (phase
    rebin): held to the plain version, timed beside its bound and the
    plain version on the card."""
    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import reduce as red
    from montecarloscattering_jl_tpu_torch.utils import load_config

    setup = build_setup(load_config(os.path.join(
        ROOT, "benchmark", "configs", "nonrel_nonlinear.toml")))
    bins, cfg = setup.bins, setup.cfg
    e0 = cfg.species[0].rest_energy
    gam = np.asarray(setup.profile.gamma_sf, np.float64)
    nb, n_bins = len(gam), bins.n_mom + 1
    g = np.random.default_rng(17)
    shape = (n_bins, bins.n_theta + 1, nb)
    p_fac = 10.0 ** (-0.3 * np.arange(n_bins))[:, None, None]
    host = [g.random(shape) * p_fac * (g.random(shape) < f)
            for f in (0.7, 0.3)]
    psds = [torch.from_numpy(a).to(dev) for a in host]
    want = red._dn_frames_plain([torch.from_numpy(a) for a in host], bins,
                                e0, gam, cfg.gamma0, 2)
    got = red._dn_frames(psds, bins, e0, gam, cfg.gamma0, 2)
    errs = []
    for name, a, b in zip(("dn_cr", "dn_th"), want, got):
        scale = float(a.abs().max())
        err = float((a - b.cpu()).abs().max())
        if not (scale > 0 and err <= REBIN_TOL * scale):
            fail(f"rebin {name}: max abs err {err!r} against the plain "
                 f"version (largest entry {scale!r})")
        errs.append(err / scale)
    tab = red.bin_tables(bins, dev)
    frames = red.on_device(red.frame_grids(gam, cfg.gamma0), dev)
    first = red.rebin_dndp(psds, tab, *frames, e0, 2)
    again = red.rebin_dndp(psds, tab, *frames, e0, 2)
    if not torch.equal(first.view(torch.int64), again.view(torch.int64)):
        fail("rebin: two launches on one input differ")
    # the launches queue up behind a sleeping kernel, so the events time
    # the card's work and not the host's enqueue
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(REBIN_SLEEP_CYCLES)
    ev[0].record()
    for _ in range(REBIN_REPS):
        red.rebin_dndp(psds, tab, *frames, e0, 2)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / REBIN_REPS
    plain = []
    for _ in range(3):
        t0 = time.perf_counter()
        red._dn_frames_plain(psds, bins, e0, gam, cfg.gamma0, 2)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    # the nonzero fractions: each zone's frame and the ISM's, whose
    # fractions every zone's ISM row takes
    clp = lambda gm: red.corner_logp(gm, e0, tab.mom_edges.cpu(),
                                     tab.cos_bounds.cpu())
    edges = tab.edges_log.cpu()
    nnz = sum(int((red.rebin_matrix(clp(float(x)), edges) != 0).sum())
              for x in gam)
    nnz += nb * int((red.rebin_matrix(clp(cfg.gamma0), edges) != 0).sum())
    n_corners = 2 * nb * (bins.n_mom + 2) * (bins.n_theta + 2)
    n_ops = (n_corners * REBIN_OPS_CORNER
             + nnz * (REBIN_OPS_FRACTION + 2 * REBIN_OPS_PSD))
    n_bytes = 8 * (2 * np.prod(shape) + 2 * 2 * nb * n_bins)
    bound_ms, bound_by = bound(n_bytes, n_ops, F64_OPS_S)
    out = dict(max_rel_err=max(errs), ms=ms, plain_ms=min(plain),
               bound_ms=bound_ms, bound_by=bound_by, nonzero_fractions=nnz,
               corners=n_corners)
    print(f"rebin (cell shapes, {nb} zones, {n_bins} x {bins.n_theta + 1} "
          f"cells): {json.dumps(out)}")
    return out


def finish_phase(dev) -> dict:
    """The finish kernel on the main path's data (phase finish): every
    finish of one iteration of the nonrel cell (65,536 protons a pcut,
    K5 at float64, 54 x 41 PSD cells) recorded as ``finish_lanes``
    handed it on, and of those the one with the most lanes finished
    upstream or past pmax, as it is ("drained") and with every lane in
    one cell ("one cell").  Each case must add into all four binned
    tallies (downstream and upstream finishers both), so that none is
    held vacuously at +0.0.  Held to the twin bit for bit, to index_put_
    within FINISH_TOL of each cell and to itself on a second launch;
    timed beside its bound and the index_put_ path on the card (today's
    CPU path, which the card ran before the kernel)."""
    import copy

    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import finish as fin
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = copy.deepcopy(load_config(os.path.join(
        ROOT, "benchmark", "configs", "nonrel_nonlinear.toml")))
    cfg.n_itrs = 1
    b = build_setup(cfg).bins
    seen = []
    lanes_of = fin.finish_lanes

    def recorded(*a, **kw):
        x = lanes_of(*a, **kw)
        seen.append({k: v.clone() for k, v in x.items() if k != "px"})
        return x

    fin.finish_lanes = recorded
    try:
        run(cfg, device=dev, p_dtype=torch.float64)
    finally:
        fin.finish_lanes = lanes_of
    ups = [int(x["is_up"].sum()) for x in seen]
    drained = seen[ups.index(max(ups))]
    print(f"finish: {len(seen)} finishes recorded, upstream finishers "
          f"{ups}; the case is finish {ups.index(max(ups))}")
    zeros = torch.zeros_like(drained["ip"])
    binned = ("esc_psd_dw", "esc_psd_up", "esc_energy_eff", "esc_num_eff")
    fresh = lambda d: fin.EscapeTallies.zeros(b.n_mom, b.n_theta, d)
    n = drained["ip"].shape[0]
    scratch = fin.FinishScratch.for_lanes(n, dev)
    out = {}
    for case, x in (("drained", drained),
                    ("one cell", dict(drained, ip=zeros, jt=zeros))):
        host = {k: v.cpu() for k, v in x.items()}
        got = []
        for _ in range(2):
            acc = fresh(dev)
            fin.tally_escapes(acc, **x, scratch=scratch)
            got.append({f: getattr(acc, f).cpu() for f in binned})
        untouched = [f for f in binned if not bool((got[0][f] != 0).any())]
        if untouched:
            fail(f"finish {case}: {untouched} untouched (downstream "
                 f"{int(host['is_dw'].sum())}, upstream "
                 f"{int(host['is_up'].sum())} finishers): the case holds "
                 f"them at +0.0 alone")
        twin, ref = fresh("cpu"), fresh("cpu")
        fin.tally_twin(twin, **host)
        fin.tally_index_put(ref, **host)
        worst = 0.0
        for f in binned:
            a, w, r = got[0][f], getattr(twin, f), getattr(ref, f)
            if not (torch.equal(a.view(torch.int64), w.view(torch.int64))
                    and torch.equal(a.view(torch.int64),
                                    got[1][f].view(torch.int64))):
                fail(f"finish {case}: {f} is not the twin's bits, or two "
                     f"launches differ")
            err = (a - r).abs()
            if not bool((err <= FINISH_TOL * r.abs()).all()):
                fail(f"finish {case}: {f} off index_put_'s by more than "
                     f"{FINISH_TOL} of a cell")
            worst = max(worst, float((err / r.abs().clamp(
                min=1e-300)).max()))
        # the launches queue up behind a sleeping kernel, so the events
        # time the card's work and not the host's enqueue
        times = {}
        for name, call in (
                ("ms", lambda acc: fin.tally_escapes(acc, **x,
                                                     scratch=scratch)),
                ("index_put_ms", lambda acc: fin.tally_index_put(acc, **x))):
            acc = fresh(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(REBIN_SLEEP_CYCLES)
            ev[0].record()
            for _ in range(FINISH_REPS):
                call(acc)
            ev[1].record()
            torch.cuda.synchronize()
            times[name] = ev[0].elapsed_time(ev[1]) / FINISH_REPS
        n_dw, n_up = int(host["is_dw"].sum()), int(host["is_up"].sum())
        cells = sum(int((got[0][f] != 0).sum()) for f in binned)
        n_bytes = (FINISH_LANE_BYTES * n + FINISH_DOWNSTREAM_BYTES * n_dw
                   + FINISH_UPSTREAM_BYTES * n_up + FINISH_CELL_BYTES * cells)
        bound_ms, bound_by = bound(n_bytes, 4 * (n_dw + n_up), F64_OPS_S)
        out[case] = dict(max_rel_err=worst, **times, bound_ms=bound_ms,
                         bound_by=bound_by, lanes=n, finished=n_dw + n_up,
                         downstream=n_dw, upstream=n_up,
                         touched_cells=cells)
        print(f"finish ({case}, {b.n_mom + 1} x {b.n_theta + 1} cells): "
              f"{json.dumps(out[case])}")
    return out


def k5_uniforms(st) -> int:
    """K5's in-kernel uniforms (its debug entry) against
    rng.lane_uniforms_xla on the card, bit for bit, at every counter of
    K5_COUNTERS and at random per-lane counters; returns the values
    compared."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import helix, rng

    n, dev = st.key0.shape[0], st.key0.device
    gen = torch.Generator().manual_seed(10)
    ctrs = [torch.full((n,), c, dtype=torch.int32, device=dev)
            for c in K5_COUNTERS]
    ctrs.append(torch.randint(0, 2 ** 31 - 1, (n,), generator=gen,
                              dtype=torch.int32).to(dev))
    bad = sum(int((helix.uniforms(st.key0, st.key1, c)
                   != rng.lane_uniforms_xla(st.key0, st.key1, c)).sum())
              for c in ctrs)
    print(f"k5 uniforms: {n} keys at counters {list(K5_COUNTERS)} and at "
          f"random ones: {bad} of {8 * n * len(ctrs)} differ")
    if bad:
        fail(f"k5 uniforms: {bad} differ from rng.lane_uniforms_xla")
    return 8 * n * len(ctrs)


def hold_k5_tallies(tag, tk, tp) -> dict:
    """Every tally of K5 (tk) against the plain step's (tp): the largest
    difference over the largest entry, within K5_TALLY_TOL (the PSD,
    float32: HIST_TOL); returns them with the PSD's max abs error."""
    import torch

    out = {}
    for f in dataclasses.fields(tp):
        b = getattr(tp, f.name)
        if not isinstance(b, torch.Tensor):
            continue
        a = getattr(tk, f.name).double()
        b = b.double()
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        tol = HIST_TOL if f.name == "psd_diff" else K5_TALLY_TOL
        if not (math.isfinite(err) and err <= tol * scale):
            fail(f"{tag}: {f.name} differs by {err!r} (largest entry "
                 f"{scale!r}, bound {tol} of it)")
        out[f.name] = err / scale if scale else 0.0
        if f.name == "psd_diff":
            out["psd_max_abs_err"] = err
    return out


def time_windows(st, st0, block, reps: int) -> float:
    """Mean device ms of block() over `reps` runs (after a first, a
    warm-up), the lanes reset to st0 before each: CUDA events around the
    block alone."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import state as stt

    total = 0.0
    for r in range(reps + 1):
        stt.copy_into(st, st0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        block()
        ev[1].record()
        torch.cuda.synchronize()
        if r:
            total += ev[0].elapsed_time(ev[1])
    return total / reps


def hold_k5(tag, tb, st0, fresh_tal) -> dict:
    """One WINDOW-step K5 launch against the plain step's block
    (ops/step.py _block) from the same lanes: per lane within K5_TOL,
    integer fields equal on all but MAX_DIVERGENT of the lanes, every
    tally (hold_k5_tallies); then K5's ms a window (CUDA events around
    the launch, enqueued) against the plain block's under CUDA-graph
    replay (the plain step's path before K5), in the order plain, K5,
    K5, plain, and the window's bound."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import helix
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    p = helix.pack(tb)
    f64 = p.p_dtype == torch.float64
    n = st0.weight.shape[0]
    s_k, t_k = stt.clone(st0), fresh_tal()
    s_p, t_p = stt.clone(st0), fresh_tal()
    kl = helix.HelixLaunch(s_k, t_k, p)
    torch.cuda.synchronize()
    kl.enqueue(WINDOW, K5_CAP)
    xla_step._block(s_p, t_p, tb, WINDOW, K5_CAP)
    torch.cuda.synchronize()
    lanes = compare_lanes(s_k, s_p, K5_TOL, K5_INTS)
    print(f"{tag} window per-lane: {json.dumps(lanes)}")
    if lanes["divergent_lanes"] > MAX_DIVERGENT * n:
        fail(f"{tag} window: {lanes['divergent_lanes']} lanes diverge")
    if lanes["float_lanes_over_bound"] > MAX_DIVERGENT * n:
        fail(f"{tag} window: {lanes['float_lanes_over_bound']} float "
             f"fields beyond {K5_TOL:g} relative")
    tal = hold_k5_tallies(f"{tag} window", t_k, t_p)
    fin = stt.finalize_tallies(t_p)
    totals = {k: float(getattr(fin, k).double().sum()) for k in (
        "num_crossings", "weight_coupled", "energy_pool", "retro_entries",
        "energy_received", "energy_radiated", "spectra_sf")}
    pushes = int((s_p.nsteps - st0.nsteps).sum())
    touched = sum(2 * int(torch.count_nonzero(v)) * v.element_size()
                  for v in (getattr(t_p, f.name)
                            for f in dataclasses.fields(t_p))
                  if isinstance(v, torch.Tensor))
    g = xla_step._BlockGraph(s_p, t_p, tb, WINDOW, K5_CAP)
    plain = lambda: time_windows(s_p, st0, g.replay, 2)
    k5 = lambda: time_windows(s_k, st0, lambda: kl.enqueue(WINDOW, K5_CAP),
                              K5_REPS)
    p1, k1a, k1b, p2 = plain(), k5(), k5(), plain()
    ms, plain_ms = (k1a + k1b) / 2, (p1 + p2) / 2
    runtime = None
    rt = helix.instance_of(f64, helix.CT_RUNTIME)
    if p.instance != rt:
        # the run-time instance on the same window: the same bits, and
        # its time beside the specialised instance's
        s_r, t_r = stt.clone(st0), fresh_tal()
        kr = helix.HelixLaunch(s_r, t_r, dataclasses.replace(p, instance=rt))
        kr.enqueue(WINDOW, K5_CAP)
        torch.cuda.synchronize()
        diff = [f.name for f in dataclasses.fields(st0)
                if not torch.equal(getattr(s_r, f.name),
                                   getattr(s_k, f.name))]
        if diff:
            fail(f"{tag}: the run-time instance differs from instance "
                 f"{p.instance} in {diff}")
        runtime = dict(instance=rt, ms=time_windows(
            s_r, st0, lambda: kr.enqueue(WINDOW, K5_CAP), K5_REPS))
    b_ms, b_by = bound(n * K5_STATE_BYTES[st0.pb.element_size()] + touched,
                       pushes * K5_OPS_PER_PUSH,
                       F64_OPS_S if f64 else F32_OPS_S)
    inst = helix.INSTANCES[p.instance]
    print(f"{tag}: instance {p.instance} {inst} (word {p.word:#x}); "
          f"{WINDOW} steps x {n} lanes ({pushes} pushes): K5 {k1a:.4f} / "
          f"{k1b:.4f} ms, plain step under graph replay {p1:.2f} / "
          f"{p2:.2f} ms; bound {b_ms:.5f} ms ({b_by}); the run-time "
          f"instance {json.dumps(runtime)}; tallies against plain "
          f"{json.dumps(tal)}; plain totals {json.dumps(totals)}")
    return dict(instance=p.instance, word=p.word, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, pushes=pushes, lanes=lanes,
                tallies=tal, max_abs_err=tal["psd_max_abs_err"],
                runtime=runtime)


def bit_view(t):
    """`t`'s bits: a float tensor viewed as integers of its width."""
    import torch

    if not t.is_floating_point():
        return t
    return t.view({8: torch.int64, 4: torch.int32}[t.element_size()])


def same_bits(a, b) -> bool:
    """Two tensors equal bit for bit (NaN payloads and the sign of zero
    included)."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(bit_view(a), bit_view(b)))


def hold_drain(tag, tb, st0, fresh_tal, cap=None, levels: int = 0) -> dict:
    """One pcut segment of `st0` (helix cap `cap`, the engine's when
    None) three ways through ``run_segment``: the plain step's CUDA
    graphs (``plain=True``) and K5's block loop (``blocks=True``), both at
    compaction depth `levels`, and K5's drain.  The drain must be one K5
    launch with no host read inside it, return the loop's steps, and
    leave every lane as both leave it: bit for bit in every field against
    the block loop, the same values against the plain step (the bits
    that differ are counted); its tallies within K5_TALLY_TOL of their
    largest entry of both (the PSD within HIST_TOL).  Each run's device ms
    (CUDA events: the drain's one launch; the sum of the loop's blocks,
    the plain step's scaled from its replayed blocks to all of them) and
    the drain's bound."""
    import torch

    from montecarloscattering_jl_tpu_torch.ops import helix
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    f64 = st0.pb.dtype == torch.float64
    runs = {}
    for who in ("plain", "blocks", "drain"):
        st, tl = stt.clone(st0), fresh_tal()
        g = xla_step.GraphCache()
        g.timing = True
        before = (helix.LAUNCHES, helix.DRAINS, helix.HOST_READS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        taken = xla_step.run_segment(st, tl, tb, max_helix=cap,
                                     compact_levels=levels, graphs=g,
                                     plain=who == "plain",
                                     blocks=who == "blocks")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seg = g.segment_ms()[0]
        ms = seg["ms"]
        if who == "plain":   # its first block ran eagerly, untimed
            ms *= (taken // xla_step.SYNC_EVERY) / max(seg["blocks"], 1)
        runs[who] = (st, tl, dict(
            wall=wall, steps=taken, ms=ms,
            pushes=int((st.nsteps - st0.nsteps).sum(dtype=torch.int64)),
            launches=helix.LAUNCHES - before[0],
            drains=helix.DRAINS - before[1],
            host_reads=helix.HOST_READS - before[2], captures=g.captures,
            window_ms={str(k): v[1] * xla_step.SYNC_EVERY
                       for k, v in g.step_ms().items()}))
    sd, td, rd = runs["drain"]
    if (rd["launches"], rd["drains"], rd["host_reads"]) != (1, 1, 0):
        fail(f"{tag}: the drain made {rd['launches']} K5 launches "
             f"({rd['drains']} drains) and {rd['host_reads']} host reads")
    out = dict(drain=rd, blocks=runs["blocks"][2], plain=runs["plain"][2])
    for ref in ("blocks", "plain"):
        sr, tr, rr = runs[ref]
        if rr["steps"] != rd["steps"] or rr["pushes"] != rd["pushes"]:
            fail(f"{tag}: the drain took {rd['steps']} steps, "
                 f"{rd['pushes']} pushes; the {ref} loop {rr['steps']}, "
                 f"{rr['pushes']}")
        bits = {}
        for f in dataclasses.fields(st0):
            a, b = getattr(sd, f.name), getattr(sr, f.name)
            if ref == "blocks" and not same_bits(a, b):
                fail(f"{tag}: the drain's {f.name} differs from the block "
                     f"loop's")
            same = (a == b) | (a.isnan() & b.isnan()) \
                if a.is_floating_point() else a == b
            if not bool(same.all()):
                fail(f"{tag}: the drain's {f.name} differs from the plain "
                     f"step's on {int((~same).sum())} lanes")
            if not same_bits(a, b):
                bits[f.name] = int((bit_view(a) != bit_view(b)).sum())
        out[f"tallies_vs_{ref}"] = hold_k5_tallies(f"{tag} vs {ref}", td, tr)
        out[f"bits_vs_{ref}"] = bits
    touched = sum(2 * int(torch.count_nonzero(v)) * v.element_size()
                  for v in (getattr(td, f.name)
                            for f in dataclasses.fields(td))
                  if isinstance(v, torch.Tensor))
    n = st0.weight.shape[0]
    b_ms, b_by = bound(n * K5_STATE_BYTES[st0.pb.element_size()] + touched,
                       rd["pushes"] * K5_OPS_PER_PUSH,
                       F64_OPS_S if f64 else F32_OPS_S)
    out.update(ms=rd["ms"], plain_ms=runs["plain"][2]["ms"],
               blocks_ms=runs["blocks"][2]["ms"], bound_ms=b_ms,
               bound_by=b_by, bound_share=b_ms / rd["ms"],
               max_abs_err=out["tallies_vs_plain"]["psd_max_abs_err"])
    print(f"{tag}: {n} lanes, cap {cap}, levels {levels}: drain "
          f"{rd['ms']:.4f} ms ({rd['pushes']} pushes, {rd['steps']} "
          f"steps), block loop {out['blocks_ms']:.4f} ms, plain step "
          f"{out['plain_ms']:.2f} ms; bound {b_ms:.5f} ms ({b_by}, "
          f"{100 * b_ms / rd['ms']:.2f}%); lanes bit for bit against the "
          f"block loop, bits differing from the plain step "
          f"{json.dumps(out['bits_vs_plain'])}; tallies against plain "
          f"{json.dumps(out['tallies_vs_plain'])}; runs "
          f"{json.dumps({k: v[2] for k, v in runs.items()})}")
    return out


def k5_phase(dev) -> dict:
    """Phase k5: K5 against the plain step on the card.  (a) The
    uniforms; (b) one window of the f64 flagship population (phase
    f64's config, the engine's 69,632 injected lanes at pcut 0); (c) the
    drain of the same lanes, a full segment at the engine's helix cap,
    against the plain step's graphs and K5's block loop at the auto
    compaction depth (hold_drain), and the same segment capped at
    K5_SEG_CAP steps; (d) a window and a segment capped at DRAIN_CAP of
    each flag case at float64 (scripts/workloads.py helix_flag_case) and
    of the f32 flagship with x_spec detectors at float32."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import helix
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    def flagship(p_dtype):
        cfg = flagship_config(p_dtype, 1, True)
        setup = build_setup(cfg)
        eng = TransportEngine(setup, device=dev, p_dtype=p_dtype)
        ss = eng.step_static(0)
        tb = xla_step.step_tables(
            eng.segment_grids(setup.profile),
            eng.segment_scalars(0, 0, setup.profile.bmag2), ss, dev)
        st0 = wl.flagship_population(setup, cfg, dev, lanes=eng.batch_size,
                                     p_dtype=p_dtype)
        b = setup.bins
        fresh = lambda: stt.make_tallies(setup.nb, b.n_mom, b.n_theta, dev,
                                         n_xspec=ss.n_xspec)
        return eng, tb, st0, fresh

    eng, tb, st0, fresh = flagship(torch.float64)
    out = dict(uniforms=k5_uniforms(st0))
    out["flagship"] = hold_k5("k5 flagship", tb, st0, fresh)
    out["drain"] = hold_drain("k5 drain", tb, st0, fresh,
                              levels=eng.compact_levels)
    out["capped"] = hold_drain("k5 drain capped", tb, st0, fresh,
                               cap=K5_SEG_CAP, levels=eng.compact_levels)
    p = helix.pack(tb)
    out["residency"] = helix.instance_attrs(p.instance, tb.ss.nb + 1)
    print(f"k5 drain: instance {p.instance}, {json.dumps(out['residency'])}")

    cases, drains = {}, {}
    for case in wl.FLAG_CASES:
        if case[4] == 1.0:
            continue        # the f(r_g) law at alpha = 1: K1's own check
        c = wl.helix_flag_case(case, dev)
        cases[case[0]] = hold_k5(f"k5 {case[0]}", c["tb"], c["st0"],
                                 c["fresh_tal"])
        drains[case[0]] = hold_drain(f"k5 {case[0]} drain", c["tb"],
                                     c["st0"], c["fresh_tal"], cap=DRAIN_CAP)
    _, tb32, st32, fresh32 = flagship(torch.float32)
    cases["f32 x_spec"] = hold_k5("k5 f32 x_spec", tb32, st32, fresh32)
    drains["f32 x_spec"] = hold_drain("k5 f32 x_spec drain", tb32, st32,
                                      fresh32, cap=DRAIN_CAP)
    out["cases"], out["case_drains"] = cases, drains
    return out


def slope_of(res) -> tuple[float, float]:
    """The downstream power-law slope of iteration 1 and its theory."""
    import numpy as np

    from montecarloscattering_jl_tpu_torch.utils import constants as K

    setup = res.setup
    fi = res.iterations[0].ion_finals[0]
    p_cent = setup.bins.mom_centers
    dndp = fi.psd[:, :, 75].sum(axis=1) / np.diff(setup.bins.mom_edges)
    sel = ((p_cent > 0.018 * K.MP_C) & (p_cent < 0.12 * K.MP_C)
           & (dndp > 0))
    if sel.sum() < 6:
        fail(f"only {sel.sum()} spectrum bins in the fit range")
    slope = float(np.polyfit(np.log10(p_cent[sel]), np.log10(dndp[sel]),
                             1)[0])
    return slope, -(3 * setup.r_comp / (setup.r_comp - 1) - 2)


def zero_counts() -> None:
    """Every kernel's launch count and the plain versions' calls to 0."""
    from montecarloscattering_jl_tpu_torch.ops import finish as fin
    from montecarloscattering_jl_tpu_torch.ops import helix, hist, mega
    from montecarloscattering_jl_tpu_torch.ops import reduce as red

    mega.LAUNCHES = mega.TWIN_CALLS = mega.HOST_WAITS = 0
    hist.LAUNCHES = hist.BAND_LAUNCHES = hist.PLAIN_CALLS = 0
    helix.LAUNCHES = helix.DRAINS = helix.DEPOSIT_STEPS = 0
    helix.HOST_READS = helix.PLAIN_CALLS = 0
    red.LAUNCHES = fin.LAUNCHES = 0


def read_counts() -> dict:
    from montecarloscattering_jl_tpu_torch.ops import finish as fin
    from montecarloscattering_jl_tpu_torch.ops import helix, hist, mega
    from montecarloscattering_jl_tpu_torch.ops import reduce as red

    return dict(k1=mega.LAUNCHES, k1_host_waits=mega.HOST_WAITS,
                twin=mega.TWIN_CALLS, k2=hist.LAUNCHES,
                k3=hist.BAND_LAUNCHES, hist_plain=hist.PLAIN_CALLS,
                k5=helix.LAUNCHES, k5_drains=helix.DRAINS,
                k5_host_reads=helix.HOST_READS,
                k5_deposit_steps=helix.DEPOSIT_STEPS,
                plain_blocks=helix.PLAIN_CALLS, rebin=red.LAUNCHES,
                finish=fin.LAUNCHES)


def check_rebin(tag, counts, res, n_ions: int) -> None:
    """A driven run on the card rebins each species of each iteration
    it ran in one launch (ops/reduce.py rebin_dndp), and reports them
    in RunResult.launches."""
    want = len(res.iterations) * n_ions
    if counts["rebin"] != want or res.launches["rebin"] != want:
        fail(f"{tag}: {counts['rebin']} rebin launches "
             f"(RunResult.launches: {res.launches['rebin']}), {want} "
             f"expected: one a species and iteration")


def check_finish(tag, counts, res, cfg) -> None:
    """A driven run on the card adds each segment's exits through the
    finish kernel (ops/finish.py tally_escapes), one launch a segment its
    ladders queued: at least one a species and iteration, at most one a
    pcut of each, and RunResult.launches says as many."""
    least = len(res.iterations) * cfg.n_ions
    n = counts["finish"]
    if (res.launches["finish"] != n
            or not least <= n <= least * len(cfg.pcuts)):
        fail(f"{tag}: {n} finish launches (RunResult.launches: "
             f"{res.launches['finish']}), {least} to "
             f"{least * len(cfg.pcuts)} expected: one a segment")


@contextlib.contextmanager
def counted_ladders(tag: str):
    """Within the block, every species' fused ladder (engine/run.py
    TransportEngine._ladder_async) runs under torch's sync debug mode,
    its warnings recorded: yields the list of its species, each with its
    host waits, its sync points and the lines that waited.  On leaving,
    prints them and fails where a ladder waited more often than its sync
    points plus LADDER_WAITS_EXTRA."""
    import collections
    import warnings

    import torch

    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine

    base = TransportEngine._ladder_async
    rows = []

    def counted(self, i_iter, i_ion, *a, **kw):
        syncs = self.sync_points
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = base(self, i_iter, i_ion, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in said
                 if "synchronizing CUDA operation" in str(w.message)]
        rows.append(dict(
            iteration=i_iter, species=i_ion, segments=len(out[3]),
            waits=len(waits), sync_points=self.sync_points - syncs,
            where=dict(collections.Counter(
                f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                for w in waits))))
        return out

    TransportEngine._ladder_async = counted
    try:
        yield rows
    finally:
        TransportEngine._ladder_async = base
    print(f"{tag}: host waits of the fused ladders {json.dumps(rows)}")
    if not rows:
        fail(f"{tag}: no fused ladder ran")
    for r in rows:
        if r["waits"] > r["sync_points"] + LADDER_WAITS_EXTRA:
            fail(f"{tag}: a fused ladder waited {r['waits']} times at "
                 f"{r['sync_points']} sync points: {r}")


def check_engine(tag, counts, p_dtype) -> None:
    """Every drain of a float32 run launched K1 (none the twin or the XLA
    engine, and no drain waits on the host once a launch); every segment
    of a float64 run is one K5 drain, its PSD deposits through K2's warp
    deposit inside it (no K5 window, no host read inside a segment, no
    plain block, no standalone K2 or its plain version, no K1)."""
    import torch

    if p_dtype == torch.float32:
        if (counts["k1"] <= 0 or counts["twin"] != 0 or counts["k2"] != 0
                or counts["k5"] != 0 or counts["plain_blocks"] != 0):
            fail(f"{tag}: {counts} (every drain must launch K1, none the "
                 f"twin or the XLA engine)")
        if counts["k1_host_waits"] >= counts["k1"]:
            fail(f"{tag}: {counts} (the drains wait on the host once a "
                 f"launch)")
    elif (counts["k5"] <= 0 or counts["k5_drains"] != counts["k5"]
          or counts["k5_host_reads"] != 0 or counts["k5_deposit_steps"] <= 0
          or counts["plain_blocks"] != 0
          or counts["k2"] != 0 or counts["hist_plain"] != 0
          or counts["k1"] != 0 or counts["twin"] != 0):
        fail(f"{tag}: {counts} (every segment must be one K5 drain with no "
             f"host read inside it, none the plain step, no K1)")


def drive(cfg, dev, p_dtype, tag: str, cap: int = 0, killed: bool = False,
          **run_kw) -> tuple:
    """One driven run through ``engine.driver.run`` (`run_kw`: its
    checkpoint, resume and mid_every), the helix cap of both engines set
    to `cap` for it when given; counts of every kernel's launches set to
    0 just before it and read just after.  Checks the engine each drain
    took, the output file set and the reductions; returns (result,
    counts, wall seconds, files with their line counts).  With `killed`
    the run must end in the stop hook's MidCheckpointStop: the result is
    None and no file is written."""
    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.ops import mega
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step
    from montecarloscattering_jl_tpu_torch.parallel.checkpoint import (
        MidCheckpointStop)

    caps = (mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS)
    if cap:
        mega.MAX_HELIX_STEPS = xla_step.MAX_HELIX_STEPS = cap
    res = None
    try:
        with tempfile.TemporaryDirectory() as out:
            zero_counts()
            t0 = time.perf_counter()
            try:
                res = run(cfg, device=dev, out_dir=None if killed else out,
                          p_dtype=p_dtype, **run_kw)
            except MidCheckpointStop:
                if not killed:
                    raise
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            written = {}
            for name in sorted(os.listdir(out)):
                with open(os.path.join(out, name), "rb") as f:
                    written[name] = sum(1 for _ in f)
    finally:
        mega.MAX_HELIX_STEPS, xla_step.MAX_HELIX_STEPS = caps
    if killed:
        if res is not None:
            fail(f"{tag}: the stop hook did not stop the run")
        print(f"{tag}: stopped by the hook after {wall:.2f} s; launches "
              f"{json.dumps(counts)}")
        check_engine(tag, counts, p_dtype)
        return None, counts, wall, written
    phases = {k: round(v, 3) for k, v in res.timers.totals.items()}
    print(f"{tag}: {len(res.iterations)} iterations, "
          f"{res.n_trajectories} trajectories, {res.n_pushes} pushes in "
          f"{wall:.2f} s ({res.n_pushes / wall / 1e6:.2f} M pushes/s); "
          f"launches {json.dumps(counts)}; phases {json.dumps(phases)}")
    check_engine(tag, counts, p_dtype)
    check_rebin(tag, counts, res, cfg.n_ions)
    check_finish(tag, counts, res, cfg)
    if (p_dtype == torch.float64 and "resume" not in run_kw
            and counts["k5_deposit_steps"] != res.n_pushes):
        fail(f"{tag}: the K5 drains made {counts['k5_deposit_steps']} "
             f"pushes, the run counts {res.n_pushes}")
    missing = [f for f in expected_files(cfg) if f not in written]
    if missing:
        fail(f"{tag}: output files missing: {missing} (got {written})")
    for itr in res.iterations:
        for f in itr.ion_finals:
            if not (np.isfinite(f.dndp_cr).all()
                    and np.isfinite(f.p_psd_par).all()):
                fail(f"{tag}: non-finite reductions")
    return res, counts, wall, written


def species_report(tag, res) -> list:
    """Per species of iteration 1: exit reasons, tcut weights, pool,
    received and radiated energy, retro entries, pushes and
    trajectories, printed as JSON; returns the list."""
    import numpy as np

    it = res.iterations[0]
    rows = []
    for i_ion, f in enumerate(it.ion_finals):
        rc = [int(v) for v in f.reason_counts]
        wc = it.tallies.weight_coupled
        row = dict(
            species=i_ion, exits=dict(downstream=rc[1], pmax_feb=rc[2],
                                      age=rc[3], radiated=rc[4]),
            tcut_weight=float(wc[:, i_ion].sum()) if wc is not None else 0.0,
            pool_erg=float(np.sum(it.tallies.energy_pool))
            if i_ion == 0 else None,
            received_erg=f.energy_received, radiated_erg=f.energy_radiated,
            retro_entries=f.retro_entries, pushes=f.n_pushes,
            trajectories=f.n_trajectories)
        rows.append(row)
        print(f"{tag} species {i_ion}: {json.dumps(row)}")
    setup = res.setup
    print(f"{tag}: r_comp {setup.r_comp:.4f} against r_RH "
          f"{setup.r_rh:.4f}")
    return rows


def flagship_config(p_dtype, n_itrs: int, x_spec: bool):
    """The flagship config of phases f32, f64 and resume: smoothing on,
    wl.LANES particles a pcut; with x_spec two detectors at -/+0.5 r_g0;
    at float64 its first F64_PCUTS pcuts."""
    import torch

    from montecarloscattering_jl_tpu_torch.utils import load_config
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    cfg = load_config(wl.CFG)
    cfg.n_itrs = n_itrs
    cfg.do_smoothing = True
    cfg.n_pts_inj = cfg.n_pts_pcut = cfg.n_pts_pcut_hi = wl.LANES
    if x_spec:
        cfg.x_spec = [-0.5 * cfg.rg0, 0.5 * cfg.rg0]
    if p_dtype == torch.float64:
        cfg.pcuts = cfg.pcuts[:F64_PCUTS]
    return cfg


def main_path(dev, p_dtype, n_itrs: int, x_spec: bool) -> dict:
    """The flagship config driven through one engine (phases f32, f64):
    the slope of iteration 1, and the detector spectra with x_spec.
    Returns the launch counts with the wall time and the result."""
    import torch

    cfg = flagship_config(p_dtype, n_itrs, x_spec)
    tag = f"{str(p_dtype).replace('torch.', '')} path"
    with counted_ladders(tag) as ladders:
        res, counts, wall, _ = drive(cfg, dev, p_dtype, tag)
    slope, expect = slope_of(res)
    print(f"{tag}: iteration 1 downstream slope {slope:.4f} (expected "
          f"{expect:.4f} +- 0.45)")
    if not math.isfinite(slope) or abs(slope - expect) > 0.45:
        fail(f"{tag}: slope {slope} vs {expect}")
    if p_dtype != torch.float32:
        print(f"{tag}: drain graphs {json.dumps(graphs_line(res))}; "
              f"ladder launches {json.dumps(res.launches)}; {res.n_pushes} "
              f"pushes against {F64_PLAIN_PUSHES} on the plain step (PR 8, "
              f"PERF.md §5): {res.n_pushes - F64_PLAIN_PUSHES:+d}")
    if x_spec:
        fi = res.iterations[0].ion_finals[0]
        tot = [(float(fi.spectra_sf[:, i].sum()),
                float(fi.spectra_pf[:, i].sum())) for i in range(2)]
        print(f"{tag}: detector spectra totals (sf, pf) {tot}")
        if not all(a > 0 and b > 0 and math.isfinite(a + b)
                   for a, b in tot):
            fail(f"{tag}: detector spectra {tot}")
    return dict(counts, wall=wall, result=res, ladders=ladders)


def science_path(dev) -> dict:
    """The baseline's science variant on K1 at float32, 1 iteration
    (phase science)."""
    import torch

    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    cfg = wl.load_variant(wl.BASELINE, n_itrs=1)
    wl.science_variant(cfg)
    print(f"science: {len(cfg.pcuts)} pcuts, {cfg.n_pts_inj} / "
          f"{cfg.n_pts_pcut} / {cfg.n_pts_pcut_hi} particles, helix cap "
          f"{wl.SCIENCE_CAP}")
    with counted_ladders("science") as ladders:
        res, counts, wall, written = drive(cfg, dev, torch.float32,
                                           "science", cap=wl.SCIENCE_CAP)
    print(f"science: coupled CSV lines: weights "
          f"{written['mc_coupled_weights.csv']}, spectra "
          f"{written['mc_coupled_spectra.csv']}")
    rows = species_report("science", res)
    p = rows[0]
    if not (p["tcut_weight"] > 0
            and (p["exits"]["age"] + p["retro_entries"]) > 0):
        fail(f"science: a proton-side branch did not fire: {p}")
    # the pool: a proton donates at its first crossing from upstream, in
    # the upstream plasma frame, where the baseline's thermal protons
    # have gamma - 1 ~ 2e-8, below a float32 ulp of gamma: the donation
    # rounds to 0 on K1 as in the reference's megakernel (the flags
    # phase and the electrons phase show it at representable energies)
    print(f"science: ion pool {p['pool_erg']!r} erg (float32 momenta)")
    return dict(counts=counts, wall=wall, pushes=res.n_pushes,
                trajectories=res.n_trajectories, species=rows,
                ladders=ladders)


def emission_report(tag, res) -> dict:
    """The last iteration's emission: each process's shell total and
    the nonzero bins of the total SED, which must not be empty."""
    import numpy as np

    em = res.iterations[-1].emission
    if em is None:
        fail(f"{tag}: no emission result")
    tot = np.asarray(em.tot)
    sums = {k: float(np.asarray(getattr(em, k + "_shell")).sum())
            for k in ("synch", "ic", "pion")}
    print(f"{tag}: shell totals [erg/(cm^2 s)] {json.dumps(sums)}; "
          f"{int((tot > 0).sum())} nonzero bins of {tot.size} in the total "
          f"SED")
    if not (np.isfinite(tot).all() and (tot > 0).any()
            and all(v > 0 and math.isfinite(v) for v in sums.values())):
        fail(f"{tag}: an empty or non-finite SED: {sums}")
    return sums


def electron_path_f32(dev) -> dict:
    """examples/03 as shipped on K1 at float32, photons on (phase
    electrons32): both species' drains and the electrons' rad-loss
    branch run in K1; the electrons must push and exit, and the SED of
    their synchrotron and IC photons and the protons' pion decay is
    written."""
    import torch

    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(ELECTRONS)
    if not cfg.do_photons:
        fail("electrons32: examples/03 ships with photon production on")
    res, counts, wall, _ = drive(cfg, dev, torch.float32, "electrons32")
    rows = species_report("electrons32", res)
    e = rows[1]
    if not (e["pushes"] > 0 and sum(e["exits"].values()) > 0):
        fail(f"electrons32: the electrons did not push or exit: {e}")
    emission_report("electrons32", res)
    return dict(counts=counts, wall=wall, species=rows)


def sed_path(dev) -> dict:
    """The SED flagship on K1 at float32, SED_PER_PCUT particles per
    pcut (phase sed): transport, reductions, emission on the card and
    the photon files, then the script's physics checks and the card's
    emission pass against the per-zone NumPy loop on the same
    reductions."""
    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.models.emission import photon_calcs
    from montecarloscattering_jl_tpu_torch.scripts import flagship_sed

    cfg = flagship_sed.sed_config(SED_PER_PCUT)
    print(f"sed: {len(cfg.pcuts)} pcuts, {cfg.n_pts_inj} / {cfg.n_pts_pcut} "
          f"/ {cfg.n_pts_pcut_hi} particles, {cfg.n_ions} species")
    res, counts, wall, _ = drive(cfg, dev, torch.float32, "sed")
    rows = species_report("sed", res)
    sums = emission_report("sed", res)
    if not flagship_sed.check_sed(cfg, res):
        fail("sed: the flagship's physics checks failed")
    # the same reductions through both bodies of photon_calcs
    it = res.iterations[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em_dev = photon_calcs(res.setup, res.setup.profile, it.ion_finals,
                          device=dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    em_np = photon_calcs(res.setup, res.setup.profile, it.ion_finals,
                         device=None)
    t_np = time.perf_counter() - t0
    worst = {}
    for name in ("pion_grid", "synch_grid", "ic_grid", "pion_shell",
                 "synch_shell", "ic_shell", "tot"):
        a = np.maximum(np.asarray(getattr(em_np, name)), EMISSION_FLOOR)
        b = np.maximum(np.asarray(getattr(em_dev, name)), EMISSION_FLOOR)
        worst[name] = float(np.abs(b / a - 1.0).max())
    print(f"sed: emission on the card {t_dev:.3f} s, per-zone NumPy loop "
          f"{t_np:.3f} s; max relative difference above {EMISSION_FLOOR:g}: "
          f"{json.dumps(worst)}")
    bad = {k: v for k, v in worst.items() if not v <= EMISSION_RTOL}
    if bad:
        fail(f"sed: the card's emission differs from the NumPy loop: {bad}")
    return dict(counts=counts, wall=wall, pushes=res.n_pushes,
                trajectories=res.n_trajectories, species=rows, shells=sums)


def electron_variant():
    """examples/03 with photon production off and the baseline's
    energy-transfer fraction, 1 iteration."""
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    return wl.load_variant(ELECTRONS, replace=[
        ("calculate-photon-production = true",
         "calculate-photon-production = false"),
        ("energy-transfer-frac = 0.0", "energy-transfer-frac = 0.1")],
        n_itrs=1)


def electron_path(dev) -> dict:
    """electron_variant at float64, cut to its first F64_PCUTS pcuts and
    an ELECTRON_CAP helix cap (phase electrons): the ions' pool, the
    electrons' receipt and radiative loss on the driven path."""
    import torch

    cfg = electron_variant()
    cfg.pcuts = cfg.pcuts[:F64_PCUTS]
    res, counts, wall, _ = drive(cfg, dev, torch.float64, "electrons",
                                 cap=ELECTRON_CAP)
    rows = species_report("electrons", res)
    p, e = rows
    if not (p["pool_erg"] > 0 and e["received_erg"] > 0
            and e["radiated_erg"] > 0):
        fail(f"electrons: pool, receipt or radiative loss missing: {rows}")
    return dict(counts=counts, wall=wall, species=rows)


def shipped_path(dev) -> dict:
    """configs/baseline.toml as shipped at float64 on the XLA engine, 1
    iteration (phase shipped)."""
    import torch

    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    cfg = wl.load_variant(wl.BASELINE, n_itrs=1)
    res, counts, wall, written = drive(cfg, dev, torch.float64, "shipped")
    print(f"shipped: {res.n_pushes} pushes and {res.n_trajectories} "
          f"trajectories (the JAX package on the CPU, --f32: "
          f"{SHIPPED_JAX_PUSHES} and {SHIPPED_JAX_TRAJECTORIES}); coupled "
          f"CSV lines: weights {written['mc_coupled_weights.csv']}, "
          f"spectra {written['mc_coupled_spectra.csv']}")
    species_report("shipped", res)
    dead_tail(cfg, dev, res)
    return dict(counts=counts, wall=wall, pushes=res.n_pushes,
                trajectories=res.n_trajectories)


def dead_tail(cfg, dev, res) -> None:
    """Both species' chains of the shipped baseline die at their first
    segment, so at MCS_HYBRID_SYNC_EVERY=8 the fused ladder queues dead
    segments after each until it sees the chain dead (at most 7): the
    run again at 1 (no dead segment) must give
    every species' new lanes, pushes, trajectories, exits and escape
    tallies in the same bits (K5's lanes and finish_particles' sums are
    deterministic; the float64 atomics of K5's tallies are not held)."""
    import dataclasses

    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run

    with sync_every("1"):
        ref = run(cfg, device=dev, p_dtype=torch.float64)
    for i, (a, b) in enumerate(zip(res.iterations[0].ion_finals,
                                   ref.iterations[0].ion_finals)):
        same = [a.n_new == b.n_new, a.n_pushes == b.n_pushes,
                a.n_trajectories == b.n_trajectories,
                np.array_equal(a.reason_counts, b.reason_counts)]
        same += [np.array_equal(np.asarray(getattr(a.esc, f.name)),
                                np.asarray(getattr(b.esc, f.name)))
                 for f in dataclasses.fields(a.esc)]
        if not all(same):
            fail(f"shipped species {i}: the dead segments changed the "
                 f"result: {same}")
    new = [f.n_new for f in res.iterations[0].ion_finals]
    print(f"shipped: new lanes a segment {new} and every escape tally the "
          f"same bits at MCS_HYBRID_SYNC_EVERY 8 and 1")


def hold_to_f64(tag, ref, res, against: str = "phase f64",
                spectra: bool = True) -> dict:
    """A rerun of phase f64's config (`res`) against phase f64's own run
    (`ref`): pushes, trajectories and exit reasons exactly (one iteration
    of protons: no lane reads an atomically summed value), fluxes and
    spectra (with x_spec detectors: `spectra`) within RESUME_FLUX_TOL of
    their largest entry, the PSDs within HIST_TOL of max |psd|; returns
    each one's largest difference over its largest entry."""
    import numpy as np

    if (res.n_pushes, res.n_trajectories) != (ref.n_pushes,
                                              ref.n_trajectories):
        fail(f"{tag}: {res.n_pushes} pushes, {res.n_trajectories} "
             f"trajectories against {ref.n_pushes}, {ref.n_trajectories}")
    fr, fg = ref.iterations[0], res.iterations[0]
    for a, b in zip(fr.ion_finals, fg.ion_finals):
        if not np.array_equal(a.reason_counts, b.reason_counts):
            fail(f"{tag}: exit reasons {b.reason_counts} against "
                 f"{a.reason_counts}")
    worst = {}
    for name, a, b, tol in (
            [(f, getattr(fr.tallies, f), getattr(fg.tallies, f),
              RESUME_FLUX_TOL) for f in ("pxx_flux", "pxz_flux",
                                         "energy_flux")]
            + [(f, getattr(fr.ion_finals[0], f), getattr(fg.ion_finals[0], f),
                RESUME_FLUX_TOL) for f in ("spectra_sf", "spectra_pf")
               if spectra]
            + [(f, getattr(fr.ion_finals[0], f), getattr(fg.ion_finals[0], f),
                HIST_TOL) for f in ("psd", "therm_psd")]):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(a).max()
        worst[name] = float(np.abs(b - a).max() / scale)
        if not (scale > 0 and worst[name] <= tol):
            fail(f"{tag}: {name} differs by {worst[name]!r} of its "
                 f"largest entry (bound {tol})")
    print(f"{tag}: against {against}, largest difference over largest "
          f"entry {json.dumps(worst)}")
    return worst


def resume_path(dev, f64) -> dict:
    """Phase resume: phase f64's config with a segment-boundary
    checkpoint after every segment, stopped (MCS_MID_STOP_AFTER=1) right
    after the first save, i.e. before the second of its F64_PCUTS
    segments, then resumed to the end; held against phase f64's own run
    (`f64`): pushes, trajectories and exit reasons exactly, fluxes and
    spectra within RESUME_FLUX_TOL of their largest entry, the PSDs
    within HIST_TOL of max |psd|."""
    import torch

    from montecarloscattering_jl_tpu_torch.parallel import checkpoint as ck

    ref = f64["result"]
    cfg = lambda: flagship_config(torch.float64, 1, True)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        os.environ["MCS_MID_STOP_AFTER"] = "1"
        try:
            _, killed, wall_k, _ = drive(cfg(), dev, torch.float64,
                                         "resume killed", checkpoint=path,
                                         mid_every=1, killed=True)
        finally:
            del os.environ["MCS_MID_STOP_AFTER"]
        mid = path + ".mid"
        size = os.path.getsize(mid)
        peek = ck.load_mid_checkpoint(mid)
        where = (peek["mode"], peek["i_iter"], peek["i_ion"],
                 peek["next_seg"])
        if where != ("xla", 0, 0, 1):
            fail(f"resume: the kill fell at {where}, not before segment 2")
        state_b = sum(v.numel() * v.element_size()
                      for v in vars(peek["state"]).values())
        psd_b = peek["tal"].psd_diff.numel() * 4
        res, counts, wall_r, _ = drive(cfg(), dev, torch.float64, "resume",
                                       checkpoint=path, resume=mid,
                                       mid_every=1)
        if os.path.exists(mid):
            fail("resume: the mid checkpoint outlived the iteration's")
    t = res.timers
    mid_ms = t.totals["mid_checkpoint"] / max(t.counts["mid_checkpoint"],
                                              1) * 1e3
    ck_ms = t.totals["checkpoint"] / t.counts["checkpoint"] * 1e3
    print(f"resume: mid checkpoint {size} B on disk (psd_diff {psd_b} B, "
          f"lane state {state_b} B of {peek['batch_size']} lanes); "
          f"{t.counts['mid_checkpoint']} later mid saves, {mid_ms:.2f} ms "
          f"each; iteration checkpoint {ck_ms:.2f} ms; wall killed "
          f"{wall_k:.2f} s + resumed {wall_r:.2f} s against uninterrupted "
          f"{f64['wall']:.2f} s")
    worst = hold_to_f64("resume", ref, res)
    both = {k: killed[k] + counts[k] for k in counts}
    return dict(counts=both, wall_killed=wall_k, wall_resumed=wall_r,
                mid_bytes=size, mid_ms=mid_ms, checkpoint_ms=ck_ms,
                worst=worst)


def graphs_line(res) -> dict:
    """The XLA engine's captured drain blocks of a driven run."""
    g = res.graphs
    return dict(captures=g.captures, capture_s=g.capture_s)


def compact_path(dev, f64) -> dict:
    """Phase compact: phase f64's config at compact_levels=0, held to
    phase f64's run (auto compaction; both K5 drains, where the depth is
    moot) as phase resume holds its run; then one segment of the
    flagship population through K5's drain and through K5's block loop
    at levels 0 and auto, every per-lane field bit-identical, with each
    one's device ms and the block loop's ms a step at each window
    size."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.run import (
        TransportEngine, auto_compact_levels)
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    cfg = flagship_config(torch.float64, 1, True)
    res, counts, wall, _ = drive(cfg, dev, torch.float64, "compact",
                                 compact_levels=0)
    worst = hold_to_f64("compact", f64["result"], res)
    ref = f64["result"]
    eng = TransportEngine(res.setup, device=dev)
    auto = auto_compact_levels(eng.batch_size)
    print(f"compact: f64 flagship, {eng.batch_size} lanes; auto "
          f"({auto} levels, windows "
          f"{xla_step.window_sizes(eng.batch_size, auto)}): wall "
          f"{f64['wall']:.2f} s, transport "
          f"{ref.timers.totals['transport']:.2f} s, graphs "
          f"{json.dumps(graphs_line(ref))}; levels 0: wall {wall:.2f} s, "
          f"transport {res.timers.totals['transport']:.2f} s, graphs "
          f"{json.dumps(graphs_line(res))}")

    # one segment of the injected population, lane for lane: K5's drain
    # (the engine's path, where the depth is moot) and K5's block loop at
    # levels 0 and auto
    setup = res.setup
    ss = eng.step_static(0)
    tb = xla_step.step_tables(eng.segment_grids(setup.profile),
                              eng.segment_scalars(0, 0, setup.profile.bmag2),
                              ss, dev)
    st0 = wl.flagship_population(setup, cfg, dev, lanes=eng.batch_size,
                                 p_dtype=torch.float64)
    b = setup.bins
    seg = {}
    for who, lv in (("drain", auto), ("levels 0", 0), (f"levels {auto}",
                                                        auto)):
        st = stt.clone(st0)
        tl = stt.make_tallies(setup.nb, b.n_mom, b.n_theta, dev,
                              n_xspec=ss.n_xspec)
        g = xla_step.GraphCache()
        g.timing = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        taken = xla_step.run_segment(st, tl, tb, compact_levels=lv,
                                     graphs=g, blocks=who != "drain")
        torch.cuda.synchronize()
        seg[who] = (st, dict(wall=time.perf_counter() - t0, steps=taken,
                             device_ms=g.segment_ms()[0]["ms"],
                             captures=g.captures, capture_s=g.capture_s,
                             step_ms={str(k): v for k, v in
                                      g.step_ms().items()}))
        print(f"compact segment, {who}: {json.dumps(seg[who][1])}")
    for who in ("levels 0", f"levels {auto}"):
        diff = [f.name for f in dataclasses.fields(st0)
                if not same_bits(getattr(seg["drain"][0], f.name),
                                 getattr(seg[who][0], f.name))]
        if diff or seg[who][1]["steps"] != seg["drain"][1]["steps"]:
            fail(f"compact: the drain's lanes differ from the block loop's "
                 f"at {who} in {diff}, or its steps")
    print(f"compact segment: every per-lane field of {eng.batch_size} "
          f"lanes bit-identical in the drain and the block loop at levels "
          f"0 and {auto}")
    return dict(counts=counts, wall=wall, wall_auto=f64["wall"],
                transport=res.timers.totals["transport"],
                transport_auto=ref.timers.totals["transport"],
                graphs=graphs_line(res), graphs_auto=graphs_line(ref),
                worst=worst, segment={k: v[1] for k, v in seg.items()},
                lanes=seg["drain"][0].to_numpy())


def oblique_path(dev) -> dict:
    """Phase oblique: tests/test_oblique.py's two checks on the card, at
    float64 on the flagship population (wl.LANES lanes at pcut index 2):
    one OBLIQUE_STEPS-step block through the oblique branches at
    theta_B = 0 against the parallel branches (integer fields equal,
    float fields within OBLIQUE_TOL relative: momenta relative to |p|, a
    position relative to the larger of |x| and the lane's path; the
    phase, which the oblique step adjusts at every scattering and which
    at theta_B = 0 reaches only the pxz tally, is not compared); one
    block at theta_B = 30 degrees in a uniform flow, where each ACTIVE
    lane's plasma-frame |p| must stay within OBLIQUE_TOL."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.ops import rng
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl
    from montecarloscattering_jl_tpu_torch.utils import load_config
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup

    cfg = load_config(wl.CFG)
    setup = build_setup(cfg)
    eng = TransportEngine(setup, device=dev)
    ss = eng.step_static(0)
    obl = dataclasses.replace(ss, parallel=False)
    sc = eng.segment_scalars(0, 2, setup.profile.bmag2)
    grids = eng.segment_grids(setup.profile)
    st0 = wl.flagship_population(setup, cfg, dev, p_dtype=torch.float64)
    b = setup.bins

    def block(st, gr, s):
        tb = xla_step.step_tables(gr, sc, s, dev)
        tl = stt.make_tallies(setup.nb, b.n_mom, b.n_theta, dev)
        for _ in range(OBLIQUE_STEPS):
            xla_step.helix_step(st, tl, tb, rng.lane_uniforms_xla(
                st.key0, st.key1, st.nsteps), 10_000)
        torch.cuda.synchronize()
        return st

    par = block(stt.clone(st0), grids, ss)
    ob = block(stt.clone(st0), grids, obl)
    div = sum(int((getattr(par, f) != getattr(ob, f)).sum())
              for f in ("status", "reason", "nsteps", "igrid", "flags",
                        "tcut"))
    p = torch.hypot(par.pb, par.pperp)
    err = {}
    for f in ("pb", "pperp", "x", "prp_x", "acctime", "ux_prev", "xn_per",
              "t_step"):
        a, c = getattr(par, f), getattr(ob, f)
        scale = p if f in ("pb", "pperp") else a.abs()
        if f == "x":
            scale = torch.maximum(scale, (a - st0.x).abs())
        err[f] = float(((c - a).abs() / scale.clamp(min=1e-300)).max())
    moved = int((par.nsteps - st0.nsteps).sum())
    print(f"oblique at theta_B = 0 against parallel, {OBLIQUE_STEPS} steps, "
          f"{moved} pushes: integer fields differ {div} times; largest "
          f"relative difference {json.dumps(err)}")
    if div or not max(err.values()) <= OBLIQUE_TOL:
        fail(f"oblique: theta_B = 0 does not reduce to the parallel step")

    # theta_B = 30 degrees in a uniform flow: no frame change fires
    nb = grids.ux.shape[0]
    theta = math.pi / 6
    full = lambda v, a: torch.full_like(a, v)
    u0, g0 = float(grids.ux[1]), float(grids.gamma_sf[1])
    uni = dataclasses.replace(
        grids, ux=full(u0, grids.ux), uz=full(0.0, grids.uz),
        utot=full(abs(u0), grids.utot), gamma_sf=full(g0, grids.gamma_sf),
        b_cos=full(math.cos(theta), grids.b_cos),
        b_sin=full(math.sin(theta), grids.b_sin))
    st = stt.clone(st0)
    st.ux_prev.fill_(u0)
    p0 = torch.hypot(st.pb, st.pperp)
    st = block(st, uni, dataclasses.replace(obl, do_rad_losses=False))
    alive = st.status == stt.ACTIVE
    drift = float(((torch.hypot(st.pb, st.pperp) - p0).abs()
                   / p0)[alive].max())
    print(f"oblique at 30 degrees, uniform flow ({nb} zones), "
          f"{int(alive.sum())} lanes ACTIVE after {OBLIQUE_STEPS} steps: "
          f"largest relative change of |p| {drift:.3e}")
    if not (int(alive.sum()) > 0 and drift <= OBLIQUE_TOL):
        fail(f"oblique: |p| not conserved at 30 degrees ({drift!r})")
    return dict(theta0=err, uniform_p_drift=drift)


def kw_path(dev) -> dict:
    """Phase kw: scripts/flagship_keshet_waxman.py of the port at float32
    on K1, host split, N_g = KW_NG, KW_PER_PCUT a pcut, the helix cap
    KW_CAP and pmax KW_PMAX (the sweep's point, kw_sweep.json); every
    drain timed (a synchronize around it) and launching K1.  Gate: the
    script's |s_fit - s_KW| <= KW_TOL."""
    import torch

    from montecarloscattering_jl_tpu_torch.scripts import (
        flagship_keshet_waxman as kw, workloads as wl)

    zero_counts()
    with wl.timed_drains() as drains:
        out = kw.measure(KW_PER_PCUT, KW_NG, KW_CAP, KW_PMAX, device=dev)
    counts = read_counts()
    check_engine("kw", counts, torch.float32)
    if any(k < 1 for _, k, _ in drains) or counts["k1"] != len(drains):
        fail(f"kw: a drain without its K1 launch: {drains}")
    longest = max(drains)
    ok = abs(out["s_fit"] - out["s_kw"]) <= KW_TOL
    print(f"kw: s_fit {out['s_fit']:.4f} against s_KW {out['s_kw']:.4f} "
          f"(tol {KW_TOL}, {out['n_bins']} bins): "
          f"{'PASSED' if ok else 'FAILED'}; {out['pushes']} pushes, "
          f"{out['trajectories']} trajectories in {out['wall']:.2f} s; "
          f"{len(drains)} drains, K1 launches {counts['k1']}, the longest "
          f"{longest[0]:.1f} ms ({longest[2]} pushes); drains "
          f"{json.dumps([round(d[0], 1) for d in drains])} ms")
    if not ok:
        fail(f"kw: |s_fit - s_KW| = {abs(out['s_fit'] - out['s_kw']):.4f} "
             f"> {KW_TOL}")
    return dict(counts=counts, s_fit=out["s_fit"], s_kw=out["s_kw"],
                pushes=out["pushes"], wall=out["wall"],
                longest_drain_ms=longest[0], drains=len(drains))


def endurance_path(dev) -> dict:
    """Phase endurance: scripts/flagship_endurance.py of the port on K1
    (float32) at wl.LANES a pcut, ENDURANCE_TRAJECTORIES trajectories
    (about 8 blocks): allocated device memory may drift by less than 1%
    from block 2 to the last; the rate per block is printed."""
    import torch

    from montecarloscattering_jl_tpu_torch.scripts import (
        flagship_endurance as fe, workloads as wl)

    zero_counts()
    out = fe.endurance(ENDURANCE_TRAJECTORIES, wl.LANES, device=dev)
    counts = read_counts()
    check_engine("endurance", counts, torch.float32)
    rates = [b["mpushes_per_s"] for b in out["blocks"]]
    print(f"endurance: {len(out['blocks'])} blocks, M pushes/s {rates}; "
          f"memory drift {out['drift']:+.4%}, rate floor "
          f"{out['rate_floor']:+.2%}; launches {json.dumps(counts)}")
    if not out["drift_ok"]:
        fail(f"endurance: allocated memory drifts by {out['drift']:+.2%}")
    return dict(counts=counts, blocks=out["blocks"], drift=out["drift"],
                rate_floor=out["rate_floor"], wall=out["wall"])


def mesh_rank(mesh, parts) -> dict:
    """One rank of phase mesh (started by parallel/multihost.spawn): the
    `parts` of MESH_PARTS in order, each with every kernel's launch count
    set to 0 before it and read after it, checked on this rank.  The
    hybrid parts' fused ladders run under ``counted_ladders`` (their host
    waits and sync points a species), and the part's collectives are
    held to a gather a sync point and one at the end a species, its
    reductions and MESH_BARRIERS; each rank returns its chain (pushes,
    new lanes and the splits' integers a species).  Rank 0 returns the
    driven runs' results (without their graph caches) and the gathered
    lanes of "xla"."""
    import torch

    from montecarloscattering_jl_tpu_torch.engine.driver import run
    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.ops import state as stt
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step
    from montecarloscattering_jl_tpu_torch.parallel import multihost, shard
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    dev, out = mesh.device, {}
    for part in parts:
        c0, s0 = mesh.collectives, mesh.collective_s
        shard.barrier(mesh)
        zero_counts()
        t0 = time.perf_counter()
        extra = {}
        if part != "xla":
            hybrid = part != "host"
            cfg = flagship_config(torch.float32, 2 if hybrid else 1, False)
            tag = f"mesh {part} rank {mesh.rank}"
            with contextlib.ExitStack() as stack:
                if part == "hybrid@1":
                    stack.enter_context(sync_every("1"))
                ladders = (stack.enter_context(counted_ladders(tag))
                           if hybrid else [])
                d = stack.enter_context(tempfile.TemporaryDirectory())
                res = run(cfg, device=dev, out_dir=d, p_dtype=torch.float32,
                          fused=hybrid, mesh=mesh)
                torch.cuda.synchronize()
                written = sorted(os.listdir(d))
            pushes = res.n_pushes
            want = expected_files(cfg) if mesh.rank == 0 else []
            if sorted(set(written) & set(want)) != sorted(want) or (
                    mesh.rank and written):
                fail(f"{tag}: wrote {written}")
            if hybrid:
                coll = MESH_BARRIERS + sum(r["sync_points"] + 1
                                           + MESH_REDUCTIONS for r in ladders)
                if mesh.collectives - c0 != coll:
                    fail(f"{tag}: {mesh.collectives - c0} collectives, "
                         f"{coll} expected at the ladders' sync points "
                         f"{[r['sync_points'] for r in ladders]}")
                extra = dict(ladders=ladders, chain=[
                    dict(pushes=f.n_pushes, n_new=f.n_new,
                         splits=[{k: sp[k].tolist() for k in SPLIT_INTS}
                                 for sp in f.splits])
                    for itr in res.iterations for f in itr.ion_finals])
            res.graphs = None
        else:
            cfg = flagship_config(torch.float64, 1, True)
            setup = build_setup(cfg)
            eng = TransportEngine(setup, device=dev, mesh=mesh)
            ss = eng.step_static(0)
            tb = xla_step.step_tables(
                eng.segment_grids(setup.profile),
                eng.segment_scalars(0, 0, setup.profile.bmag2), ss, dev)
            st = multihost.global_state(wl.flagship_population(
                setup, cfg, dev, lanes=eng.batch_size,
                p_dtype=torch.float64), mesh)
            b = setup.bins
            tl = stt.make_tallies(setup.nb, b.n_mom, b.n_theta, dev,
                                  n_xspec=ss.n_xspec)
            xla_step.run_segment(st, tl, tb, compact_levels=eng.compact_levels,
                                 graphs=xla_step.GraphCache())
            torch.cuda.synchronize()
            full = shard.gather_state(st, mesh)
            pushes = int(full.nsteps.sum(dtype=torch.int64))
            res = dict(lanes=full.to_numpy(), batch=eng.batch_size,
                       levels=eng.compact_levels)
        wall = time.perf_counter() - t0
        counts = read_counts()
        check_engine(f"mesh {part} rank {mesh.rank}", counts,
                     torch.float64 if part == "xla" else torch.float32)
        if part != "xla":
            check_rebin(f"mesh {part} rank {mesh.rank}", counts, res,
                        cfg.n_ions)
            check_finish(f"mesh {part} rank {mesh.rank}", counts, res, cfg)
        out[part] = dict(
            result=res if mesh.rank == 0 else None, counts=counts,
            wall=wall, pushes=pushes, collectives=mesh.collectives - c0,
            collective_s=mesh.collective_s - s0, **extra)
    return dict(rank=mesh.rank, device=str(dev), backend=mesh.backend,
                shared=shard.shared_cards(mesh), parts=out)


def hybrid_against(res, ref) -> dict:
    """Pushes and trajectories of `res` against `ref`, over the run and
    over iteration 1: |a - b| / min(a, b)."""
    out = {}
    for span, its in (("run", slice(None)), ("iteration 1", slice(0, 1))):
        tot = lambda r, k: sum(getattr(f, k) for itr in r.iterations[its]
                               for f in itr.ion_finals)
        out[span] = {k.replace("n_", ""): abs(tot(res, k) - tot(ref, k))
                     / min(tot(res, k), tot(ref, k))
                     for k in ("n_pushes", "n_trajectories")}
    return out


def split_faults(res, world: int) -> tuple[list, int, float]:
    """Every mesh hybrid segment's split (``IonFinal.splits``) against
    its contract: rank r's share of the segment's target n_target is
    n_target // world, one more on the first n_target % world ranks; it
    makes n_saved_r * max(share // n_saved_r, 1) new lanes (none without
    a saved lane), which sum to the segment's n_new; and its new lanes'
    weight is its saved lanes' within MESH_SPLIT_WEIGHT_TOL.  Returns
    (faults, segments checked, the largest relative weight change)."""
    faults, n, worst = [], 0, 0.0
    for i, itr in enumerate(res.iterations):
        for j, f in enumerate(itr.ion_finals):
            if f.splits is None or len(f.splits) != len(f.n_new):
                faults.append(f"iteration {i + 1} species {j}: "
                              f"{f.splits!r} for n_new {f.n_new}")
                continue
            for k, (sp, n_new) in enumerate(zip(f.splits, f.n_new)):
                at = f"iteration {i + 1} species {j} segment {k}"
                nt = sp["n_target"]
                share = [nt // world + (r < nt % world)
                         for r in range(world)]
                made = [s * max(t // s, 1) if s else 0
                        for s, t in zip(sp["n_saved"].tolist(), share)]
                if sp["target"].tolist() != share:
                    faults.append(f"{at}: shares {sp['target']} of {nt}")
                if sp["n_new"].tolist() != made or sum(made) != n_new:
                    faults.append(f"{at}: new lanes {sp['n_new']} (n_new "
                                  f"{n_new}) from {sp['n_saved']} saved")
                for ws, wn in zip(sp["w_saved"], sp["w_new"]):
                    rel = abs(wn - ws) / ws if ws else abs(wn)
                    worst = max(worst, rel)
                    if rel > MESH_SPLIT_WEIGHT_TOL:
                        faults.append(f"{at}: new weight {wn!r} from saved "
                                      f"{ws!r}")
                n += 1
    return faults, n, worst


def mesh_path(dev, f32, compact) -> dict:
    """Phase mesh (see the module's docstring, 18): K1's host split
    against this process's run, the mesh hybrid against phase f32's run
    (`f32`), the XLA engine's segment against phase compact's lanes
    (`compact`); every rank on the one card under gloo, and under NCCL
    with a card a rank where there are two."""
    import numpy as np
    import torch

    from montecarloscattering_jl_tpu_torch.parallel import multihost

    ref, _, wall1, _ = drive(flagship_config(torch.float32, 1, False), dev,
                             torch.float32, "mesh world 1", fused=False)
    t0 = time.perf_counter()
    ranks = multihost.spawn(mesh_rank, MESH_RANKS, args=(MESH_PARTS,),
                            backend="gloo", device="cuda", timeout=900)
    spawn_wall = time.perf_counter() - t0
    sharing = (f"{MESH_RANKS} processes sharing one card (gloo)"
               if all(r["shared"] for r in ranks) else
               f"{MESH_RANKS} ranks (gloo)")
    out = {}
    for part in MESH_PARTS:
        rows = [r["parts"][part] for r in ranks]
        res = rows[0]["result"]
        wall = max(r["wall"] for r in rows)
        pushes = rows[0]["pushes"]
        line = dict(wall_s=wall, pushes=pushes,
                    pushes_per_s=pushes / wall,
                    k1_launches=[r["counts"]["k1"] for r in rows],
                    k2_launches=[r["counts"]["k2"] for r in rows],
                    k5_launches=[r["counts"]["k5"] for r in rows],
                    twin_calls=[r["counts"]["twin"] for r in rows],
                    collectives=[r["collectives"] for r in rows],
                    collective_s=[r["collective_s"] for r in rows])
        if part == "host":
            worst = hold_to_f64("mesh host", ref, res, against="world 1",
                                spectra=False)
            line["worst"] = worst
        elif part.startswith("hybrid"):
            slope, expect = slope_of(res)
            rel = hybrid_against(res, f32["result"])
            faults, n_seg, worst = split_faults(res, MESH_RANKS)
            line.update(slope=slope, expected=expect, against_f32=rel,
                        trajectories=res.n_trajectories,
                        n_new=[f.n_new for itr in res.iterations
                               for f in itr.ion_finals],
                        n_saved=[[sp["n_saved"].tolist() for sp in f.splits]
                                 for itr in res.iterations
                                 for f in itr.ion_finals],
                        splits_checked=n_seg, split_weight_rel_max=worst,
                        ladders=[[{k: lad[k] for k in (
                            "iteration", "species", "segments", "waits",
                            "sync_points")} for lad in r["ladders"]]
                                 for r in rows])
            if not math.isfinite(slope) or abs(slope - expect) > 0.45:
                fail(f"mesh {part}: slope {slope} vs {expect}")
            if any(v > MESH_HYBRID_TOL for v in rel["iteration 1"].values()):
                fail(f"mesh {part}, iteration 1: {rel['iteration 1']} "
                     f"against phase f32's run (bound {MESH_HYBRID_TOL})")
            if faults or n_seg == 0:
                fail(f"mesh {part}: {n_seg} splits checked, faults "
                     f"{faults}")
            # every rank sees the same gathered splits; at one segment a
            # sync the ranks read what they read at the default cadence
            chains = [r["chain"] for r in rows]
            if any(c != chains[0] for c in chains):
                fail(f"mesh {part}: the ranks' chains differ: {chains}")
            if part == "hybrid@1":
                ref_chains = [r["parts"]["hybrid"]["chain"] for r in ranks]
                if chains != ref_chains:
                    fail(f"mesh hybrid@1: pushes, new lanes or splits differ "
                         f"from the default cadence's: {chains} against "
                         f"{ref_chains}")
        else:
            lanes, want = res["lanes"], compact["lanes"]
            diff = [k for k in want if not np.array_equal(lanes[k], want[k])]
            if diff:
                fail(f"mesh xla: the gathered lanes differ from phase "
                     f"compact's in {diff}")
            line.update(batch=res["batch"], levels_per_shard=res["levels"],
                        lanes_identical=len(want["weight"]))
        out[part] = dict(line, counts=[r["counts"] for r in rows])
        print(f"mesh {part} ({sharing}): {json.dumps(line)}")
    print(f"mesh: world 1 against world {MESH_RANKS} on one card, K1 host "
          f"split, 1 iteration: {wall1:.2f} s against "
          f"{out['host']['wall_s']:.2f} s ({sharing}; ranks' start and "
          f"all parts {spawn_wall:.1f} s)")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        nccl = multihost.spawn(mesh_rank, 2, args=(("host",),),
                               backend="nccl", device="cuda", timeout=600)
        rows = [r["parts"]["host"] for r in nccl]
        line = dict(wall_s=max(r["wall"] for r in rows),
                    k1_launches=[r["counts"]["k1"] for r in rows],
                    worst=hold_to_f64("mesh nccl", ref, rows[0]["result"],
                                      against="world 1", spectra=False))
        print(f"mesh nccl (2 cards, a card a rank): {json.dumps(line)}")
        out["nccl"] = dict(line, counts=[r["counts"] for r in rows])
    else:
        print(f"mesh nccl: not run: {n_cards} CUDA card visible, and NCCL "
              f"takes one card a rank")
    return out


def nonlinear_path(dev) -> dict:
    """Phase nonlinear: the nonlinear flagship (scripts/flagship_nonlinear
    .py) at wl.LANES a pcut, NONLINEAR_ITERS iterations on K1 with an
    iteration checkpoint each: an uninterrupted run; a run with
    segment-boundary checkpoints every NONLINEAR_MID_EVERY segments
    that the stop hook kills at its first save of iteration
    KILL_ITER + 1; its resume to the end.  Gates: the odd iterations'
    max pxx_norm decays towards 1 in both; iterations 1 to KILL_ITER of
    the killed run equal the uninterrupted run's in pushes and
    trajectories (the checkpoint's totals); after the kill the resumed
    run agrees with the uninterrupted one within 3 NONLINEAR_SPREAD."""
    import torch

    from montecarloscattering_jl_tpu_torch.parallel import checkpoint as ck
    from montecarloscattering_jl_tpu_torch.scripts import (
        flagship_nonlinear as fn, workloads as wl)

    cfg = lambda: fn.nonlinear_config(wl.LANES, NONLINEAR_ITERS)
    f32 = torch.float32
    with tempfile.TemporaryDirectory() as d:
        pa, pk = os.path.join(d, "a.npz"), os.path.join(d, "k.npz")
        ref, counts_a, wall_a, _ = drive(cfg(), dev, f32, "nonlinear",
                                         checkpoint=pa)
        with wl.kill_at(KILL_ITER) as made:
            _, counts_k, wall_k, _ = drive(
                cfg(), dev, f32, "nonlinear killed", killed=True,
                checkpoint=pk, mid_every=NONLINEAR_MID_EVERY)
        mid = pk + ".mid"
        size = os.path.getsize(mid)
        peek = ck.load_mid_checkpoint(mid)
        if (peek["i_iter"], peek["i_ion"]) != (KILL_ITER, 0):
            fail(f"nonlinear: the kill fell in iteration {peek['i_iter']}")
        res, counts_r, wall_r, _ = drive(
            cfg(), dev, f32, "nonlinear resumed", checkpoint=pk,
            resume=mid, mid_every=NONLINEAR_MID_EVERY)
    saver = made[0]
    mid_ms = saver.seconds / saver.n_saved * 1e3
    t = ref.timers
    ck_ms = t.totals["checkpoint"] / t.counts["checkpoint"] * 1e3
    rows_a = fn.iteration_rows(ref)
    rows_r = fn.iteration_rows(res, KILL_ITER + 1)
    for tag, rows in (("uninterrupted", rows_a), ("resumed", rows_r)):
        for r in rows:
            print(f"nonlinear {tag} {json.dumps(r)}")
    print(f"nonlinear: wall uninterrupted {wall_a:.2f} s "
          f"({ref.n_pushes / wall_a / 1e6:.1f} M pushes/s), killed "
          f"{wall_k:.2f} s + resumed {wall_r:.2f} s; {saver.n_saved} mid "
          f"saves of {size} B, {mid_ms:.2f} ms each (killed run); "
          f"iteration checkpoint {ck_ms:.2f} ms")
    # the overshoot decays over the odd iterations (the even ones are
    # damped by the smoothing's relaxation)
    last_odd = (NONLINEAR_ITERS - 1) // 2 * 2     # 0-based
    first = rows_a[0]["pxx_norm_max"]
    for tag, last in (("uninterrupted", rows_a[last_odd]["pxx_norm_max"]),
                      ("resumed", rows_r[last_odd - KILL_ITER][
                          "pxx_norm_max"])):
        if not (last < first and abs(last - 1.0) < abs(first - 1.0)):
            fail(f"nonlinear {tag}: max pxx_norm {last} at iteration "
                 f"{last_odd + 1} does not decay from {first}")
    drv = peek["driver"]
    before = (sum(r["pushes"] for r in rows_a[:KILL_ITER]),
              sum(r["trajectories"] for r in rows_a[:KILL_ITER]))
    killed = (int(drv["engine_pushes"]), int(drv["engine_trajs"]))
    print(f"nonlinear: iterations 1-{KILL_ITER} pushes, trajectories: "
          f"killed {killed}, uninterrupted {before}; escape fractions "
          f"killed {drv['px_esc_hist'][:KILL_ITER].tolist()}, "
          f"uninterrupted {[r['px_esc_frac'] for r in rows_a[:KILL_ITER]]}")
    if killed != before:
        fail("nonlinear: the killed run's first iterations differ")
    worst = {}
    for key, spread in NONLINEAR_SPREAD.items():
        diff = max(abs(a[key] - b[key])
                   for a, b in zip(rows_a[KILL_ITER:], rows_r))
        worst[key] = diff
        if diff > 3.0 * spread:
            fail(f"nonlinear: resumed {key} differs by {diff!r}, beyond 3x "
                 f"the spread {spread!r}")
    print(f"nonlinear: resumed against uninterrupted, iterations "
          f"{KILL_ITER + 1}-{NONLINEAR_ITERS}, largest difference "
          f"{json.dumps(worst)} (3x spread {json.dumps(NONLINEAR_SPREAD)})")
    both = {k: counts_a[k] + counts_k[k] + counts_r[k] for k in counts_a}
    return dict(counts=both, wall=wall_a, wall_killed=wall_k,
                wall_resumed=wall_r, pushes=ref.n_pushes, rows=rows_a,
                resumed_rows=rows_r, mid_bytes=size, mid_ms=mid_ms,
                checkpoint_ms=ck_ms, worst=worst)


def cli_phase(dev) -> dict:
    """Phase cli: the port's CLI as a user runs it, ``python -m
    montecarloscattering_jl_tpu_torch CONFIG -o DIR``, in a process of
    its own on each of CLI_CONFIGS as shipped, at its default (float64
    momenta on the XLA engine: K5's drain) and with ``--f32`` (K1 where
    its gate admits the config): exit code 0, its completion line
    ("finished: N iterations, ...", the JAX CLI's; neither CLI prints
    "Done") with the config's iterations and nonzero pushes, "outputs
    written to", and the file set of expected_files.  Then
    scripts/pod_scale.py as shipped (``python -m
    montecarloscattering_jl_tpu_torch.scripts.pod_scale``: every visible
    card, float64 on K5) and with ``--f32`` (K1): exit code 0, its
    device line, its two result lines and nonzero pushes.  Each run's
    wall time, the process's start included."""
    import re
    import subprocess

    import torch

    from montecarloscattering_jl_tpu_torch.utils import load_config

    out = {}
    for flags in ((), ("--f32",)):
        for rel in CLI_CONFIGS:
            path = os.path.join(ROOT, rel)
            cfg = load_config(path)
            tag = " ".join((rel,) + flags)
            with tempfile.TemporaryDirectory() as d:
                t0 = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "-m",
                     "montecarloscattering_jl_tpu_torch", path, "-o", d,
                     *flags], cwd=ROOT, capture_output=True, text=True,
                    timeout=CLI_TIMEOUT)
                wall = time.perf_counter() - t0
                written = sorted(os.listdir(d))
            if r.returncode != 0:
                fail(f"cli {tag}: exit {r.returncode}: {r.stderr[-2000:]}")
            m = re.search(r"finished: (\d+) iterations, (\d+) trajectories, "
                          r"(\d+) pushes in ([\d.]+)s", r.stdout)
            if (m is None or int(m.group(1)) != cfg.n_itrs
                    or int(m.group(3)) <= 0
                    or "outputs written to" not in r.stdout):
                fail(f"cli {tag}: {r.stdout[-2000:]}")
            missing = [f for f in expected_files(cfg) if f not in written]
            if missing:
                fail(f"cli {tag}: output files missing: {missing} (got "
                     f"{written})")
            out[tag] = dict(wall=wall, run_s=float(m.group(4)),
                            iterations=cfg.n_itrs,
                            trajectories=int(m.group(2)),
                            pushes=int(m.group(3)), files=len(written))
            print(f"cli {tag}: {json.dumps(out[tag])}")
    n_cards = torch.cuda.device_count()
    for flags in ((), ("--f32",)):
        tag = " ".join(("scripts/pod_scale.py",) + flags)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m",
             "montecarloscattering_jl_tpu_torch.scripts.pod_scale", *flags],
            cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"cli {tag}: exit {r.returncode}: {r.stderr[-2000:]}")
        # its device line and its two result lines
        lines = r.stdout.splitlines() + ["", "", ""]
        m = re.match(r"(\d+) trajectories, (\d+) pushes in ([\d.]+)s -> ",
                     lines[1])
        if (not lines[0].startswith(f"devices: {n_cards} x cuda")
                or m is None or int(m.group(2)) <= 0
                or not lines[2].startswith(
                    "escaping / far-upstream energy flux: ")):
            fail(f"cli {tag}: {r.stdout[-2000:]}")
        out[tag] = dict(wall=wall, run_s=float(m.group(3)),
                        ranks=n_cards, trajectories=int(m.group(1)),
                        pushes=int(m.group(2)))
        print(f"cli {tag}: {json.dumps(out[tag])}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT,
                                      "montecarloscattering_jl_tpu_torch")):
        print("chip_smoke: run from the root of a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from montecarloscattering_jl_tpu_torch.ops import build
    from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

    t_start = time.perf_counter()
    card = wl.card_line()
    print(f"nvidia-smi: {card}")
    name = torch.cuda.get_device_name(0)
    print(f"torch: {torch.__version__} cuda {torch.version.cuda}; "
          f"device: {name}")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    from montecarloscattering_jl_tpu_torch.ops import helix

    libs = build.build_all(["finish", "mega_step", "psd_hist", "rebin",
                            *helix.targets()], verbose=True)
    print(f"build (nvcc, in parallel): {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in libs.values())})")

    done = {}
    for phase, fn in (("k1", kernel_vs_twin), ("flags", kernel_vs_twin_flags),
                      ("hist", hist_phase),
                      ("rebin", rebin_phase),
                      ("finish", finish_phase),
                      ("k5", k5_phase),
                      ("f32", lambda d: main_path(d, torch.float32, 2,
                                                  False)),
                      ("science", science_path),
                      ("electrons32", electron_path_f32),
                      ("sed", sed_path),
                      ("electrons", electron_path),
                      ("f64", lambda d: main_path(d, torch.float64, 1, True)),
                      ("resume", lambda d: resume_path(d, done["f64"])),
                      ("shipped", shipped_path),
                      ("nonlinear", nonlinear_path),
                      ("compact", lambda d: compact_path(d, done["f64"])),
                      ("oblique", oblique_path),
                      ("kw", kw_path),
                      ("endurance", endurance_path),
                      ("mesh", lambda d: mesh_path(d, done["f32"],
                                                   done["compact"])),
                      ("cli", cli_phase)):
        t0 = time.perf_counter()
        done[phase] = fn(dev)
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    # after the phases: an instance's resident blocks are known once it
    # has launched
    instances = k1_instances(build.LOGS.get("mega_step", ""))
    k5_inst = k5_instances()
    print(f"K5 instances: {json.dumps(k5_inst)}")
    print(json.dumps({"kernels": kernel_records(done, instances, k5_inst)}))
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def k1_instances(ptxas_log: str) -> list:
    """Every K1 instance with its flag word (ops/mega.py INSTANCES), its
    registers and local-memory bytes a thread from the CUDA runtime and,
    where this run compiled the source (``-Xptxas -v``), its stack frame
    and spill bytes."""
    import re

    from montecarloscattering_jl_tpu_torch.ops import mega

    said = {}
    for blk in re.split(r"Compiling entry function '", ptxas_log)[1:]:
        m = re.match(r"\w*mega_step_kernelILi(n?)(\d+)E", blk)
        regs = re.search(r"Used (\d+) registers", blk)
        mem = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads", blk)
        if m and regs and mem:
            word = -int(m.group(2)) if m.group(1) else int(m.group(2))
            said[word] = dict(ptxas_registers=int(regs.group(1)),
                              stack_bytes=int(mem.group(1)),
                              spill_store_bytes=int(mem.group(2)),
                              spill_load_bytes=int(mem.group(3)))
    return [dict(mega.instance_attrs(i), **said.get(word, {}))
            for i, word in enumerate(mega.INSTANCES)]


def k5_instances() -> dict:
    """Every K5 instance (ops/helix.py INSTANCES) of both builds (the
    default and the f(r_g) law's, FRG_BUILD) with its registers and
    local-memory bytes a thread from the CUDA runtime, its window
    kernel's and its drain's, and, where this run compiled the source,
    their stack frames and spill bytes."""
    from montecarloscattering_jl_tpu_torch.ops import build, helix

    out = {}
    for frg, (name, defines, _) in enumerate(helix.targets()):
        said = helix.ptxas_report(
            build.LOGS.get(build.log_key(name, defines), ""))
        out["frg" if frg else "default"] = [
            dict(helix.instance_attrs(i, frg=bool(frg)),
                 ptxas=said.get(key, {}))
            for i, key in enumerate(helix.INSTANCES)]
    return out


def kernel_records(done, instances, k5_inst) -> list:
    """The kernels line: every kernel with its main-path launches (K1 on
    the flagship f32, science, electrons32, sed, nonlinear, kw, endurance
    and mesh paths, K5 on the f64 flagship, resume, shipped, electron,
    compact and mesh paths, the mesh's on every rank; K2's standalone
    launches on the same paths, and its deposits inside K5; the
    rebinning and the finish kernel on all of them), its error against
    its plain version, its time, its plain version's, its bound and the library
    call's.  K2's and K4's ``ms`` and ``library_ms`` are device times
    under CUDA-graph replay (``eager_ms`` and ``library_eager_ms``: the
    eager calls'); K1 carries its full drains and its instances."""
    src = "montecarloscattering_jl_tpu_torch/csrc/"
    hp, k1 = done["hist"], done["k1"]
    k2, k3, k4 = (hp["K2 (69,632 records)"], hp["K3 band=2048"],
                  hp["K4 = K2 (2^16 records)"])
    mesh = lambda kernel: sum(c[kernel] for part in done["mesh"].values()
                              for c in part.get("counts", []))
    k1_paths = lambda kernel: (
        done["f32"][kernel] + done["science"]["counts"][kernel]
        + done["electrons32"]["counts"][kernel]
        + done["sed"]["counts"][kernel]
        + done["nonlinear"]["counts"][kernel]
        + done["kw"]["counts"][kernel]
        + done["endurance"]["counts"][kernel] + mesh(kernel))
    k1_launches = k1_paths("k1")
    f64_paths = lambda kernel: (
        done["f64"][kernel] + done["shipped"]["counts"][kernel]
        + done["electrons"]["counts"][kernel]
        + done["resume"]["counts"][kernel]
        + done["compact"]["counts"][kernel] + mesh(kernel))
    k2_launches = f64_paths("k2")
    k5_deposits = f64_paths("k5_deposit_steps")
    k5 = done["k5"]
    k5f, k5d = k5["flagship"], k5["drain"]
    rec = lambda r: dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"],
                         library_ms=r.get("library_ms"))
    eager = lambda r: dict(eager_ms=r["eager_ms"],
                           library_eager_ms=r["library_eager_ms"])
    case = lambda v: dict(ms=v["ms"], plain_ms=v["plain_ms"],
                          bound_ms=v["bound_ms"])
    return [
        {"name": "K5 helix_step", "route": "cuda",
         "source": src + "helix_step.cu",
         "replaces": "montecarloscattering_jl_tpu/ops/step.py:198",
         "launches": f64_paths("k5"), "drains": f64_paths("k5_drains"),
         "windows": f64_paths("k5") - f64_paths("k5_drains"),
         "host_reads_in_segments": f64_paths("k5_host_reads"),
         **rec(k5d), "block_loop_ms": k5d["blocks_ms"],
         "bound_share": k5d["bound_share"],
         "drain_pushes": k5d["drain"]["pushes"],
         "capped_drain": case(k5["capped"]),
         "window": dict(rec(k5f), instance=k5f["instance"]),
         "window_ms_by_size": k5d["blocks"]["window_ms"],
         "lane_max_rel": max(v for k, v in k5f["lanes"].items()
                             if k.startswith("maxrel_")),
         "cases": {k: dict(instance=v["instance"], window=case(v),
                           drain=case(k5["case_drains"][k]),
                           divergent_lanes=v["lanes"]["divergent_lanes"])
                   for k, v in k5["cases"].items()},
         "instances": k5_inst, "residency": k5["residency"],
         "note": "the XLA engine's helix step (not a Pallas kernel); ms: "
                 "one drain of the f64 flagship's 69,632 injected lanes "
                 "(pcut 0, a full segment), CUDA events around its one "
                 "launch; plain_ms: the same segment on the plain step's "
                 "CUDA graphs, block_loop_ms: as K5 windows of 64 steps; "
                 "window: one 64-step window, enqueued; no single "
                 "PyTorch call computes a helix step"},
        {"name": "K1 mega_step", "route": "cuda",
         "source": src + "mega_step.cu",
         "replaces": "montecarloscattering_jl_tpu/ops/pallas_step.py:225",
         "launches": k1_launches, **rec(k1),
         "waited_ms": k1["waited_ms"],
         "full_drain": k1["full_drain"],
         "kw_longest_drain_ms": done["kw"]["longest_drain_ms"],
         "science_drain": k1["science_drain"],
         "drain_pushes_per_s": k1["full_drain"]["pushes_per_s"],
         "instances": instances,
         "note": "timed on the flagship's 64-step window at 65,536 "
                 "lanes, enqueued only (waited_ms: through mega.launch, "
                 "with validation and one host wait a launch); no single "
                 "PyTorch call computes a helix step; "
                 "full_drain: the same lanes to the config's helix cap"},
        {"name": "K2 psd_scatter", "route": "cuda",
         "source": src + "psd_hist.cu",
         "replaces": "montecarloscattering_jl_tpu/ops/pallas_hist.py:149",
         "launches": k2_launches, **rec(k2), **eager(k2),
         "deposits_in_k5": k5_deposits,
         "wide_ms": hp["K2 (69,632 records, int64 zones, float64 "
                       "weights)"]["ms"],
         "note": "ms and library_ms under CUDA-graph replay; launches: "
                 "its standalone launches on the main paths (the plain "
                 "oblique step's, none on a path); deposits_in_k5: the "
                 "helix steps whose PSD records K5 deposited through "
                 "K2's warp deposit (csrc/psd_deposit.cuh); wide_ms: on "
                 "the plain step's int64 zones and float64 weights"},
        {"name": "K3 psd_scatter_band", "route": "cuda",
         "source": src + "psd_hist.cu",
         "replaces": "scripts/probe_hist.py:97",
         "launches": done["f64"]["k3"], **rec(k3),
         "eager_ms": k3["eager_ms"], "bound_share": k3["bound_share"],
         "note": "probe kernel, off the main path; timed at band 2,048 "
                 "at 2^21 records, ms under CUDA-graph replay; one "
                 "cooperative launch; its band filter has no single "
                 "PyTorch call"},
        {"name": "rebin dndp", "route": "cuda",
         "source": src + "rebin.cu",
         "replaces": "none: the JAX package's rebinning is XLA's "
                     "(montecarloscattering_jl_tpu/ops/reduce.py "
                     "_ion_reduce_prog)",
         "launches": k1_paths("rebin") + f64_paths("rebin")
                     - mesh("rebin"),
         "max_abs_err": done["rebin"]["max_rel_err"],
         **{k: done["rebin"][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by")},
         "library_ms": None,
         "note": "every zone's plasma- and ISM-frame dN/dp of the CR and "
                 "thermal PSDs on the benchmark cell's shapes, one "
                 "launch; max_abs_err relative to each output's largest "
                 "entry; plain_ms: the per-zone torch loop on the card, "
                 "host clock; no single PyTorch call computes it"},
        {"name": "finish tally", "route": "cuda",
         "source": src + "finish.cu",
         "replaces": "none: the JAX package's escape tallies are XLA's "
                     "scatter-adds (montecarloscattering_jl_tpu/ops/"
                     "finish.py finish_particles)",
         "launches": k1_paths("finish") + f64_paths("finish")
                     - mesh("finish"),
         "max_abs_err": max(v["max_rel_err"]
                            for v in done["finish"].values()),
         **{k: done["finish"]["drained"][k] for k in ("ms", "bound_ms",
                                                      "bound_by")},
         "plain_ms": done["finish"]["drained"]["index_put_ms"],
         "one_cell": {k: done["finish"]["one cell"][k]
                      for k in ("ms", "index_put_ms", "bound_ms")},
         "library_ms": None,
         "note": "the four binned escape tallies of the finish with "
                 "the most upstream finishers in one iteration of the "
                 "nonrel cell (65,536 protons a pcut, K5), one call "
                 "(two kernels); max_abs_err relative to each cell "
                 "against index_put_, the twin's bits held exactly; "
                 "plain_ms: the four accumulating index_put_ on the card; "
                 "one_cell: the same lanes all in one cell"},
        {"name": "K4 = K2 psd_scatter", "route": "cuda",
         "source": src + "psd_hist.cu",
         "replaces": "scripts/probe_hist.py:173",
         "launches": k2_launches, **rec(k4), **eager(k4),
         "note": "runs K2's kernel at P4's 2^16 records"}]


if __name__ == "__main__":
    sys.exit(main())
