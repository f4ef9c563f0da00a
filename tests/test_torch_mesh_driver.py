"""The port's mesh through its entry points, on the CPU, and the mesh
helpers in this process.

* ``driver.run(..., mesh=...)`` at world 2 (ranks started by
  ``parallel.multihost.spawn``, gloo; tests/torch_mesh_cases.py): rank 0
  writes the output files and the iteration checkpoint, rank 1 nothing;
  both ranks smooth the same profile, bit for bit; iteration 1 has the
  single-process counts (the host split); an iteration checkpoint
  written at world 2 resumes at world 1 with the counts world 2 gets
  from it; a segment-boundary checkpoint written at world 2 (its batch
  of 256 lanes) resumes at world 1 (128) with the single process's
  counts.
* A rank that raises ends every rank, and the caller gets its error.
* The CLI's --devices, --coordinator, --num-processes and --process-id
  parse; ``--devices 2`` runs two CPU ranks; on ``cuda`` without cards
  it raises.  scripts/pod_scale.py at world 2 on the CPU, in a
  subprocess with a time limit.
* In this process: ``pad_to_devices`` on the JAX package's cases and
  against its function, the per-rank split targets summing to the
  target for W = 1..8, the hybrid split's keys disjoint across ranks and
  equal to the whole batch's, ``make_mesh`` refusing a world it does not
  have, and ``_fit_lanes``.

tests/test_parallel.py's small config (48 injected, 64 a pcut, 3 pcuts)
at a helix cap of 128, float64 (the XLA engine).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarloscattering_jl_tpu.parallel import (
    pad_to_devices as jpad_to_devices)
from montecarloscattering_jl_tpu_torch.__main__ import main as cli_main
from montecarloscattering_jl_tpu_torch.__main__ import parser as cli_parser
from montecarloscattering_jl_tpu_torch.engine.driver import run
from montecarloscattering_jl_tpu_torch.engine.run import _fit_lanes
from montecarloscattering_jl_tpu_torch.ops import rng
from montecarloscattering_jl_tpu_torch.ops import state as stt
from montecarloscattering_jl_tpu_torch.ops.split import split_on_device
from montecarloscattering_jl_tpu_torch.parallel import multihost, shard
from montecarloscattering_jl_tpu_torch.scripts import workloads as wl

import torch_mesh_cases as mc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    return d, multihost.spawn(mc.driver_case, 2, args=(d,), device="cpu",
                              timeout=TIMEOUT)


@pytest.fixture(scope="module")
def world1():
    """The single-process host split, 1 iteration."""
    torch.set_num_threads(1)
    with wl.helix_cap(mc.CAP):
        return run(mc.small_cfg(n_itrs=1), "cpu", fused=False)


def test_rank_0_writes_the_files_rank_1_none(world2):
    _, (r0, r1) = world2
    want = {"mc_out.dat", "mc_grid.dat", "mc_profile.json"}
    assert want <= set(r0["files"])
    assert r0["ck_written"]
    assert r1["files"] == [] and not r1["ck_written"]
    assert not (r0["jax_loaded"] or r1["jax_loaded"])


def test_ranks_smooth_the_same_profile(world2):
    _, (r0, r1) = world2
    for k, a in r0["profile"].items():
        np.testing.assert_array_equal(r1["profile"][k], a, err_msg=k)


def test_world_2_counts_are_the_single_process(world2, world1):
    _, ranks = world2
    for r in ranks:
        assert (r["pushes"], r["trajectories"]) == (world1.n_pushes,
                                                    world1.n_trajectories)
        assert r["mesh"]["size"] == 2 and r["mesh"]["backend"] == "gloo"


def test_iteration_checkpoint_resumes_at_world_1(world2):
    d, (r0, r1) = world2
    assert r0["resumed"] == r1["resumed"]
    with wl.helix_cap(mc.CAP):
        res = run(mc.small_cfg(n_itrs=2), "cpu", fused=False,
                  resume=os.path.join(d, "ck0.npz"))
    assert len(res.iterations) == 1
    assert (res.n_pushes, res.n_trajectories) == r0["resumed"]


def test_mid_checkpoint_resumes_at_world_1(world2, world1):
    """The host split's mid checkpoint holds the whole batch and the
    summed accumulators: rank 0 wrote it, every rank stopped."""
    d, ranks = world2
    assert all(r["killed"] for r in ranks)
    path = os.path.join(d, "kill.npz.mid")
    with wl.helix_cap(mc.CAP):
        res = run(mc.small_cfg(n_itrs=1), "cpu", fused=False, resume=path)
    assert (res.n_pushes, res.n_trajectories) == (world1.n_pushes,
                                                  world1.n_trajectories)
    a, b = world1.iterations[0], res.iterations[0]
    np.testing.assert_array_equal(b.ion_finals[0].reason_counts[1:],
                                  a.ion_finals[0].reason_counts[1:])
    np.testing.assert_allclose(b.tallies.pxx_flux, a.tallies.pxx_flux,
                               rtol=1e-12)
    psd = a.ion_finals[0].psd
    np.testing.assert_allclose(b.ion_finals[0].psd, psd, rtol=1e-6,
                               atol=1e-6 * psd.max())


def test_mid_checkpoint_refuses_the_mesh_hybrid_ladder(world2):
    """A resume into the ladder that splits each rank's lanes raises."""
    from montecarloscattering_jl_tpu_torch.engine.run import TransportEngine
    from montecarloscattering_jl_tpu_torch.engine.setup import build_setup
    from montecarloscattering_jl_tpu_torch.parallel import checkpoint as ck

    d, _ = world2
    payload = ck.load_mid_checkpoint(os.path.join(d, "kill.npz.mid"))
    eng = TransportEngine(build_setup(mc.small_cfg()), "cpu",
                          p_dtype=torch.float32,
                          mesh=shard.Mesh(2, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="mesh hybrid"):
        eng.run_ion(0, 0, payload["driver"]["profile"], payload["it"],
                    resume_mid=payload)


def test_cli_parses_the_distributed_flags():
    args = cli_parser().parse_args(
        ["c.toml", "--devices", "4", "--coordinator", "host:1234",
         "--num-processes", "8", "--process-id", "3"])
    assert (args.devices, args.coordinator, args.num_processes,
            args.process_id) == (4, "host:1234", 8, 3)
    assert cli_parser().parse_args([]).devices == 0


def test_cli_devices_on_cuda_without_cards_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible (tests/test_torch_cuda.py)")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main([mc.CFG, "-o", str(tmp_path), "--devices", "2"])


def test_cli_devices_2_on_the_cpu(tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "small.toml"
    text = open(mc.CFG).read()
    for old, new in (("N_PTS_INJ = 200", "N_PTS_INJ = 48"),
                     ("N_PTS_PCUT = 200", "N_PTS_PCUT = 64"),
                     ("N_PTS_PCUT_HI = 200", "N_PTS_PCUT_HI = 64"),
                     ("[0.02, 0.04, 0.08, 0.15, 0.3, 0.6]",
                      "[0.02, 0.04, 0.08]")):
        assert old in text
        text = text.replace(old, new)
    cfg.write_text(text)
    # the ranks read the helix cap at import
    monkeypatch.setenv("MCS_MAX_HELIX_STEPS", str(mc.CAP))
    out = tmp_path / "out"
    assert cli_main([str(cfg), "-o", str(out), "--device", "cpu",
                     "--devices", "2"]) == 0
    said = capsys.readouterr().out
    assert "on 2 ranks (gloo)" in said
    assert "mc_out.dat" in os.listdir(out)


def test_pod_scale_at_world_2_on_the_cpu():
    # one torch thread a rank: the ranks' plain step is ~300 small ops a
    # step, and the test's workers share the cores
    env = dict(os.environ, MCS_MAX_HELIX_STEPS=str(mc.CAP),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m",
         "montecarloscattering_jl_tpu_torch.scripts.pod_scale",
         "--device", "cpu", "--devices", "2", "--per-chip", "32"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "devices: 2 x cpu (gloo)"
    assert "trajectories" in lines[1] and "M/s/chip" in lines[1]
    assert lines[2].startswith("escaping / far-upstream energy flux")


def test_a_failing_rank_ends_every_rank():
    """The launcher ends the rank left waiting in a collective and
    raises with the failing rank's error, long before any time limit."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        multihost.spawn(mc.fail_on_rank_1, 2, device="cpu",
                        timeout=TIMEOUT)
    assert time.monotonic() - t0 < 60


# ---- in this process ----------------------------------------------------


def test_pad_to_devices():
    assert shard.pad_to_devices(1, 8, 32) == 256
    assert shard.pad_to_devices(1000, 8, 128) == 1024
    for n in (1, 127, 128, 129, 1000, 69_632, 70_000):
        for w in (1, 2, 3, 8):
            assert shard.pad_to_devices(n, w) == jpad_to_devices(n, w)


def test_shard_targets_spread_the_remainder():
    for size in range(1, 9):
        for n in (0, 7, 400, 401, 2000, 65_536):
            parts = [shard.shard_target(n, size, r) for r in range(size)]
            assert sum(parts) == n
            assert max(parts) - min(parts) <= 1


def test_hybrid_keys_are_global_and_disjoint():
    """Each rank's split keys its lane j as fold_in(seg_key, r * b + j):
    the ranks' keys are the whole batch's, none shared."""
    b, world = 256, 2
    with wl.helix_cap(mc.CAP):
        from montecarloscattering_jl_tpu_torch.engine.setup import (
            build_setup)
        setup = build_setup(mc.small_cfg())
        st = wl.flagship_population(setup, mc.small_cfg(), "cpu", lanes=b)
    st.status = torch.full((b,), stt.SAVED, dtype=torch.int32)
    seg_key = rng.key(5)
    keys = []
    for r in range(world):
        sub = shard.shard_state(st, shard.Mesh(world, r,
                                               torch.device("cpu")))
        new, n_new = split_on_device(sub, b // world, seg_key,
                                     lane_offset=r * (b // world))
        assert n_new == b // world
        keys.append(torch.stack([new.key0, new.key1], 1))
    k0, k1 = rng.fold_in_lanes(seg_key, b, "cpu")
    whole = torch.stack([k0, k1], 1)
    assert torch.equal(torch.cat(keys), whole)
    assert len({tuple(k) for k in whole.tolist()}) == b


def test_make_mesh_refuses_a_world_it_does_not_have():
    assert shard.make_mesh(device="cpu").size == 1
    assert shard.make_mesh(1, "cpu").rank == 0
    with pytest.raises(RuntimeError, match="2-rank mesh"):
        shard.make_mesh(2, "cpu")


def test_make_mesh_on_cuda_without_cards_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible (tests/test_torch_cuda.py)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.make_mesh(2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.local_ranks(2, "cuda")


def test_fit_lanes():
    with wl.helix_cap(mc.CAP):
        from montecarloscattering_jl_tpu_torch.engine.setup import (
            build_setup)
        setup = build_setup(mc.small_cfg())
        st = wl.flagship_population(setup, mc.small_cfg(), "cpu", lanes=8)
    st.weight[5:] = 0
    st.status[5:] = stt.FINISHED
    up = _fit_lanes(st, 12)
    assert up.weight.shape == (12,) and not up.weight[8:].any()
    assert (up.status[8:] == stt.FINISHED).all()
    down = _fit_lanes(up, 5)
    for k, v in vars(down).items():
        assert torch.equal(v, getattr(st, k)[:5]), k
    with pytest.raises(ValueError, match="beyond"):
        _fit_lanes(st, 4)
