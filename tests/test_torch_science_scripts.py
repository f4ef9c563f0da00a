"""The port's science scripts (montecarloscattering_jl_tpu_torch/scripts/
flagship_{keshet_waxman,kw_sweep,baseline,endurance}.py), each shrunk,
on the CPU through K1's plain version (float32), and the CLI's
--compact-levels and --no-fused.

* Keshet-Waxman at 64 particles a pcut and a 200-step helix cap: the
  script prints the JAX script's lines, the fitted-index line parses as
  the sweep parses it, and the gate line reads PASSED or FAILED (at this
  size the chain ends early and the fit says nothing of the physics).
* The sweep: its fit reproduces the JAX package's s_inf from the points
  of kw_sweep.json; a point is parsed from the KW script's printed
  lines; it refuses to write over the repo root's kw_sweep.json.
* Endurance for two blocks at 64 a pcut: the block lines and the
  drift and rate verdicts.
* The baseline dashboard on configs/baseline.toml shrunk as
  tests/test_torch_baseline.py shrinks it (the science switches, 1
  iteration, 64 particles a pcut, a coarser PSD, a 100-step cap).
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from montecarloscattering_jl_tpu_torch.scripts import (
    flagship_baseline as fb, flagship_endurance as fe,
    flagship_keshet_waxman as kw, flagship_kw_sweep as sweep,
    workloads as wl)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
SHRINK = (
    ("N_PTS_INJ = 100", f"N_PTS_INJ = {N}"),
    ("N_PTS_PCUT = 400", f"N_PTS_PCUT = {N}"),
    ("N_PTS_PCUT_HI = 2000", f"N_PTS_PCUT_HI = {N}"),
    ("num-psd-bins-per-decade = [10, 10]",
     "num-psd-bins-per-decade = [5, 5]"),
    ("psd-linear-cosine-bins = 119", "psd-linear-cosine-bins = 29"),
    ("psd-log-theta-decs = 4", "psd-log-theta-decs = 2"),
)


@pytest.fixture(scope="module")
def one_thread():
    n_thr = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_thr)


@pytest.fixture(scope="module")
def kw_lines(one_thread):
    with pytest.MonkeyPatch.context() as mp:
        lines = []
        mp.setattr("builtins.print",
                   lambda *a, **k: lines.append(" ".join(map(str, a))))
        rc = kw.main(["--per-pcut", str(N), "--cap", "200", "--device",
                      "cpu"])
    return rc, lines


def test_kw_prints_the_jax_scripts_lines(kw_lines):
    rc, lines = kw_lines
    assert lines[0].startswith("gamma0=5.00 beta0=0.9798")
    assert "s_KW=" in lines[0] and "(dN/dp slope" in lines[0]
    assert lines[1].startswith("wall=") and "pushes=" in lines[1]
    assert lines[2].startswith("fitted dN/dp slope = ")
    assert lines[-1] in ("KESHET-WAXMAN VALIDATION PASSED",
                         "KESHET-WAXMAN VALIDATION FAILED")
    assert rc == (0 if lines[-1].endswith("PASSED") else 1)


def test_kw_lines_parse_as_the_sweep_parses_them(kw_lines, monkeypatch):
    _, lines = kw_lines
    done = subprocess.CompletedProcess([], 0, stdout="\n".join(lines),
                                       stderr="")
    seen = []

    def fake_run(cmd, **kw_):
        seen.append((cmd, kw_))
        return done

    monkeypatch.setattr(subprocess, "run", fake_run)
    point = sweep.run_point(4000.0, N, 100_000, 2400.0, False, "cpu")
    s_kw = float(lines[0].split("s_KW=")[1].split()[0])
    assert point["s_kw"] == pytest.approx(s_kw, abs=1e-3)
    assert point["pushes"] == int(lines[1].split("pushes=")[1].split()[0])
    assert point["pushes"] > 0
    cmd, opts = seen[0]
    assert cmd[1:3] == ["-m", "montecarloscattering_jl_tpu_torch.scripts."
                               "flagship_keshet_waxman"]
    assert "--device" in cmd and opts["cwd"] == wl.ROOT


def test_sweep_fit_reproduces_the_jax_extrapolation():
    """The JAX package's sweep (kw_sweep.json, a TPU run) refitted by the
    port's fit_sweep gives its s_inf and rms for both models."""
    with open(os.path.join(ROOT, "kw_sweep.json")) as f:
        ref = json.load(f)
    fits = sweep.fit_sweep(ref["points"])
    for name in ("invsqrt", "inv"):
        for k in ("s_inf", "slope", "rms"):
            assert fits[name][k] == pytest.approx(ref["fits"][name][k],
                                                  rel=1e-9, abs=1e-9)


def test_sweep_refuses_the_reference_artifact():
    with pytest.raises(SystemExit, match="JAX package"):
        sweep.main(["-o", os.path.join(ROOT, "kw_sweep.json")])


def test_endurance_two_blocks(one_thread, capsys):
    with wl.helix_cap(100):
        one = fe.endurance(1, per_pcut=N, device="cpu")
        per_block = one["blocks"][0]["trajs"]
        capsys.readouterr()
        two = fe.endurance(per_block + 1, per_pcut=N, device="cpu")
    out = capsys.readouterr().out
    assert len(two["blocks"]) == 2
    assert two["blocks"][0]["trajs"] == per_block     # the same block 1
    for b in two["blocks"]:
        assert b["trajs"] > 0 and b["pushes"] > 0
        for k in ("wall_s", "mpushes_per_s", "hbm_in_use_mb",
                  "hbm_peak_mb", "hbm_reserved_mb", "total_trajs"):
            assert k in b
        assert json.dumps(b) in out
    assert "HBM drift (block 2 -> last): +0.00% (PASS < 1%)" in out
    assert "rate floor vs median:" in out
    assert two["drift_ok"]


def test_baseline_dashboard(one_thread, tmp_path, monkeypatch, capsys):
    text = open(wl.BASELINE).read()
    for old, new in SHRINK:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / "baseline.toml"
    path.write_text(text)
    monkeypatch.setattr(wl, "BASELINE", str(path))
    out_dir = tmp_path / "out"
    rc = fb.main(["--dsa", "--pcuts-per-decade", "4", "--iters", "1",
                  "--max-helix-steps", "100", "-o", str(out_dir),
                  "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("wall=") and "iterations=1 species=2" \
        in lines[0]
    assert "trajs/s" in lines[1] and "M pushes/s" in lines[1]
    assert lines[2].startswith("r_comp=") and "Gamma2_RH=" in lines[2]
    assert lines[3].startswith("iter  1: Gamma_dw=")
    assert "pxx_norm_max=" in lines[3]
    assert lines[4].startswith("timers: ")
    for name in ("mc_out.dat", "mc_grid.dat", "mc_coupled_weights.csv",
                 "mc_coupled_spectra.csv"):
        line = next(ln for ln in lines if ln.startswith(name + ":"))
        assert line.endswith("bytes"), line
    # the helix cap came back
    from montecarloscattering_jl_tpu_torch.ops import mega
    assert mega.MAX_HELIX_STEPS != 100


def test_baseline_config_switches():
    shipped = fb.baseline_config()
    sci = fb.baseline_config(dsa=True, pcuts_per_decade=4, iters=1,
                             n_pts_mult=4)
    assert shipped.dont_scatter and shipped.dont_dsa
    assert not (sci.dont_scatter or sci.dont_dsa) and sci.do_smoothing
    assert sci.n_itrs == 1
    assert sci.n_pts_pcut == 4 * shipped.n_pts_pcut
    ref = wl.load_variant(wl.BASELINE)
    wl.science_variant(ref)
    assert np.array_equal(ref.pcuts, sci.pcuts)


def test_cli_flags_reach_the_engine(monkeypatch, tmp_path):
    """--no-fused and --compact-levels, with the JAX CLI's meaning, reach
    TransportEngine through driver.run."""
    from montecarloscattering_jl_tpu_torch import __main__ as cli
    from montecarloscattering_jl_tpu_torch.engine import driver

    seen = []
    real = driver.TransportEngine

    def spy(*a, **kw):
        eng = real(*a, **kw)
        seen.append((eng.fused, eng.compact_levels))
        raise SystemExit(0)

    monkeypatch.setattr(driver, "TransportEngine", spy)
    base = ["tests/data/dsa_nonrel.toml", "-o", str(tmp_path), "--device", "cpu"]
    for extra, want in (([], (True, 0)),
                        (["--no-fused", "--compact-levels", "0"],
                         (False, 0)),
                        (["--compact-levels", "3"], (True, 3))):
        with pytest.raises(SystemExit):
            cli.main(base + extra)
        assert seen[-1] == want, extra
    # the config's batch (384 lanes) is below the auto rule's floor, so
    # auto is 0 there
    assert seen[0][1] == 0




def test_new_modules_import_no_jax():
    """The scripts and the host splitter import neither JAX nor the JAX
    package (a fresh interpreter)."""
    import sys

    code = (
        "import sys\n"
        "from montecarloscattering_jl_tpu_torch.ops import cuts, step\n"
        "from montecarloscattering_jl_tpu_torch.scripts import (\n"
        "    flagship_baseline, flagship_endurance,\n"
        "    flagship_keshet_waxman, flagship_kw_sweep)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'montecarloscattering_jl_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
