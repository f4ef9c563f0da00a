"""The cell electron_synch_ic.f64 and its configuration's own check
(checks/electron_synch_ic.py, the plain photon reference) on the CPU at
a small size: the files resolve, the check loads nothing of the port or
of JAX, a sound run reads `correct`, the float32 control and planted
faults in the photons read not correct, and the nonrel_nonlinear cells
keep their numbers and limits."""

import argparse
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harness import check, guard, lanes, main as hm, manifest

ROOT = os.path.dirname(manifest.HERE)
CELL = "electron_synch_ic.f64"
OWN = ("synch_gap", "ic_gap", "pion_gap", "photon_tot_gap", "d2n_gap",
       "photon_file_gap")
SEED = 2**31 + 2**30 + 17


def test_cell_resolves_with_its_check():
    man = manifest.load()
    assert manifest.problems(man) == []
    cell = manifest.cell(man, CELL)
    assert cell["traffic"]["p_dtype"] == "float64"
    assert cell["workload"]["chips"] == 1
    own = cell["check"]
    assert own is not None and tuple(own.LIMITS["float64"]) == OWN
    assert check.cell_limits(cell) == {**check.LIMITS["float64"],
                                       **own.LIMITS["float64"]}
    assert [m["name"] for m in cell["end_to_end"]] == [
        "setup_s", "run_s", "pushes_per_s"]
    assert [m["name"] for m in cell["per_layer"]] == [
        "driver.host_s", "ladder.transport_s", "ladder.host_waits",
        "device.idle_pct", "emission.host_s", "emission.device_s",
        "electrons.transport_s"]
    with open(cell["toml"]) as f:
        text = f.read()
    for k in cell["meta"]["reduced"]:
        assert re.search(rf"^{k} = 65536$", text, re.M), k


def test_nonrel_cells_keep_their_numbers():
    man = manifest.load()
    for name, p in (("nonrel_nonlinear.f64", "float64"),
                    ("nonrel_nonlinear.f32", "float32")):
        cell = manifest.cell(man, name)
        assert cell["check"] is None
        assert check.cell_limits(cell) == check.LIMITS[p]


def test_check_file_loads_neither_the_port_nor_jax(tmp_path):
    bad = guard.FORBIDDEN + ("montecarloscattering_jl_tpu_torch",)
    code = (
        "import sys\n"
        f"sys.path[:0] = [{manifest.HERE!r}, {ROOT!r}]\n"
        "from harness import manifest\n"
        "mod = manifest.check_module('electron_synch_ic')\n"
        "assert callable(mod.read) and mod.LIMITS['float64']\n"
        "print(sorted(n for n in sys.modules\n"
        f"             if n.split('.', 1)[0] in {bad!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout


@pytest.fixture
def small(tmp_path, monkeypatch):
    """The cell at 64 particles injected and 128 a pcut, a 200-step helix
    cap, writing under `tmp_path`."""
    from montecarloscattering_jl_tpu_torch.ops import mega
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    monkeypatch.setattr(mega, "MAX_HELIX_STEPS", 200)
    monkeypatch.setattr(xla_step, "MAX_HELIX_STEPS", 200)
    monkeypatch.setenv("MCS_MAX_HELIX_STEPS", "200")
    monkeypatch.setattr(hm, "WORK", str(tmp_path))
    cell = manifest.cell(manifest.load(), CELL)
    text = open(cell["toml"]).read()
    text = re.sub(r"^N_PTS_INJ = 65536$", "N_PTS_INJ = 64", text, flags=re.M)
    text = re.sub(r"^(N_PTS_PCUT\w*) = 65536$", r"\1 = 128", text,
                  flags=re.M)
    cell["toml"] = str(tmp_path / "small.toml")
    with open(cell["toml"], "w") as f:
        f.write(text)
    return cell


def _run(cell, seed=SEED):
    args = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
    return hm.run_cell(cell, args, time.perf_counter(), "cpu")


def _over(checked, names):
    return [k for k in names if checked[k]["value"] > checked[k]["limit"]]


@pytest.fixture
def judged(small):
    """One run of the small cell, its capture and its numbers, sound and
    at float32."""
    from montecarloscattering_jl_tpu_torch.engine import driver
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cfg = load_config(small["toml"])
    cfg.random_seed = hm.run_seed(SEED, 0)
    capture = lanes.Capture(SEED)
    capture.start_run(0)
    capture.install()
    out = os.path.join(hm.WORK, "control")
    try:
        res = driver.run(cfg, device="cpu", out_dir=out,
                         p_dtype=torch.float64)
    finally:
        capture.remove()
    own = small["check"]
    judge = lambda low=None: check.judge(
        capture, res, out, "cpu", 200, low=low, own=own, own_names=OWN)[0]
    return small, res, out, judge


def test_sound_and_control(judged):
    cell, res, out, judge = judged
    limits = check.cell_limits(cell)
    sound = judge()
    assert list(sound)[-len(OWN):] == list(OWN)
    assert check.verdict(sound, limits)[1], sound
    for k in OWN[:-1]:
        assert sound[k] < 1e-12, (k, sound)
    # both species pushed, the electrons' 2-D PSD judged
    pushes = [fi.n_pushes for fi in res.iterations[-1].ion_finals]
    assert len(pushes) == 2 and all(p > 0 for p in pushes)
    assert res.iterations[-1].ion_finals[-1].d2n_ef is not None
    low = judge(torch.float32)
    assert not check.verdict(low, limits)[1], low
    assert _over({k: {"value": low[k], "limit": limits[k]} for k in OWN},
                 OWN), low


def test_fault_pion_dropped(small, monkeypatch):
    """The program's pi0 spectra dropped where they are made (every bin
    at the floor): the check's pion and total numbers read it."""
    from montecarloscattering_jl_tpu_torch.models.emission import device

    base = device.pion_grid_device
    monkeypatch.setattr(device, "pion_grid_device",
                        lambda *a, **kw: torch.full_like(base(*a, **kw),
                                                         1e-99))
    line, checked = _run(small)
    assert line["correct"] is False
    assert {"pion_gap", "photon_tot_gap", "photon_file_gap"} <= set(
        _over(checked, OWN))
    assert checked["pion_gap"]["value"] == pytest.approx(1.0)
    assert not _over(checked, check.LIMITS["float64"])


def test_fault_synch_doubled_in_one_zone(small, monkeypatch):
    """The program's synchrotron spectrum of one emitting zone doubled
    where it is made: the whole run, its files and line, read not
    correct on the check's own numbers while the shared ones hold."""
    from montecarloscattering_jl_tpu_torch.models.emission import device

    base = device.synch_grid_device

    def synch(*a, **kw):
        out = base(*a, **kw)
        k = int(torch.argmax(out.max(dim=0).values))
        out[:, k] *= 2.0
        return out

    monkeypatch.setattr(device, "synch_grid_device", synch)
    line, checked = _run(small)
    assert line["correct"] is False
    assert {"synch_gap", "photon_tot_gap", "photon_file_gap"} <= set(
        _over(checked, OWN))
    assert not _over(checked, check.LIMITS["float64"])


def test_fault_d2n_doubled_in_one_zone(small, monkeypatch):
    """The electrons' ISM-frame d2N doubled in its fullest zone where the
    driver normalizes it: the check's d2N number reads it, while the IC
    spectra, made from that same d2N, and the shared numbers hold."""
    from montecarloscattering_jl_tpu_torch.ops import reduce as red

    base = red.ef_zone_norm

    def norm(psd, therm, *a, **kw):
        out = base(psd, therm, *a, **kw)
        total = np.asarray(psd, np.float64) + np.asarray(therm, np.float64)
        k = int(np.argmax(total.sum(axis=(0, 1))))
        out = np.array(out, np.float64)
        out[k] *= 2.0
        return out

    monkeypatch.setattr(red, "ef_zone_norm", norm)
    line, checked = _run(small)
    assert line["correct"] is False
    assert _over(checked, OWN) == ["d2n_gap"]
    assert not _over(checked, check.LIMITS["float64"])
