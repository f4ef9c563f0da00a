"""A run of a cell on the CPU at a small size, with the look for a card
skipped: the result line's keys, the numbers `correct` compares, the
controls (the plain reference at a lower precision in the program's
place) and the faults of the timed path that have to come out not
correct, and a configuration's own check (checks/<configuration>.py)
written for the tests.  The test marked ``cuda`` runs benchmark/run.py
itself where a card is present."""

import argparse
import importlib
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from harness import check, guard, lanes, main as hm, manifest

ROOT = os.path.dirname(manifest.HERE)
CELL = "nonrel_nonlinear.f64"


@pytest.fixture
def small(tmp_path, monkeypatch):
    """The cell at 64 particles injected and 128 a pcut (a batch twice
    the injected population), 1 iteration, a 200-step helix cap,
    writing under `tmp_path`."""
    from montecarloscattering_jl_tpu_torch.ops import mega
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    monkeypatch.setattr(mega, "MAX_HELIX_STEPS", 200)
    monkeypatch.setattr(xla_step, "MAX_HELIX_STEPS", 200)
    monkeypatch.setenv("MCS_MAX_HELIX_STEPS", "200")
    monkeypatch.setattr(hm, "WORK", str(tmp_path))
    cell = manifest.cell(manifest.load(), CELL)
    text = open(cell["toml"]).read()
    text = re.sub(r"^N_PTS_INJ = 65536$", "N_PTS_INJ = 64", text,
                  flags=re.M)
    text = re.sub(r"^(N_PTS_PCUT\w*) = 65536$", r"\1 = 128", text,
                  flags=re.M)
    text = re.sub(r"^num-iterations = 10$", "num-iterations = 2", text,
                  flags=re.M)
    cell["toml"] = str(tmp_path / "small.toml")
    with open(cell["toml"], "w") as f:
        f.write(text)
    return cell


def _run(cell, seed=2**31 + 77):
    args = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
    return hm.run_cell(cell, args, time.perf_counter(), "cpu")


def _limit(checked, name):
    return checked[name]["value"] > checked[name]["limit"]


def test_line_keys_and_checked_last(small):
    line, checked = _run(small)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checked"
    assert line["correct"] is True, checked
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "run_s", "pushes_per_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # a configuration without a check file: the shared numbers alone
    assert small["check"] is None
    assert set(checked) == set(check.LIMITS["float64"])
    assert check.cell_limits(small) == check.LIMITS["float64"]
    for k, v in checked.items():
        assert v["value"] <= v["limit"], k
    json.dumps(line)


OWN = '''"""A configuration's own check, for the tests: the last iteration's
CR dN/dp of the first species against the plain reference, the array
multiplied by FACTOR where it is read."""

import numpy as np
import torch

from harness import check

FACTOR = {factor!r}
LIMITS = {{"float64": {{"own.cr_gap": 1e-9}},
          "float32": {{"own.cr_gap": 1e-9}}}}


def read(result, out_dir, device, low=None):
    i = len(result.iterations) - 1
    want = check.reference_dndp(result, i, 0, torch.float64, device)[1]
    got = (result.iterations[i].ion_finals[0].dndp_cr if low is None
           else check.reference_dndp(result, i, 0, low, device)[1])
    return {{"own.cr_gap": check.gap(np.asarray(got) * FACTOR, want)}}
'''


def write_own(checks_dir, config, factor=1.0):
    """checks/<config>.py under `checks_dir`: OWN at `factor`."""
    os.makedirs(checks_dir, exist_ok=True)
    with open(os.path.join(checks_dir, config + ".py"), "w") as f:
        f.write(OWN.format(factor=factor))


def test_check_files_load_neither_the_port_nor_jax(tmp_path):
    """Every file under checks/, and the tests' own, loaded by name in a
    fresh interpreter: no module of the port or of JAX comes with it."""
    tmp = str(tmp_path / "checks")
    write_own(tmp, "tmp_config")
    files = [(tmp, "tmp_config")]
    if os.path.isdir(manifest.CHECKS):
        files += [(manifest.CHECKS, f[:-3]) for f in sorted(
            os.listdir(manifest.CHECKS)) if f.endswith(".py")]
    bad = guard.FORBIDDEN + ("montecarloscattering_jl_tpu_torch",)
    for where, stem in files:
        code = (
            "import sys\n"
            f"sys.path[:0] = [{manifest.HERE!r}, {ROOT!r}]\n"
            "from harness import manifest\n"
            f"manifest.CHECKS = {where!r}\n"
            f"mod = manifest.check_module({stem!r})\n"
            "assert callable(mod.read) and isinstance(mod.LIMITS, dict)\n"
            "print(sorted(n for n in sys.modules\n"
            f"             if n.split('.', 1)[0] in {bad!r}))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip() == "[]", (stem, out.stdout)


@pytest.fixture
def own(small, tmp_path, monkeypatch):
    """`small` with a check of its configuration's own, found by name
    under a checks directory in `tmp_path`; call it with the factor."""
    checks = str(tmp_path / "checks")
    monkeypatch.setattr(manifest, "CHECKS", checks)

    def make(factor):
        write_own(checks, small["config"]["name"], factor)
        cell = manifest.cell(manifest.load(), CELL)
        cell["toml"] = small["toml"]
        return cell
    return make


def test_own_check_sound(own):
    cell = own(1.0)
    assert cell["check"] is not None
    line, checked = _run(cell)
    assert line["correct"] is True, checked
    # the shared numbers first, the configuration's own after them
    assert list(checked)[-1] == "own.cr_gap"
    assert set(checked) == set(check.LIMITS["float64"]) | {"own.cr_gap"}
    assert checked["own.cr_gap"]["limit"] == 1e-9
    assert line["checked"] == checked


def test_own_check_fault(own):
    """The check's read doubles the array it is handed."""
    line, checked = _run(own(2.0))
    assert _limit(checked, "own.cr_gap")
    assert checked["own.cr_gap"]["value"] == pytest.approx(1.0)
    assert line["correct"] is False
    # the shared numbers still hold
    assert all(v["value"] <= v["limit"] for k, v in checked.items()
               if k != "own.cr_gap")


def test_own_check_control_fails(own):
    """The control reads the configuration's numbers too: the plain
    reference at float32 in the program's place fails its limit."""
    from montecarloscattering_jl_tpu_torch.engine import driver
    from montecarloscattering_jl_tpu_torch.utils import load_config

    cell = own(1.0)
    cfg = load_config(cell["toml"])
    capture = lanes.Capture(5)
    capture.start_run(0)
    capture.install()
    out = os.path.join(hm.WORK, "control")
    try:
        res = driver.run(cfg, device="cpu", out_dir=out,
                         p_dtype=torch.float64)
    finally:
        capture.remove()
    limits = check.cell_limits(cell)
    names = cell["check"].LIMITS["float64"]
    sound, _ = check.judge(capture, res, out, "cpu", 200, own=cell["check"],
                           own_names=names)
    low, _ = check.judge(capture, res, out, "cpu", 200, low=torch.float32,
                         own=cell["check"], own_names=names)
    assert list(sound) == list(low) and list(sound)[-1] == "own.cr_gap"
    assert check.verdict(sound, limits)[1], sound
    assert low["own.cr_gap"] > limits["own.cr_gap"], low


def test_own_check_no_run_reads_missing(own, monkeypatch):
    """No run of the window completes: every number, the configuration's
    own among them, reads MISSING."""
    from montecarloscattering_jl_tpu_torch.engine import driver

    base = driver.run

    def run(cfg, *a, **kw):
        if cfg.n_itrs > 1:
            raise RuntimeError("a run that fails")
        return base(cfg, *a, **kw)

    monkeypatch.setattr(driver, "run", run)
    line, checked = _run(own(1.0))
    assert line["correct"] is False and line["failed"] == 1
    assert set(checked) == set(check.LIMITS["float64"]) | {"own.cr_gap"}
    assert {v["value"] for v in checked.values()} == {check.MISSING}


def test_own_check_number_not_read(own):
    """A number LIMITS declares that read does not return reads
    MISSING."""
    cell = own(1.0)
    cell["check"].read = lambda *a, **kw: {}
    line, checked = _run(cell)
    assert checked["own.cr_gap"]["value"] == check.MISSING
    assert line["correct"] is False


@pytest.mark.parametrize("p_dtype,lows", [
    ("float64", ("float32",)), ("float32", ("bfloat16",))])
def test_controls_fail(small, p_dtype, lows):
    from montecarloscattering_jl_tpu_torch.engine import driver
    from montecarloscattering_jl_tpu_torch.utils import load_config

    seed = 2**31 + 77
    cfg = load_config(small["toml"])
    cfg.random_seed = hm.run_seed(seed, 0)
    capture = lanes.Capture(seed)
    capture.start_run(0)
    capture.install()
    out = os.path.join(hm.WORK, "control")
    try:
        res = driver.run(cfg, device="cpu", out_dir=out,
                         p_dtype=getattr(torch, p_dtype))
    finally:
        capture.remove()
    limits = check.LIMITS[p_dtype]
    sound, seen = check.judge(capture, res, out, "cpu", 200)
    assert seen["lanes"] > 0 and capture.split is not None
    assert check.verdict(sound, limits)[1], sound
    for name in lows:
        got, _ = check.judge(capture, res, out, "cpu", 200,
                             low=getattr(torch, name))
        assert not check.verdict(got, limits)[1], (name, got)
        for k in ("lanes_diverged", "dndp_gap", "smooth_gap"):
            assert got[k] > limits[k], (name, k, got)


def _finish_scaled(driver, factor):
    base = driver.ion_finalize_start

    def start(*a, **kw):
        finish = base(*a, **kw)

        def altered():
            fin = finish()
            fin.dndp_cr = fin.dndp_cr * factor
            return fin
        return altered
    return start


def test_fault_answer_altered_where_produced(small, monkeypatch):
    from montecarloscattering_jl_tpu_torch.engine import driver

    monkeypatch.setattr(driver, "ion_finalize_start",
                        _finish_scaled(driver, 1.0 + 1e-6))
    line, checked = _run(small)
    assert _limit(checked, "dndp_gap")
    assert line["correct"] is False


def test_fault_file_altered_where_written(small, monkeypatch):
    from montecarloscattering_jl_tpu_torch.engine import io

    base = io.write_dndp

    def write_dndp(result, out_dir):
        for itr in result.iterations:
            for fi in itr.ion_finals:
                fi.dndp_cr = fi.dndp_cr * 1.01
        base(result, out_dir)
        for itr in result.iterations:
            for fi in itr.ion_finals:
                fi.dndp_cr = fi.dndp_cr / 1.01

    monkeypatch.setattr(io, "write_dndp", write_dndp)
    line, checked = _run(small)
    assert _limit(checked, "file_gap")
    assert line["correct"] is False


def test_fault_step_returns_state_unchanged(small, monkeypatch):
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    monkeypatch.setattr(xla_step, "run_segment", lambda *a, **kw: None)
    line, checked = _run(small)
    assert checked["idle_species"]["value"] > 0
    assert _limit(checked, "lanes_diverged")
    assert _limit(checked, "psd_gap")
    assert line["correct"] is False


def test_fault_back_half_of_the_batch_left_out(small, monkeypatch):
    """The drain pushes the front half of the batch only, the weights of
    those lanes doubled for it (the mean taken over the rest): the
    batch is 2x the injected population, so the back half holds the
    split's lanes."""
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    base = xla_step.run_segment

    def run_segment(st, *a, **kw):
        half = st.weight.shape[0] // 2
        assert half >= 64
        status = st.status[half:].clone()
        st.status[half:] = 2
        st.weight[:half] *= 2.0
        out = base(st, *a, **kw)
        st.weight[:half] /= 2.0
        st.status[half:] = status
        return out

    monkeypatch.setattr(xla_step, "run_segment", run_segment)
    line, checked = _run(small)
    assert _limit(checked, "lanes_diverged")
    assert _limit(checked, "psd_gap")
    assert line["correct"] is False


def test_fault_lanes_altered_where_pushed(small, monkeypatch):
    from montecarloscattering_jl_tpu_torch.ops import step as xla_step

    base = xla_step.run_segment

    def run_segment(st, *a, **kw):
        out = base(st, *a, **kw)
        st.pb.mul_(1.0 + 1e-9)
        return out

    monkeypatch.setattr(xla_step, "run_segment", run_segment)
    line, checked = _run(small)
    assert _limit(checked, "lanes_diverged")
    assert line["correct"] is False


def test_fault_deposit_altered(small, monkeypatch):
    """The PSD deposit 1% off where the step makes it: the lanes are
    sound, the tallies are not."""
    from montecarloscattering_jl_tpu_torch.ops import hist

    base = hist.psd_scatter
    monkeypatch.setattr(hist, "psd_scatter",
                        lambda psd, cell, lo, hi, w: base(psd, cell, lo, hi,
                                                          w * 1.01))
    line, checked = _run(small)
    assert checked["lanes_diverged"]["value"] == 0.0
    assert _limit(checked, "psd_gap")
    assert line["correct"] is False


def test_fault_smoothing_altered(small, monkeypatch):
    from montecarloscattering_jl_tpu_torch.engine import driver

    base = driver.smooth_grid

    def smooth_grid(*a, **kw):
        prof, diag, w = base(*a, **kw)
        prof = prof.copy()
        prof.ux_sk = prof.ux_sk * (1.0 + 1e-6)
        return prof, diag, w

    monkeypatch.setattr(driver, "smooth_grid", smooth_grid)
    line, checked = _run(small)
    assert _limit(checked, "smooth_gap")
    assert line["correct"] is False


def test_fault_split_altered(small, monkeypatch):
    """The split's new lanes keep their parents' weight."""
    erun = importlib.import_module(
        "montecarloscattering_jl_tpu_torch.engine.run")
    base = erun.split_on_device

    def split_on_device(state, n_target, key, *a, **kw):
        new, n_new = base(state, n_target, key, *a, **kw)
        new.weight.mul_(torch.clamp(n_target // torch.clamp(
            (state.status == 1).sum(), min=1), min=1).to(new.weight.dtype))
        return new, n_new

    monkeypatch.setattr(erun, "split_on_device", split_on_device)
    line, checked = _run(small)
    assert _limit(checked, "split_off")
    assert line["correct"] is False


def test_fault_pushes_miscounted(small, monkeypatch):
    """The engine counts one push too many a species."""
    erun = importlib.import_module(
        "montecarloscattering_jl_tpu_torch.engine.run")
    engine = next(v for v in vars(erun).values()
                  if isinstance(v, type) and hasattr(v, "run_ion"))
    base = engine.run_ion

    def run_ion(self, *a, **kw):
        out = base(self, *a, **kw)
        self.n_pushes_total += 1
        return out

    monkeypatch.setattr(engine, "run_ion", run_ion)
    line, checked = _run(small)
    assert _limit(checked, "pushes_gap")
    assert line["correct"] is False


def test_fault_exits_counted_twice(small, monkeypatch):
    erun = importlib.import_module(
        "montecarloscattering_jl_tpu_torch.engine.run")
    base = erun._count_exits

    def count_exits(*a, **kw):
        base(*a, **kw)
        base(*a, **kw)

    monkeypatch.setattr(erun, "_count_exits", count_exits)
    line, checked = _run(small)
    assert _limit(checked, "exits_gap")
    assert line["correct"] is False


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu"
