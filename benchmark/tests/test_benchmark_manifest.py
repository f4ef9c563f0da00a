"""BENCHMARK.json and the files it names."""

import json
import os

import pytest

from harness import manifest

MAN = manifest.load()


def test_manifest_has_no_problems():
    assert manifest.problems(MAN) == []


def test_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(MAN)) < 64 * 1024
    for w in MAN["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in MAN["configs"]:
        assert len(c["source"]) <= 200
        assert len(c["reduced"]) <= 16


def test_names_and_units():
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[k]:
            assert manifest.NAME.match(e["name"]), e["name"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
    assert not manifest.NAME.match("bad name")
    assert not manifest.NAME.match("a/b")
    assert not manifest.UNIT.match("tokens per second")


def test_moves_names_a_reported_end_to_end_metric():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert manifest.reports(e2e[m["moves"]], w)


def test_problems_catches_a_bad_moves_and_a_missing_reader():
    bad = json.loads(json.dumps(MAN))
    bad["per_layer"][0]["moves"] = "tokens_per_s"
    bad["per_layer"].append(dict(bad["per_layer"][1], name="no.reader"))
    got = manifest.problems(bad)
    assert any("not an end-to-end metric" in p for p in got)
    assert any("no.reader: no reader file" in p for p in got)


def test_problems_catches_a_missing_or_extra_key():
    bad = json.loads(json.dumps(MAN))
    del bad["configs"][0]["why"]
    bad["end_to_end"][0]["why"] = "a key no metric has"
    got = manifest.problems(bad)
    assert any(p.startswith("configs ") and "keys" in p for p in got)
    assert any(p.startswith("end_to_end ") and "keys" in p for p in got)
    ok = json.loads(json.dumps(MAN))
    ok["configs"][0]["why"] = "two\nlines"
    assert any("bad why" in p for p in manifest.problems(ok))


def test_every_cell_resolves():
    for w in MAN["workloads"]:
        cell = manifest.cell(MAN, w["name"])
        assert os.path.exists(cell["toml"])
        assert cell["traffic"]["p_dtype"] in ("float64", "float32")
        assert set(cell["meta"]) >= {"source", "assumed", "reduced", "env"}
        assert cell["meta"]["reduced"] == \
            next(c for c in MAN["configs"]
                 if c["name"] == w["config"])["reduced"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(manifest.reader(m["name"]).read)


SOUND = """
LIMITS = {"float64": {"own.gap": 1e-9}, "float32": {"own.gap": 1e-6}}


def read(result, out_dir, device, low=None):
    return {"own.gap": 0.0}
"""


@pytest.mark.parametrize("stem,text,want", [
    ("nonrel_nonlinear", SOUND, None),
    ("no_such_config", SOUND, "names no configuration"),
    ("nonrel_nonlinear", SOUND.replace("own.gap", "dndp_gap"),
     "dndp_gap is a shared number"),
    ("nonrel_nonlinear", SOUND.replace(', "float32": {"own.gap": 1e-6}', ""),
     "no limits for float32 (nonrel_nonlinear.f32)"),
    ("nonrel_nonlinear", SOUND.split("def read")[0], "no read"),
    ("nonrel_nonlinear", "def read(*a, **kw):\n    return {}\n", "no LIMITS"),
    ("nonrel_nonlinear", SOUND.replace("1e-6", "-1e-6"),
     "float32 own.gap: limit -1e-06 is not a finite number >= 0"),
    ("nonrel_nonlinear", SOUND.replace("1e-6", "float('inf')"),
     "float32 own.gap: limit inf is not a finite number >= 0"),
    ("nonrel_nonlinear", SOUND.replace("1e-6", "'1e-6'"),
     "float32 own.gap: limit '1e-6' is not a finite number >= 0"),
], ids=["sound", "stem", "shared", "precision", "read", "limits",
        "negative", "infinite", "string"])
def test_problems_of_a_check_file(tmp_path, monkeypatch, stem, text, want):
    monkeypatch.setattr(manifest, "CHECKS", str(tmp_path))
    (tmp_path / (stem + ".py")).write_text(text)
    got = manifest.problems(MAN)
    if want is None:
        assert got == []
    else:
        assert got == [f"checks/{stem}.py: {want}"]


def test_no_check_file_for_an_existing_configuration():
    """The configurations judged by the shared numbers alone."""
    assert manifest.check_problems(MAN) == []
    for c in MAN["configs"]:
        assert manifest.check_module(c["name"]) is None
