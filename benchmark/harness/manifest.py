"""BENCHMARK.json and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything that belongs to one of them, or to one metric, sits in
files of its own that are found by name:

* ``configs[].file``: the configuration's TOML as it is run, and beside
  it ``<same stem>.json`` with its ``source``, ``assumed``, ``reduced``
  and the ``env`` set before the port is imported;
* ``traffic/<traffic>.json``: the mix's parameters (``p_dtype``);
* ``metrics/<metric>.py``: the metric's reader, ``read(ctx)``, which
  returns a number or None (nothing to read);
* ``checks/<configuration>.py``, where it exists: the configuration's own
  numbers for ``correct``, beside the shared ones of harness/check.py.
  It holds ``LIMITS`` ({precision: {number: limit}}, for each precision
  a cell of the configuration runs) and ``read(result, out_dir, device,
  low=None)``, which returns {number: reading} of the window's last run
  (with `low`, a torch dtype, the plain reference in that precision in
  the program's place: the control).  It is plain torch and NumPy, and
  imports nothing of the port or of JAX.  Its numbers may not repeat a
  shared number's name, so it adds judgements and never replaces or
  loosens one.  A configuration without the file is judged by the
  shared numbers alone.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CHECKS = os.path.join(HERE, "checks")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer")
# each entry's keys; a metric may add ``workloads``
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = ("end_to_end", "per_layer")


def _line(text) -> bool:
    """A `why`, `layer`, `source` or command word: 1 to 200 characters
    on one line, with no tab."""
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def reports(metric: dict, workload: str) -> bool:
    """Whether `metric` is reported in the cell `workload`."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell(man: dict, workload: str, root: str = ROOT) -> dict:
    """Everything one run of `workload` needs: the cell, its configuration
    (entry, TOML path, metadata), its traffic and its metrics of each
    kind."""
    w = _by_name(man["workloads"], workload, "workload")
    c = _by_name(man["configs"], w["config"], "configuration")
    toml = os.path.join(root, c["file"])
    with open(os.path.splitext(toml)[0] + ".json") as f:
        meta = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return dict(
        workload=w, config=c, toml=toml, meta=meta, traffic=traffic,
        check=check_module(c["name"]),
        end_to_end=[m for m in man["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in man["per_layer"] if reports(m, workload)])


def _load(path: str, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The module ``metrics/<name>.py``, loaded by path (a metric's name
    may hold dots)."""
    return _load(os.path.join(HERE, "metrics", name + ".py"),
                 "benchmark_metric_", name)


def check_module(config: str):
    """The module ``checks/<config>.py``, loaded by path, or None where
    the configuration has no check of its own."""
    path = os.path.join(CHECKS, config + ".py")
    if not os.path.exists(path):
        return None
    return _load(path, "benchmark_check_", config)


def check_problems(man: dict) -> list:
    """What in the files under ``checks/`` breaks their rules: a stem
    that names no configuration, no ``LIMITS`` or ``read``, no limits
    for the precision of a cell that runs the configuration, a limit
    that is not a finite number >= 0, a number named as a shared one of
    harness/check.py."""
    from .check import LIMITS as SHARED

    shared = {k for lim in SHARED.values() for k in lim}
    out = []
    configs = {c["name"] for c in man["configs"]}
    stems = sorted(f[:-3] for f in (os.listdir(CHECKS) if os.path.isdir(
        CHECKS) else []) if f.endswith(".py"))
    for stem in stems:
        if stem not in configs:
            out.append(f"checks/{stem}.py: names no configuration")
            continue
        mod = check_module(stem)
        if not callable(getattr(mod, "read", None)):
            out.append(f"checks/{stem}.py: no read")
        limits = getattr(mod, "LIMITS", None)
        if not isinstance(limits, dict):
            out.append(f"checks/{stem}.py: no LIMITS")
            continue
        for w in man["workloads"]:
            path = os.path.join(HERE, "traffic", w["traffic"] + ".json")
            if w["config"] != stem or not os.path.exists(path):
                continue
            with open(path) as f:
                p_dtype = json.load(f).get("p_dtype")
            if not isinstance(limits.get(p_dtype), dict):
                out.append(f"checks/{stem}.py: no limits for {p_dtype} "
                           f"({w['name']})")
        named = {k for lim in limits.values() if isinstance(lim, dict)
                 for k in lim}
        for k in sorted(named & shared):
            out.append(f"checks/{stem}.py: {k} is a shared number")
        for p_dtype, lim in limits.items():
            for k, v in (lim.items() if isinstance(lim, dict) else ()):
                if isinstance(v, bool) or not isinstance(
                        v, (int, float)) or not math.isfinite(v) or v < 0:
                    out.append(f"checks/{stem}.py: {p_dtype} {k}: limit "
                               f"{v!r} is not a finite number >= 0")
    return out


def problems(man: dict, root: str = ROOT) -> list:
    """What in `man` breaks the benchmark's rules that a file can show:
    names, units, sources, references between entries, the files each
    entry needs.  Empty when sound."""
    out = []
    if set(man) != set(KEYS):
        out.append(f"top-level keys {sorted(man)}, not {sorted(KEYS)}")
    for k, keys in ENTRY_KEYS.items():
        for e in man.get(k, []):
            extra = set(e) - keys - ({"workloads"} if k in METRICS else set())
            if keys - set(e) or extra:
                out.append(f"{k} {e.get('name')!r}: keys {sorted(e)}, not "
                           f"{sorted(keys)}")
    for word in man.get("command", []):
        if not _line(word):
            out.append(f"bad command word {word!r}")
    for k, field in (("configs", "why"), ("configs", "source"),
                     ("workloads", "why"), ("per_layer", "layer")):
        for e in man.get(k, []):
            if not _line(e.get(field)):
                out.append(f"{k} {e.get('name')!r}: bad {field}")
    if out:
        return out
    e2e = {m["name"]: m for m in man["end_to_end"]}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in man[k]]
    for n in names:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for k in ("configs", "workloads"):
        seen = [e["name"] for e in man[k]]
        if len(seen) != len(set(seen)):
            out.append(f"duplicate names in {k}")
    metrics = list(e2e) + [m["name"] for m in man["per_layer"]]
    if len(metrics) != len(set(metrics)):
        out.append("duplicate metric names")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    cells = {w["name"]: w for w in man["workloads"]}
    configs = {c["name"] for c in man["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a pair of configuration and traffic appears twice")
    for w in man["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown configuration")
        if not NAME.match(w["traffic"]):
            out.append(f"{w['name']}: bad traffic name")
        elif not os.path.exists(os.path.join(HERE, "traffic",
                                             w["traffic"] + ".json")):
            out.append(f"{w['name']}: no traffic file")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips must be 1 or 4")
        got = [m["name"] for m in man["end_to_end"]
               if reports(m, w["name"])]
        if "setup_s" not in got or len(got) < 2:
            out.append(f"{w['name']}: needs setup_s and one more "
                       f"end-to-end metric")
        if not any(reports(m, w["name"]) for m in man["per_layer"]):
            out.append(f"{w['name']}: no per-layer metric")
    for c in man["configs"]:
        if not c["file"].startswith(tuple(p + "/" for p in man["paths"])):
            out.append(f"{c['name']}: file outside paths")
        base = os.path.splitext(os.path.join(root, c["file"]))[0]
        for ext in (".toml", ".json"):
            if not os.path.exists(base + ext):
                out.append(f"{c['name']}: no {ext} file")
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"{c['name']}: bad reduced key {k!r}")
    layers = {}
    for m in man["end_to_end"] + man["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better must be lower or higher")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"{m['name']}: unknown cell {w!r}")
        if not os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py")):
            out.append(f"{m['name']}: no reader file")
    for m in man["end_to_end"]:
        if m["source"] not in SOURCES_E2E:
            out.append(f"{m['name']}: end-to-end source {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound out of range")
    for m in man["per_layer"]:
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']}")
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves {m['moves']!r}, not an "
                       f"end-to-end metric")
            continue
        for w in m.get("workloads", list(cells)):
            if not reports(e2e[m["moves"]], w):
                out.append(f"{m['name']}: cell {w} does not report "
                           f"{m['moves']}")
        layers.setdefault(m["layer"], []).append(m["name"])
        if "\n" in m["layer"] or not 1 <= len(m["layer"]) <= 200:
            out.append(f"{m['name']}: bad layer")
    return out + check_problems(man)
