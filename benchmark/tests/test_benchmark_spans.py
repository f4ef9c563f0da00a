"""The port's spans against the device trace: harness/spans.py and the
readers of the span metrics, on a synthetic Chrome trace.

Two runs in a 20 s window.  The port's spans are host operators
(``cpu_op``): ``mcs.run`` 1-9 and 10-18 s, ``mcs.transport`` 2-6 and
11-15, ``mcs.finish`` 3-3.5 and 12-12.2, ``mcs.reductions.wait`` 7-8 and
16-16.5.  Device operations, in the order of their launching calls: a
drain 2.5-5 s launched at 2.2 under the transport; an index_put 5-5.4
launched at 3.2 under the first finish; a reduction 8-8.5 launched at
6.5, outside both; a kernel 12.3-12.5 and a copy 13-13.1 launched at
12.1 and 12.15 under the second finish; a kernel 14-14.2 launched at
13.95.  A stream sync and an event record launch nothing.
"""

import json

import pytest

from harness import main as hm
from harness import manifest, spans, trace

MAN = manifest.load()
NEW = ("driver.idle_s", "ladder.idle_s", "finish.device_s",
       "reductions.wait_s")
LAUNCHED = [2.2, 3.2, 6.5, 12.1, 12.15, 13.95]
SPANS = (("mcs.run", 1, 9), ("mcs.run", 10, 18), ("mcs.transport", 2, 6),
         ("mcs.transport", 11, 15), ("mcs.finish", 3, 3.5),
         ("mcs.finish", 12, 12.2), ("mcs.reductions.wait", 7, 8),
         ("mcs.reductions.wait", 16, 16.5))


def _x(cat, name, s, e, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": s * 1e6,
          "dur": (e - s) * 1e6, "pid": 0, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events(with_spans=True, drop=None, extra=(), ops=()):
    """The synthetic trace; `drop` leaves out the launching call of that
    start, `extra` adds host calls (name, start), `ops` device kernels
    (start, end)."""
    ev = [_x("user_annotation", "benchmark.window", 0.0, 20.0),
          _x("cpu_op", "aten::index_put_", 3.1, 3.4),
          _x("cuda_runtime", "cudaEventRecord", 2.3, 2.31),
          _x("kernel", "helix_drain_kernel<double>", 2.5, 5.0, 7),
          _x("kernel", "indexing_backward_kernel", 5.0, 5.4, 7),
          _x("kernel", "reduce_kernel", 8.0, 8.5, 7),
          _x("kernel", "indexing_backward_kernel", 12.3, 12.5, 7),
          _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 13.0, 13.1,
             7),
          _x("cuda_runtime", "cudaStreamSynchronize", 13.2, 13.9),
          _x("kernel", "elementwise_kernel", 14.0, 14.2, 7),
          {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 2.2e6}]
    for k, t in enumerate(LAUNCHED):
        if t != drop:
            name = "cudaMemcpyAsync" if t == 12.15 else (
                "cuLaunchKernel" if t == 13.95 else "cudaLaunchKernel")
            ev.append(_x("cuda_driver" if name[:2] == "cu" and
                         name[2] != "d" else "cuda_runtime",
                         name, t, t + 0.01, corr=k))
    for name, t in extra:
        ev.append(_x("cuda_runtime", name, t, t + 0.01))
    for s, e in ops:
        ev.append(_x("kernel", "graph_node_kernel", s, e, 7))
    if with_spans:
        for name, s, e in SPANS:
            ev.append(_x("cpu_op", name, s, e))
    return ev


def _ctx(events):
    runs = [hm.Run(seed=k, wall_s=8.0, pushes=10 ** 9, timers={})
            for k in range(2)]
    return hm.Context(p_dtype="float64", setup_s=1.0, window_s=20.0,
                      runs=runs, trace=trace.from_events(events))


@pytest.mark.parametrize("a,b,both,a_only", [
    ([(0, 2), (3, 5)], [(1, 4)], [(1, 2), (3, 4)], [(0, 1), (4, 5)]),
    ([(0, 1)], [(2, 3)], [], [(0, 1)]),
    ([(0, 4)], [(1, 2), (3, 5)], [(1, 2), (3, 4)], [(0, 1), (2, 3)]),
    ([], [(0, 1)], [], []),
])
def test_intersect_and_subtract(a, b, both, a_only):
    assert spans.intersect(a, b) == both
    assert spans.intersect(b, a) == both
    assert spans.subtract(a, b) == a_only


def test_spans_are_host_operators():
    t = trace.from_events(_events())
    assert spans.has_spans(t)
    assert spans.under(t, "mcs.transport") == [(2.0, 6.0), (11.0, 15.0)]
    assert spans.under(t, "mcs.finish") == [(3.0, 3.5), (12.0, 12.2)]


def test_launches_pair_in_order():
    t = trace.from_events(_events())
    assert spans.launches(t) == pytest.approx(LAUNCHED)


@pytest.mark.parametrize("drop,extra,ops", [
    (13.95, (), ()),                                # an operation unpaired
    (None, (("cudaLaunchKernel", 15.0),), ()),      # a launch without one
    # a CUDA graph's launch: several operations
    (None, (("cudaGraphLaunch", 15.0),), ((15.1, 15.2), (15.2, 15.3))),
])
def test_unpaired_launches_read_nothing(drop, extra, ops):
    t = trace.from_events(_events(drop=drop, extra=extra, ops=ops))
    assert spans.launches(t) is None
    assert spans.launched_s(t, "mcs.finish") is None
    ctx = _ctx(_events(drop=drop, extra=extra, ops=ops))
    assert manifest.reader("finish.device_s").read(ctx) is None
    # the idle and the waits need no pairing
    assert manifest.reader("ladder.idle_s").read(ctx) is not None


@pytest.mark.parametrize("name,per_run", [
    # the idle gaps: 0-2.5, 5.4-8, 8.5-12.3, 12.5-13, 13.1-14, 14.2-20;
    # under mcs.run and not under mcs.transport: 1-2, 6-8, 8.5-9, 10-11,
    # 15-18
    ("driver.idle_s", 7.5 / 2),
    # under mcs.transport: 2-2.5, 5.4-6, 11-12.3, 12.5-13, 13.1-14,
    # 14.2-15
    ("ladder.idle_s", 4.6 / 2),
    # the index_put, the kernel and the copy; not the worker's kernel
    ("finish.device_s", 0.7 / 2),
    # the main thread's waits alone
    ("reductions.wait_s", 1.5 / 2),
])
def test_span_metrics(name, per_run):
    ctx = _ctx(_events())
    got = manifest.reader(name).read(ctx)
    assert got == pytest.approx(per_run)
    assert manifest.reader(name + ".f32").read(ctx) == got


def test_idle_outside_the_runs_adds_up():
    t = trace.from_events(_events())
    idle = t.window_s - t.busy_s
    inside = (spans.idle_s(t, "mcs.run", minus="mcs.transport")
              + spans.idle_s(t, "mcs.transport"))
    # 0-1, 9-10 and 18-20: the harness's own, between runs
    assert idle - inside == pytest.approx(4.0)
    assert spans.idle_s(t, "mcs.run") == pytest.approx(inside)


@pytest.mark.parametrize("name", NEW)
def test_no_spans_reads_nothing(name):
    ctx = _ctx(_events(with_spans=False))
    assert not spans.has_spans(ctx.trace)
    assert manifest.reader(name).read(ctx) is None
    ctx.trace = None
    assert manifest.reader(name).read(ctx) is None


@pytest.mark.parametrize("name", [
    m["name"] for m in MAN["per_layer"] + MAN["end_to_end"]
    if m["name"].split(".f32")[0] not in NEW])
def test_existing_metrics_read_the_same_with_spans(name):
    plain, spanned = _ctx(_events(False)), _ctx(_events())
    assert manifest.reader(name).read(spanned) == \
        manifest.reader(name).read(plain)


def test_existing_trace_fields_are_unchanged_by_spans():
    """The spans are host operators of their own; what the existing
    metrics and the breakdown read of the device, the waits and torch's
    operators is the same."""
    plain = trace.from_events(_events(False))
    spanned = trace.from_events(_events())
    for f in ("window", "device", "host_waits"):
        assert getattr(spanned, f) == getattr(plain, f), f
    assert [h for h in spanned.host if not h[0].startswith("mcs.")] == \
        plain.host
    assert sorted(h for h in spanned.host if h[0].startswith("mcs.")) == \
        sorted((n, float(s), float(e)) for n, s, e in SPANS)
    assert spanned.busy() == plain.busy()
    assert spanned.device_ops() == plain.device_ops()
    assert [g[1] for g in spanned.idle_gaps()] == \
        [g[1] for g in plain.idle_gaps()]
    assert plain.host_waits == 2 and plain.busy_s == pytest.approx(3.9)


@pytest.mark.parametrize("name", NEW)
def test_manifest_entries(name):
    for suffix, cell, moves in (("", "nonrel_nonlinear.f64", "run_s"),
                                (".f32", "nonrel_nonlinear.f32",
                                 "run_s.f32")):
        m = next(m for m in MAN["per_layer"] if m["name"] == name + suffix)
        assert (m["source"], m["unit"], m["better"], m["moves"],
                m["workloads"]) == ("program_span", "s", "lower", moves,
                                    [cell])
    assert json.dumps(MAN["per_layer"]).count(f'"{name}') == 2
