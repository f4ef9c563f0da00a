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
13.95.  A stream sync and an event record launch nothing.  Each launching
call and its operation share a correlation id, as the profiler writes
them; the spans and the calls run on thread 1.
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


def _events(with_spans=True, drop=None, extra=(), ops=(), ids=True):
    """The synthetic trace; `drop` leaves out the launching call of that
    start, `extra` adds host calls (name, start[, thread]), each with
    correlation id 100 + its index, `ops` device kernels (start, end[,
    id, stream]); `ids` false writes no correlation id, as a trace
    without them."""
    dev = [("kernel", "helix_drain_kernel<double>", 2.5, 5.0),
           ("kernel", "indexing_backward_kernel", 5.0, 5.4),
           ("kernel", "reduce_kernel", 8.0, 8.5),
           ("kernel", "indexing_backward_kernel", 12.3, 12.5),
           ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 13.0, 13.1),
           ("kernel", "elementwise_kernel", 14.0, 14.2)]
    corr = (lambda k: k) if ids else (lambda k: None)
    ev = [_x("user_annotation", "benchmark.window", 0.0, 20.0),
          _x("cpu_op", "aten::index_put_", 3.1, 3.4),
          _x("cuda_runtime", "cudaEventRecord", 2.3, 2.31, corr=corr(50)),
          _x("cuda_runtime", "cudaStreamSynchronize", 13.2, 13.9,
             corr=corr(51)),
          {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 2.2e6}]
    ev += [_x(cat, name, s, e, 7, corr=corr(k))
           for k, (cat, name, s, e) in enumerate(dev)]
    for k, t in enumerate(LAUNCHED):
        if t != drop:
            name = "cudaMemcpyAsync" if t == 12.15 else (
                "cuLaunchKernel" if t == 13.95 else "cudaLaunchKernel")
            ev.append(_x("cuda_driver" if name[:2] == "cu" and
                         name[2] != "d" else "cuda_runtime",
                         name, t, t + 0.01, corr=corr(k)))
    for k, (name, t, *tid) in enumerate(extra):
        ev.append(_x("cuda_runtime", name, t, t + 0.01, *tid,
                     corr=corr(100 + k)))
    for s, e, *more in ops:
        k, stream = more if more else (100, 7)
        ev.append(_x("kernel", "graph_node_kernel", s, e, stream,
                     corr=corr(k)))
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


# the calls that put one operation on a stream, as the pairing in order
# read them (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync,
# cudaMemsetAsync)
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def _in_order(t):
    """The launching calls' starts paired in order with the operations
    that start in the window: the k-th operation with the k-th launch,
    copy or set; None where the counts differ."""
    lo, hi = t.window
    calls = sorted(s for n, s, _ in t.host
                   if lo <= s < hi and n.startswith(LAUNCH_CALLS))
    ops = [d for d in t.device if lo <= d[1] < hi]
    return calls if len(calls) == len(ops) else None


def _in_order_s(t, name):
    """launched_s by the pairing in order, the join's reference on one
    stream and one thread."""
    calls = _in_order(t)
    if calls is None:
        return None
    lo, hi = t.window
    ops = sorted((s, e) for _, s, e in t.device if lo <= s < hi)
    return spans.seconds(trace.union(trace.clip(
        [op for op, c in zip(ops, calls)
         if any(s <= c <= e for s, e in spans.under(t, name))], lo, hi)))


def test_launches_pair_in_order():
    t = trace.from_events(_events())
    assert _in_order(t) == pytest.approx(LAUNCHED)
    assert [t.calls[c][1] for c in t.device_ids] == pytest.approx(LAUNCHED)
    assert {t.calls[c][0] for c in t.device_ids} == {1}


def test_join_reads_the_pairing_in_order_on_one_stream():
    t = trace.from_events(_events())
    assert spans.launched_s(t, "mcs.finish") == pytest.approx(0.7)
    assert spans.launched_s(t, "mcs.finish") == _in_order_s(t, "mcs.finish")
    assert spans.launched_s(t, "mcs.transport") == \
        _in_order_s(t, "mcs.transport") == pytest.approx(3.4)


UNPAIRED = [
    (13.95, (), ()),                                # an operation unpaired
    (None, (("cudaLaunchKernel", 15.0),), ()),      # a launch without one
    # a CUDA graph's launch: several operations
    (None, (("cudaGraphLaunch", 15.0),), ((15.1, 15.2), (15.2, 15.3))),
]


@pytest.mark.parametrize("drop,extra,ops", UNPAIRED)
def test_unpaired_launches_read_nothing(drop, extra, ops):
    """Without correlation ids nothing joins an operation to its call,
    and the pairing in order fails on these traces."""
    events = _events(drop=drop, extra=extra, ops=ops, ids=False)
    t = trace.from_events(events)
    assert _in_order(t) is None
    assert t.calls == {} and set(t.device_ids) == {None}
    assert spans.launched_s(t, "mcs.finish") is None
    ctx = _ctx(events)
    assert manifest.reader("finish.device_s").read(ctx) is None
    # the idle and the waits need no pairing
    assert manifest.reader("ladder.idle_s").read(ctx) is not None


@pytest.mark.parametrize("drop,extra,ops,finish", [
    case + (0.7,) for case in UNPAIRED] + [
    # a worker thread's graph launch at 12.05, inside the second finish's
    # time but not on its thread, runs a kernel on a second stream
    (None, (("cudaGraphLaunch", 12.05, 2),), ((12.6, 12.7, 100, 9),),
     0.7),
    # the same launch on the spans' thread counts, both of its kernels
    (None, (("cudaGraphLaunch", 12.05, 1),),
     ((12.6, 12.7, 100, 9), (12.7, 12.75, 100, 9)), 0.85),
    # a copy on a second stream, launched at 4.0 outside the finish, that
    # runs 4.1-4.3, before the first finish's index_put: in order, the
    # copy is put down to the finish's launch at 3.2
    (None, (("cudaMemcpyAsync", 4.0),), ((4.1, 4.3, 100, 9),), 0.7),
])
def test_join_by_correlation(drop, extra, ops, finish):
    """One operation has no launching call in order: the pairing in order
    reads None or the wrong seconds, the join the right ones."""
    events = _events(drop=drop, extra=extra, ops=ops)
    t = trace.from_events(events)
    in_order = _in_order_s(t, "mcs.finish")
    assert in_order is None or abs(in_order - finish) > 0.1
    assert spans.launched_s(t, "mcs.finish") == pytest.approx(finish)
    ctx = _ctx(events)
    assert manifest.reader("finish.device_s").read(ctx) == \
        pytest.approx(finish / 2)


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
