"""The trace reduction, the roofline arithmetic and the import guard."""

import pytest

from harness import guard, roofline, trace


def test_union_counts_overlaps_once():
    assert trace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == \
        [(0, 3), (5, 6)]
    assert trace.union([]) == []


def test_gaps_and_clip():
    merged = trace.union(trace.clip([(-1, 1), (2, 3), (9, 12)], 0, 10))
    assert merged == [(0, 1), (2, 3), (9, 10)]
    assert trace.gaps(merged, 0, 10) == [(1, 2), (3, 9)]
    assert trace.gaps([], 0, 4) == [(0, 4)]


def _trace():
    device = [("helix_drain_kernel<double>", 1.0, 3.0),
              ("reduce_kernel", 2.0, 4.0),          # overlaps the drain
              ("mega_step_kernel", 6.0, 7.0),
              ("Memcpy DtoH (Device -> Pinned)", 7.0, 7.5),
              ("outside", 20.0, 21.0)]
    host = [("aten::copy_", 0.0, 1.0), ("cudaStreamSynchronize", 4.0, 5.5),
            ("aten::add", 5.5, 6.0), ("aten::item", 7.5, 10.0)]
    return trace.Trace(window=(0.0, 10.0), device=device, host=host,
                       host_waits=2)


def test_busy_is_the_union_inside_the_window():
    t = _trace()
    assert t.busy() == [(1.0, 4.0), (6.0, 7.5)]
    assert t.busy_s == pytest.approx(4.5)
    # the sum of the rows would count 1 s of overlap twice
    assert sum(e - s for _, s, e in t.device[:4]) == pytest.approx(5.5)
    assert t.kernel_seconds(("helix_drain_kernel",)) == pytest.approx(2.0)
    assert t.kernel_seconds(("mega_step_kernel",)) == pytest.approx(1.0)
    assert t.kernel_seconds(("absent",)) == 0.0


def test_idle_gaps_are_named_by_the_host_operator():
    gaps = _trace().idle_gaps()
    assert [g[0] for g in gaps] == ["aten::item", "cudaStreamSynchronize",
                                    "aten::copy_"]
    assert [g[1] for g in gaps] == pytest.approx([2.5, 2.0, 1.0])
    assert trace.name_gap((11.0, 12.0), []) == "no host operator"


def test_device_ops_sorted_by_time():
    ops = _trace().device_ops()
    assert ops[0][0] == "helix_drain_kernel<double>"
    assert ops[0][1] == pytest.approx(2.0)


def test_roofline_frozen_count():
    per_push = roofline.least_seconds(1, "float64")
    assert per_push == pytest.approx(max(230 / 34e12, 154 / 16.72704e12))
    assert roofline.least_seconds(10, "float32") == \
        pytest.approx(10 * max(230 / 67e12, 154 / 16.72704e12))
    # a kernel that runs at the bound reads 100%
    assert roofline.share_pct(1000, "float64",
                              1000 * per_push) == pytest.approx(100.0)
    assert roofline.share_pct(1000, "float64", 0.0) is None
    assert roofline.share_pct(0, "float32", 1.0) is None


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(
        ["montecarloscattering_jl_tpu_torch",
         "montecarloscattering_jl_tpu_torch.engine.driver", "jaxtyping",
         "numpy"]) == []
    assert guard.forbidden_loaded(
        ["montecarloscattering_jl_tpu.engine", "jax.numpy", "jaxlib", "flax",
         "torch"]) == ["flax", "jax.numpy", "jaxlib",
                       "montecarloscattering_jl_tpu.engine"]


def test_from_events_reads_the_chrome_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "benchmark.window",
         "ts": 0, "dur": 10e6},
        # the device-side copy of the host range spans the window: not busy
        {"ph": "X", "cat": "gpu_user_annotation", "name": "benchmark.window",
         "ts": 1e6, "dur": 8e6},
        {"ph": "X", "cat": "kernel", "name": "helix_drain_kernel<double>",
         "ts": 1e6, "dur": 2e6},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pageable)", "ts": 3e6, "dur": 0.5e6},
        # a copy into pinned memory is queued: busy, and no wait
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pinned)", "ts": 3.5e6, "dur": 0.5e6},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 4e6, "dur": 5e6},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 3.9e6,
         "dur": 5.1e6},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1e6},
    ]
    t = trace.from_events(ev)
    assert t.window == (0.0, 10.0)
    assert t.busy_s == pytest.approx(3.0)
    assert t.host_waits == 2
    gaps = t.idle_gaps()
    # the sync and the operator around it overlap the 4-9 s gap alike:
    # the inner one names it
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[0][1] == pytest.approx(6.0)
    with pytest.raises(RuntimeError):
        trace.from_events(ev[1:])
