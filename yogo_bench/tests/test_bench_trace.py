"""The reduction of a profiler trace (trace.summarize) on a hand-made one:
spans own what was launched in them, the backward thread's kernels go to
the main thread's open span, a prefetcher's copies to none, busy time is
the union of intervals, and idle gaps are named by what the host did."""

import pytest

from yogo_bench.trace import summarize

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench/window", "ts": 0, "dur": 100, "tid": 1},
    {"ph": "X", "cat": "user_annotation", "name": "bench/step", "ts": 10, "dur": 40, "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 60, "dur": 30, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1, "tid": 1, "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "dur": 1, "tid": 2, "args": {"correlation": 2}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 22, "dur": 1, "tid": 3, "args": {"correlation": 3}},
    {"ph": "X", "cat": "kernel", "name": "fwd", "ts": 13, "dur": 10, "tid": 7, "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "bwd", "ts": 20, "dur": 20, "tid": 7, "args": {"correlation": 2}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 30, "dur": 5, "tid": 8,
     "args": {"correlation": 3}},
]


def test_spans_busy_time_and_gaps():
    r = summarize(EVENTS)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["spans"]["bench/step"] == {"count": 1, "device_s": pytest.approx(30e-6)}
    assert r["busy_s"] == pytest.approx(27e-6)  # 13..40, the overlaps once
    assert r["memcpy"] == {"HtoD": pytest.approx(5e-6)}
    assert r["kernels"]["bwd"] == [1, pytest.approx(20e-6)]
    assert [k for k, _ in r["breakdown"]["device_ops"]] == ["bwd", "fwd", "Memcpy HtoD (Pinned -> Device)"]
    gaps = dict(r["breakdown"]["idle_gaps"])
    # 0..13 before the first launch; 40..100 from inside the step on
    assert gaps == {"no host op": pytest.approx(13e-6), "bench/step": pytest.approx(60e-6)}


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError):
        summarize(EVENTS[1:])
