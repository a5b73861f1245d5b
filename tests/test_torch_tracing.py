"""The port's spans and counters (yogo_tpu_torch/utils/tracing.py) on the
CPU: nothing recorded without a profiler, the spans in the profiler's
trace and in the record, threads, the training step's phases (and a step
under the profiler bit-equal to one without), the count's NMS counters and
the window's counters."""

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yogo_tpu_torch.data.prefetch import prefetch_to_device
from yogo_tpu_torch.infer import Predictor
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step
from yogo_tpu_torch.utils import tracing

HW = (96, 128)
KW = dict(no_obj_weight=0.5, iou_weight=5.0, classify_weight=1.0, label_smoothing=0.01)
PHASES = ("step", "step/forward", "step/backward", "step/optimizer")


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.reset()
    yield
    tracing.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_profiler_a_span_records_nothing_and_opens_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function reached without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with tracing.span("outer"):
        with tracing.span("inner", "cpu"):
            pass
    assert tracing.stats() == {}


def test_spans_under_the_profiler_export_as_user_annotations_and_are_counted(tmp_path):
    with cpu_profile() as prof:
        for _ in range(3):
            with tracing.span("outer"):
                with tracing.span("outer/inner", "cpu"):
                    torch.ones(8).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("yogo/outer") == 3 and names.count("yogo/outer/inner") == 3
    rec = tracing.stats()
    assert set(rec) == {"outer", "outer/inner"}
    for name in rec:
        assert rec[name]["count"] == 3 and rec[name]["stream_s"] is None
    assert rec["outer"]["host_s"] >= rec["outer/inner"]["host_s"] > 0
    # kept only while a profiler is active
    with tracing.span("outer"):
        pass
    assert tracing.stats()["outer"]["count"] == 3


def test_two_threads_aggregate_into_one_record(monkeypatch):
    """torch.profiler sees only the thread that started it (and autograd's,
    which inherit its state): the gate is opened for every thread here, so
    both threads record into the one record at once."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    n, errors = 400, []
    interval = sys.getswitchinterval()

    def work(name):
        try:
            for _ in range(n):
                with tracing.span(name):
                    with tracing.span("shared"):
                        tracing.add(shared_adds=1)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    before = tracing.COUNTS["shared_adds"]
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    rec = tracing.stats()
    assert rec["t0"]["count"] == rec["t1"]["count"] == n
    assert rec["shared"]["count"] == 2 * n
    assert tracing.COUNTS["shared_adds"] - before == 2 * n


def tiny_state(model, seed=0):
    stack = model.init(torch.Generator().manual_seed(seed), device="cpu")
    opt, sched, _ = make_optimizer(stack.parameters(), 1e-3, 5e-2, 10.0, 50)
    return TrainState(stack, opt, sched)


def tiny_batch(model, b=2, seed=0):
    rng = np.random.default_rng(seed)
    sx, sy = model.grid
    imgs = rng.integers(0, 255, (b, 1, *HW)).astype(np.uint8)
    labels = np.zeros((b, 6, sy, sx), np.float32)
    labels[:, :, sy // 2, sx // 2] = [1, 0.4, 0.4, 0.6, 0.6, 1]
    return torch.from_numpy(imgs), torch.from_numpy(labels), torch.ones(b)


def run_steps(model, step, n, profiled):
    state = tiny_state(model)
    imgs, labels, mask = tiny_batch(model)
    gen = torch.Generator().manual_seed(5)
    losses = []
    with cpu_profile() if profiled else contextlib.nullcontext():
        for _ in range(n):
            state, loss, _ = step(state, imgs, labels, mask, gen)
            losses.append(loss)
    return losses, state.stack.state_dict()


def test_a_step_under_the_profiler_records_its_phases_and_equals_an_untraced_step():
    model = YOGO.create(HW, 0.08, 0.1, 3, model_version="quarter_filters")
    step = make_train_step(model, KW)
    plain_losses, plain = run_steps(model, step, 2, profiled=False)
    assert tracing.stats() == {}
    losses, traced = run_steps(model, step, 2, profiled=True)
    rec = tracing.stats()
    for name in PHASES:
        assert rec[name]["count"] == 2, name
        assert rec[name]["stream_s"] is None
    for a, b in zip(losses, plain_losses):
        assert torch.equal(a, b)
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k


def test_accumulate_opens_forward_and_backward_once_a_micro_batch():
    model = YOGO.create(HW, 0.08, 0.1, 3, model_version="quarter_filters")
    step = make_train_step(model, KW, augment=False, accumulate=2)
    imgs, labels, mask = tiny_batch(model, b=4)
    state = tiny_state(model)
    with cpu_profile():
        step(state, imgs.reshape(2, 2, *imgs.shape[1:]), labels.reshape(2, 2, *labels.shape[1:]),
             mask.reshape(2, 2), torch.Generator().manual_seed(0))
    rec = tracing.stats()
    assert rec["step"]["count"] == rec["step/optimizer"]["count"] == 1
    assert rec["step/forward"]["count"] == rec["step/backward"]["count"] == 2


def test_predictor_spans_and_the_count_moves_the_nms_counters():
    model = YOGO.create(HW, 0.08, 0.1, 3, model_version="quarter_filters")
    pred = Predictor(model, model.init(torch.Generator().manual_seed(0), device="cpu"))
    imgs = np.random.default_rng(0).integers(0, 255, (2, 1, *HW)).astype(np.uint8)
    before = dict(tracing.COUNTS)
    with cpu_profile():
        with torch.inference_mode():
            x = pred.to_device(imgs)  # already on the model's device: no copy, no span
            raw = pred.forward_raw(x)
            raw[..., 4] = 4.0  # every cell a confident detection: NMS has work
            pred.count(raw, torch.ones(2, dtype=torch.bool))
    rec = tracing.stats()
    assert set(rec) == {"count"}
    assert rec["count"]["count"] == 1 and rec["count"]["stream_s"] is None
    delta = {k: tracing.COUNTS[k] - before.get(k, 0) for k in ("nms_calls", "nms_rounds", "nms_host_syncs")}
    assert delta["nms_calls"] == 1 and delta["nms_host_syncs"] >= 1 and delta["nms_rounds"] >= 1
    assert tracing.counts() == delta  # all of it inside the profiled stretch


def test_the_window_s_counters_hold_only_what_was_added_under_the_profiler():
    before = tracing.COUNTS["window_adds"]
    tracing.add(window_adds=2)  # set-up, before the profiler
    with cpu_profile():
        tracing.add(window_adds=3)
        tracing.add(window_adds=4, other_adds=1)
    tracing.add(window_adds=5)  # after it
    assert tracing.COUNTS["window_adds"] - before == 14
    assert tracing.counts() == {"window_adds": 7, "other_adds": 1}
    tracing.reset()
    assert tracing.counts() == {}


def test_prefetch_wait_is_one_span_a_batch_handed_out():
    batches = [(np.zeros((2, 1, 4, 4), np.uint8), np.zeros((2, 6, 2, 2), np.float32), np.ones(2, np.float32))] * 5
    feed = prefetch_to_device(iter(batches), "cpu")
    with cpu_profile():
        for _ in range(3):
            next(feed)
    feed.close()
    assert tracing.stats()["prefetch_wait"]["count"] == 3


@pytest.mark.cuda
def test_cuda_stream_time_covers_the_device_work_of_a_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    alone_s = start.elapsed_time(end) / 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            with tracing.span("busy", dev):
                torch.cuda._sleep(20_000_000)
            with tracing.span("host only"):
                pass
    first = tracing.stats()
    assert first["busy"]["count"] == 3 and first["host only"]["stream_s"] is None
    assert 3 * 0.8 * alone_s <= first["busy"]["stream_s"] <= 3 * 1.5 * alone_s
    assert tracing.stats() == first  # resolved once
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with tracing.span("busy", dev):
            torch.cuda._sleep(20_000_000)
    assert tracing.stats()["busy"]["count"] == 4
