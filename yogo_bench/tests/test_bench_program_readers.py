"""The readers of the program's own spans and counters
(yogo_tpu_torch.utils.tracing, through yogo_bench/program.py) on a
hand-made record: each reads its span's time a span or its counters'
ratio, and None where the record has nothing for it (no span, no stream
time, no program module)."""

import sys
import pytest

import yogo_tpu_torch.utils
from yogo_bench import manifest
from yogo_tpu_torch.utils import tracing

STATS = {
    "to_device": {"count": 4, "host_s": 0.036, "stream_s": None},
    "count": {"count": 4, "host_s": 0.032, "stream_s": 0.012},
    "step": {"count": 2, "host_s": 0.090, "stream_s": None},
    "step/forward": {"count": 2, "host_s": 0.020, "stream_s": 0.030},
    "step/backward": {"count": 2, "host_s": 0.010, "stream_s": 0.050},
    "step/optimizer": {"count": 2, "host_s": 0.002, "stream_s": 0.004},
    "prefetch_wait": {"count": 2, "host_s": 0.001, "stream_s": None},
}
COUNTS = {"nms_calls": 5, "nms_rounds": 15, "nms_host_syncs": 20}
WANT = {
    "h2d_host_ms.count": 9.0, "count_host_ms.count": 8.0, "count_stream_ms.count": 3.0,
    "nms_syncs.count": 4.0, "step_host_ms.train": 45.0, "fwd_stream_ms.train": 15.0,
    "bwd_stream_ms.train": 25.0, "opt_stream_ms.train": 2.0, "feed_wait_ms.train": 0.5,
}
PROGRAM = [m["name"] for m in manifest.load()["per_layer"] if m["source"] in ("program_span", "program_counter")]


def test_every_program_metric_has_a_case():
    assert sorted(PROGRAM) == sorted(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_reads_its_span_or_counters(name, monkeypatch):
    monkeypatch.setattr(tracing, "stats", lambda: STATS)
    monkeypatch.setattr(tracing, "counts", lambda: COUNTS)
    assert manifest.reader(name).read({}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_finds_nothing_in_an_empty_record(name, monkeypatch):
    monkeypatch.setattr(tracing, "stats", lambda: {})
    monkeypatch.setattr(tracing, "counts", lambda: {})
    assert manifest.reader(name).read({}) is None


@pytest.mark.parametrize("name", ["count_stream_ms.count", "fwd_stream_ms.train"])
def test_a_stream_reader_finds_nothing_without_stream_time(name, monkeypatch):
    monkeypatch.setattr(tracing, "stats", lambda: {k: {**v, "stream_s": None} for k, v in STATS.items()})
    assert manifest.reader(name).read({}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_finds_nothing_in_a_program_without_the_module(name, monkeypatch):
    monkeypatch.setattr(tracing, "stats", lambda: STATS)
    monkeypatch.setattr(tracing, "counts", lambda: COUNTS)
    # as in a checkout of the program from before the module: its import raises ImportError
    monkeypatch.delattr(yogo_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "yogo_tpu_torch.utils.tracing", None)
    assert manifest.reader(name).read({}) is None
