"""The swin family and its cell, swin_small.count, on the CPU: the pinned
MACs, grid, window-attention bytes and FLOPs and digests (as
test_bench_families.py pins the other families'), a sound run at a small
size, the faults of the window attention planted in the program (each
reads `correct` false), the fp8 control, the new per-layer readers on a
hand-made record, and the manifest's new entries."""

import hashlib
import sys
import time

import pytest
import torch

import yogo_tpu_torch.utils
from yogo_bench import controls_swin, flops, manifest, reference, run, scene, weights
from yogo_bench.families import swin
from yogo_tpu_torch.utils import tracing

MAN = manifest.load()
CELL = "swin_small.count"
SEED = 98765432101
PINNED = {
    "macs": 145_597_569_936, "grid": (132, 100),
    "attn_bytes_b64": 20_462_269_524, "attn_flops_b64": 501_323_268_096,
    "weights": "3e8e8997b9c8385ebca77e93692eab0eedbd138ef49ee2c94d411169815e24ae",
    "head": "a837cd03df39f24ff65e4581a2414df9dade165b9a0a947484af91f5f9da3c85",
}
RESIZE = {"config": {"img_size": [100, 132]},
          "traffic": {"batch": 2, "pool": 4, "blobs": [2, 5], "warmup_batches": 1}}


def _run(f32=True, seconds=1.0):
    rs = {k: dict(v) for k, v in RESIZE.items()}
    if f32:
        rs["config"]["compute_dtype"] = "float32"
    return run.run_cell(MAN, CELL, SEED, seconds, False, "cpu", start=time.perf_counter(), resize=rs)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_counts_are_pinned():
    cfg = manifest.config(MAN, "swin_small")
    assert flops.macs_per_image(cfg) == PINNED["macs"]
    assert reference.grid(cfg) == PINNED["grid"]
    assert swin.attn_bytes(cfg, 64) == PINNED["attn_bytes_b64"]
    assert swin.attn_flops(cfg, 64) == PINNED["attn_flops_b64"]
    # 1,392 padded windows of 49 tokens an image (1,036 / 266 / 70 / 20), 3,904
    # window-blocks, and Swin-S's 48.8 M parameters
    windows = [(hp // 7) * (wp // 7) for _, _, hp, wp in swin.stage_maps(cfg)]
    assert windows == [1036, 266, 70, 20]
    assert sum(n * d for n, d in zip(windows, cfg["depths"])) == 3904
    assert sum(torch.Size(shape).numel() for _, shape, _, _ in swin.spec(cfg)) == cfg["params"] == 48_840_360


def test_seed0_weights_are_pinned():
    cfg = manifest.config(MAN, "swin_small")
    h = hashlib.sha256()
    w = weights.make(swin.spec(cfg), 0, "cpu")
    for k in sorted(w):
        h.update(k.encode())
        h.update(w[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED["weights"]


def test_reference_head_is_pinned(one_thread):
    cfg = {**manifest.config(MAN, "swin_small"), "img_size": [64, 96]}
    w = weights.make(swin.spec(cfg), 0, "cpu")
    frames, _ = scene.pool(0, range(2), hw=cfg["img_size"], blobs=(2, 5))
    head = reference.head(w, frames, cfg)
    assert head.dtype == torch.float32 and head.shape == (2, 8, 12, 7)
    assert hashlib.sha256(head.contiguous().numpy().tobytes()).hexdigest() == PINNED["head"]


def test_the_family_has_no_training_path():
    cfg = {**manifest.config(MAN, "swin_small"), "img_size": [64, 96]}
    w = weights.make(swin.spec(cfg), 0, "cpu")
    with pytest.raises(NotImplementedError):
        swin.forward(w, torch.zeros(1, 1, 64, 96), cfg, cast=reference.f32, train=True)


def test_a_sound_run_is_correct():
    r = _run()
    assert r["correct"] and r["attempted"] > 0, r["checks"]
    assert r["checks"]["head_rel_rms"][0] < 1e-5


@pytest.mark.parametrize("fault", controls_swin.FAULTS)
def test_a_fault_of_the_window_attention_is_caught(fault):
    with controls_swin.planted(fault):
        r = _run()
    checks = r["checks"]
    assert not r["correct"] and checks["head_rel_rms"][0] > checks["head_rel_rms"][1], checks
    assert _run()["correct"]  # the fault is gone with the block


def test_the_fp8_control_fails():
    cfg = {**manifest.config(MAN, "swin_small"), "img_size": [100, 132]}
    w = weights.production_density(weights.make(swin.spec(cfg), 0, "cpu"), cfg)
    frames, _ = scene.pool(SEED, range(2), hw=cfg["img_size"], blobs=(2, 5))
    ref = reference.head(w, frames, cfg)
    fp8 = reference.head(w, frames, cfg, cast=reference.fp8)
    d = (fp8.double() - ref.double()).norm() / ref.double().norm()
    assert d > manifest.limits(CELL)["checks"]["head_rel_rms"]


def test_the_new_entries_keep_the_contract():
    assert manifest.validate(MAN) == []
    assert manifest.cell(MAN, CELL)["chips"] == 1
    names = {m["name"] for m in manifest.per_layer(MAN, CELL)}
    assert {"win_attn_ms.count", "win_layout_ms.count", "win_attn_roofline.count", "forward_ms.count"} <= names
    assert "stem_roofline.count" not in names
    assert {m["name"] for m in manifest.end_to_end(MAN, CELL)} == {"count_images_per_s", "setup_s"}


# ------------------------------------------------------------- readers

STATS = {"swin/attn": {"count": 48, "host_s": 0.01, "stream_s": 0.030},
         "swin/layout": {"count": 96, "host_s": 0.01, "stream_s": 0.012}}
CTX = {"counters": {"batches": 2, "batch": 64}, "cfg": manifest.config(MAN, "swin_small"),
       "card": "NVIDIA H100 80GB HBM3"}
# 20.46 GB at 3.35 TB/s (6.108 ms; 501 GFLOP at 989 TFLOP/s is 0.507) over 15 ms
WANT = {"win_attn_ms.count": 15.0, "win_layout_ms.count": 6.0,
        "win_attn_roofline.count": 100.0 * 20_462_269_524 / 3.35e12 / 0.015}


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_reads_its_spans(name, monkeypatch):
    monkeypatch.setattr(tracing, "stats", lambda: STATS)
    assert manifest.reader(name).read(CTX) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_finds_nothing_without_its_spans(name, monkeypatch):
    monkeypatch.setattr(tracing, "stats", lambda: {})
    assert manifest.reader(name).read(CTX) is None
    monkeypatch.setattr(tracing, "stats", lambda: {k: {**v, "stream_s": None} for k, v in STATS.items()})
    assert manifest.reader(name).read(CTX) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_finds_nothing_in_a_program_without_the_module(name, monkeypatch):
    monkeypatch.setattr(tracing, "stats", lambda: STATS)
    monkeypatch.delattr(yogo_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "yogo_tpu_torch.utils.tracing", None)
    assert manifest.reader(name).read(CTX) is None
