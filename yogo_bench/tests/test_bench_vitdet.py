"""The vitdet family and its cell, vitdet_base.count, on the CPU: the
pinned MACs, grid, global-attention bytes and FLOPs and digests (as
test_bench_families.py pins the other families'), a sound run at a small
size, the faults of the attention planted in the program (each reads
`correct` false), the fp8 control, the new per-layer readers on a
hand-made record, and the manifest's new entries."""

import hashlib
import sys
import time

import pytest
import torch

import yogo_tpu_torch.utils
from yogo_bench import controls_vitdet, flops, manifest, reference, run, scene, weights
from yogo_bench.families import vitdet
from yogo_tpu_torch.utils import tracing

MAN = manifest.load()
CELL = "vitdet_base.count"
SEED = 98765432101
PINNED = {
    "macs": 371_119_508_480, "grid": (130, 98),
    "global_attn_bytes_b64": 5_009_687_552, "global_attn_flops_b64": 8_120_515_952_640,
    "weights": "765d202c3a0d7c66a4de3aab4f772a0ceb4ee53bda70450d691539cc44be9138",
    "head": "2e04b33c930a9eee70700b79620ad72a505906c8c7eb7c5dd1ad6e9fd988dd08",
}
RESIZE = {"config": {"img_size": [72, 104]},
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
    """371 GMACs an image (the global attention's q . k and values 62.3 of
    them), 8.12 TFLOP and 5.01 GB of global attention a B=64 batch, and
    ViTDet-B's 85.5 M backbone parameters plus the pyramid's level and the
    head: 87.4 M."""
    cfg = manifest.config(MAN, "vitdet_base")
    assert flops.macs_per_image(cfg) == PINNED["macs"]
    assert reference.grid(cfg) == PINNED["grid"]
    assert vitdet.global_attn_bytes(cfg, 64) == PINNED["global_attn_bytes_b64"]
    assert vitdet.global_attn_flops(cfg, 64) == PINNED["global_attn_flops_b64"]
    assert round(4 * 12 * 2 * 3185 ** 2 * 64 / 1e9, 1) == 62.3
    assert sum(torch.Size(shape).numel() for _, shape, _, _ in vitdet.spec(cfg)) == cfg["params"] == 87_366_791


def test_seed0_weights_are_pinned():
    cfg = manifest.config(MAN, "vitdet_base")
    h = hashlib.sha256()
    w = weights.make(vitdet.spec(cfg), 0, "cpu")
    for k in sorted(w):
        h.update(k.encode())
        h.update(w[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED["weights"]


def test_reference_head_is_pinned(one_thread):
    cfg = {**manifest.config(MAN, "vitdet_base"), "img_size": [64, 96]}
    w = weights.make(vitdet.spec(cfg), 0, "cpu")
    frames, _ = scene.pool(0, range(2), hw=cfg["img_size"], blobs=(2, 5))
    head = reference.head(w, frames, cfg)
    assert head.dtype == torch.float32 and head.shape == (2, 8, 12, 7)
    assert hashlib.sha256(head.contiguous().numpy().tobytes()).hexdigest() == PINNED["head"]


def test_the_family_has_no_training_path():
    cfg = {**manifest.config(MAN, "vitdet_base"), "img_size": [64, 96]}
    w = weights.make(vitdet.spec(cfg), 0, "cpu")
    with pytest.raises(NotImplementedError):
        vitdet.forward(w, torch.zeros(1, 1, 64, 96), cfg, cast=reference.f32, train=True)


def test_a_sound_run_is_correct():
    r = _run()
    assert r["correct"] and r["attempted"] > 0, r["checks"]
    assert r["checks"]["head_rel_rms"][0] < 1e-5


@pytest.mark.parametrize("fault", controls_vitdet.FAULTS)
def test_a_fault_of_the_attention_is_caught(fault):
    with controls_vitdet.planted(fault):
        r = _run()
    checks = r["checks"]
    assert not r["correct"] and checks["head_rel_rms"][0] > checks["head_rel_rms"][1], checks
    assert _run()["correct"]  # the fault is gone with the block


def test_the_fp8_control_fails():
    cfg = {**manifest.config(MAN, "vitdet_base"), "img_size": [72, 104]}
    w = weights.make(vitdet.spec(cfg), 0, "cpu")
    frames, _ = scene.pool(SEED, range(2), hw=cfg["img_size"], blobs=(2, 5))
    ref = reference.head(w, frames, cfg)
    fp8 = reference.head(w, frames, cfg, cast=reference.fp8)
    d = (fp8.double() - ref.double()).norm() / ref.double().norm()
    assert d > manifest.limits(CELL)["checks"]["head_rel_rms"]


def test_the_new_entries_keep_the_contract():
    assert manifest.validate(MAN) == []
    assert manifest.cell(MAN, CELL)["chips"] == 1
    names = {m["name"] for m in manifest.per_layer(MAN, CELL)}
    new = {"vit_global_attn_ms.count", "vit_global_attn_roofline.count", "vit_win_attn_ms.count",
           "vit_layout_ms.count"}
    assert new | {"forward_ms.count", "mfu.count", "idle.count", "nms_syncs.count"} <= names
    assert not names & {"stem_roofline.count", "win_attn_ms.count", "win_attn_roofline.count"}
    assert {m["name"] for m in manifest.end_to_end(MAN, CELL)} == {"count_images_per_s", "setup_s"}
    for m in MAN["per_layer"]:
        if m["name"] in new:
            assert m["workloads"] == [CELL]


# ------------------------------------------------------------- readers

STATS = {"vit/global_attn": {"count": 8, "host_s": 0.01, "stream_s": 0.060},
         "vit/win_attn": {"count": 16, "host_s": 0.01, "stream_s": 0.040},
         "vit/layout": {"count": 32, "host_s": 0.01, "stream_s": 0.010}}
CTX = {"counters": {"batches": 2, "batch": 64}, "cfg": manifest.config(MAN, "vitdet_base"),
       "card": "NVIDIA H100 80GB HBM3"}
# 8.12 TFLOP at 989 TFLOP/s (8.211 ms; 5.01 GB at 3.35 TB/s is 1.495) over 30 ms
WANT = {"vit_global_attn_ms.count": 30.0, "vit_win_attn_ms.count": 20.0, "vit_layout_ms.count": 5.0,
        "vit_global_attn_roofline.count": 100.0 * 8_120_515_952_640 / 989e12 / 0.030}


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
