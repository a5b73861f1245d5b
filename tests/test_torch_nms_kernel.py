"""The NMS kernel (yogo_tpu_torch/csrc/nms.cu via ops/nms.batched_nms)
against its plain version (ops/nms.batched_nms_reference, the torch chain
and fixed-point loop), and the count's sync-free path on the card.

The CPU tests check what runs here: the plain version against a sequential
float32 greedy oracle on the same cases the card tests use, the counters of
the CPU path, the wrapper's argument checks (on `meta` tensors, which no
kernel takes) and the kernel's ctypes binding. The `cuda` tests need a GPU:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nms_kernel.py -m cuda
This file imports no JAX.
"""

import ctypes

import numpy as np
import pytest
import torch

from yogo_tpu_torch import kernels
from yogo_tpu_torch.ops import nms
from yogo_tpu_torch.utils import tracing

THRESHOLDS = (0.3, 0.5, 0.7)
KINDS = ("random", "clustered", "shared_tiebreak")


def make_case(seed: int, b: int, k: int, kind: str):
    """(boxes (B, K, 4) f32 xyxy, scores (B, K) f32, valid (B, K) bool,
    tiebreak (B, K) int64) as numpy arrays, seeded.

    random: boxes anywhere in the unit square; clustered: boxes jittered
    around a few centres, so chains of overlaps; shared_tiebreak: clustered,
    with tiebreaks drawn with repeats. Every kind has scores on a grid of
    twentieths (equal scores broken by tiebreak), NaN and -inf scores,
    invalid slots, zero-area and inverted boxes, a NaN coordinate and boxes
    whose extents reach 1e19 (the clamp) or beyond."""
    rng = np.random.default_rng([seed, b, k, KINDS.index(kind)])
    if kind == "random":
        xy = rng.random((b, k, 2))
        wh = rng.uniform(0.0, 0.3, (b, k, 2))
    else:
        centres = rng.random((b, max(1, k // 12), 2))
        pick = rng.integers(0, centres.shape[1], (b, k))
        xy = np.take_along_axis(centres, pick[..., None], axis=1) + rng.normal(0, 0.01, (b, k, 2))
        wh = rng.uniform(0.03, 0.06, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = (rng.integers(1, 21, (b, k)) / 20.0).astype(np.float32)
    if kind == "shared_tiebreak":
        tiebreak = rng.integers(0, max(1, k // 3), (b, k))
    else:
        tiebreak = np.stack([rng.permutation(k) for _ in range(b)])
    valid = rng.random((b, k)) < 0.85

    def some(p):
        return rng.random((b, k)) < p

    scores[some(0.05)] = np.nan
    scores[some(0.03)] = -np.inf
    zero = some(0.05)
    boxes[zero, 2] = boxes[zero, 0]  # zero width
    inverted = some(0.05)
    boxes[inverted, 2:] = boxes[inverted, :2] - 0.01
    huge = some(0.02)
    boxes[huge] = np.array([-6e18, -6e18, 6e18, 6e18], np.float32)  # extents 1.2e19: clamped
    beyond = some(0.01)
    boxes[beyond] = np.array([-1e30, 0.1, np.inf, 0.2], np.float32)
    boxes[some(0.01), 1] = np.nan
    return boxes, scores, valid, tiebreak.astype(np.int64)


def greedy_oracle(boxes, scores, valid, tiebreak, thr):
    """Sequential greedy NMS in float32 numpy, one image at a time: valid
    slots in (score desc, tiebreak asc, slot asc) order, NaN scores as
    -inf; a kept slot removes every later valid slot it precedes and whose
    IoU (the torch chain's ops, each rounded to f32) exceeds thr."""
    thr = np.float32(thr)
    lim = np.float32(1e19)
    keep = np.zeros(valid.shape, bool)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for b in range(boxes.shape[0]):
            bx, v, tb = boxes[b], valid[b], tiebreak[b]
            s = np.where(np.isnan(scores[b]), np.float32(-np.inf), scores[b])
            ext = np.clip(bx[:, 2:] - bx[:, :2], np.float32(0), lim)
            area = ext[:, 0] * ext[:, 1]
            slots = np.arange(len(s))
            order = [i for i in np.lexsort((slots, tb, -s)) if v[i]]
            removed = np.zeros(len(s), bool)
            for i in order:
                if removed[i]:
                    continue
                keep[b, i] = True
                lt = np.maximum(bx[i, :2], bx[:, :2])
                rb = np.minimum(bx[i, 2:], bx[:, 2:])
                wh = np.clip(rb - lt, np.float32(0), lim)
                inter = wh[:, 0] * wh[:, 1]
                iou = inter / ((area[i] + area) - inter)
                precedes = (s[i] > s) | ((s[i] == s) & (tb[i] < tb))
                removed |= (iou > thr) & precedes & v
    return keep


def as_torch(case, device):
    return tuple(torch.from_numpy(a).to(device) for a in case)


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,k", [(1, 1), (3, 7), (2, 64)])
def test_plain_version_is_sequential_greedy(b, k, kind, thr):
    case = make_case(0, b, k, kind)
    boxes, scores, valid, tb = as_torch(case, "cpu")
    keep = nms.batched_nms(boxes, scores, valid, thr, tiebreak=tb)
    np.testing.assert_array_equal(keep.numpy(), greedy_oracle(*case, thr))


def test_cpu_path_runs_the_loop_and_counts_it():
    boxes, scores, valid, tb = as_torch(make_case(1, 3, 64, "clustered"), "cpu")
    before = dict(tracing.COUNTS)
    nms.batched_nms(boxes, scores, valid, 0.5, tiebreak=tb)
    delta = {k: tracing.COUNTS[k] - before.get(k, 0)
             for k in ("nms_calls", "nms_rounds", "nms_host_syncs", "nms_kernel_launches")}
    assert delta["nms_calls"] == 1
    assert delta["nms_rounds"] >= 2 and delta["nms_host_syncs"] >= 2  # chains: more than one round
    assert delta["nms_kernel_launches"] == 0


def test_sources_bind_the_nms_kernel():
    fns = kernels.SOURCES["nms"]
    assert fns["yogo_nms_launch"] == (
        ctypes.c_int,
        [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    )
    assert sorted(fns) == ["yogo_cuda_error_string", "yogo_nms_launch"]
    assert fns["yogo_cuda_error_string"] == (ctypes.c_char_p, [ctypes.c_int])
    assert kernels._sources("nms") == [kernels.CSRC_DIR / "nms.cu"]


@pytest.mark.parametrize("k,want", [(1, 256), (64, 5120), (65, 5632), (256, 25856), (1024, 201728)])
def test_workspace_bytes_follow_the_kernel_s_layout(k, want):
    """An image's workspace: 69 bytes a slot, 8 a bitmask word
    (ceil(K/64) a slot), rounded up to 256."""
    assert nms._workspace_bytes(k) == want


def _meta_args(b=2, k=5, **over):
    args = {
        "boxes": torch.empty((b, k, 4), dtype=torch.float32, device="meta"),
        "scores": torch.empty((b, k), dtype=torch.float32, device="meta"),
        "valid": torch.empty((b, k), dtype=torch.bool, device="meta"),
        "tiebreak": torch.empty((b, k), dtype=torch.int64, device="meta"),
    }
    args.update(over)
    return args


WRONG = {
    "boxes_f64": ({"boxes": torch.empty((2, 5, 4), dtype=torch.float64, device="meta")}, "boxes must be torch.float32"),
    "boxes_bf16": ({"boxes": torch.empty((2, 5, 4), dtype=torch.bfloat16, device="meta")}, "boxes must be torch.float32"),
    "scores_f16": ({"scores": torch.empty((2, 5), dtype=torch.float16, device="meta")}, "scores must be torch.float32"),
    "valid_uint8": ({"valid": torch.empty((2, 5), dtype=torch.uint8, device="meta")}, "valid must be torch.bool"),
    "tiebreak_int32": ({"tiebreak": torch.empty((2, 5), dtype=torch.int32, device="meta")}, "tiebreak must be torch.int64"),
    "boxes_xywh5": ({"boxes": torch.empty((2, 5, 5), device="meta")}, r"boxes must be \(B, K, 4\)"),
    "boxes_2d": ({"boxes": torch.empty((5, 4), device="meta")}, r"boxes must be \(B, K, 4\)"),
    "k_zero": ({"boxes": torch.empty((2, 0, 4), device="meta")}, "K >= 1"),
    "scores_shape": ({"scores": torch.empty((2, 6), device="meta")}, r"scores must be \(2, 5\)"),
    "valid_shape": ({"valid": torch.empty((1, 5), dtype=torch.bool, device="meta")}, r"valid must be \(2, 5\)"),
    "tiebreak_shape": ({"tiebreak": torch.empty((2, 5, 1), dtype=torch.int64, device="meta")}, r"tiebreak must be \(2, 5\)"),
    "scores_on_cpu": ({"scores": torch.zeros((2, 5))}, "one device"),
    "no_kernel_for_meta": ({}, "no NMS kernel for device meta"),
    "no_kernel_default_tiebreak": ({"tiebreak": None}, "no NMS kernel for device meta"),
}


@pytest.mark.parametrize("case", sorted(WRONG))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    over, match = WRONG[case]
    a = _meta_args(**over)
    before = tracing.COUNTS["nms_calls"]
    with pytest.raises(ValueError, match=match):
        nms.batched_nms(a["boxes"], a["scores"], a["valid"], 0.5, tiebreak=a["tiebreak"])
    assert tracing.COUNTS["nms_calls"] == before


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA GPU (decided when the test
    runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 7, 64, 256, 1024, 1500])
@pytest.mark.parametrize("b", [1, 3, 64])
def test_kernel_equals_the_plain_loop(cuda, b, k, kind):
    """Bit for bit, at each threshold, against the plain version on the card
    (and on the CPU up to 4 M pairs); K=1,500 is past 1,024, the
    validation's K, with a 24-word bitmask row."""
    case = make_case(2, b, k, kind)
    boxes, scores, valid, tb = as_torch(case, "cuda")
    for thr in THRESHOLDS:
        before = dict(tracing.COUNTS)
        got = nms.batched_nms(boxes, scores, valid, thr, tiebreak=tb)
        assert tracing.COUNTS["nms_kernel_launches"] - before.get("nms_kernel_launches", 0) == 1
        assert tracing.COUNTS["nms_calls"] - before.get("nms_calls", 0) == 1
        assert tracing.COUNTS["nms_host_syncs"] == before.get("nms_host_syncs", 0)
        want_card = nms.batched_nms_reference(boxes, scores, valid, thr, tiebreak=tb)
        assert got.dtype == torch.bool and got.shape == (b, k)
        np.testing.assert_array_equal(got.cpu().numpy(), want_card.cpu().numpy(), err_msg=f"thr={thr}")
        if b * k * k <= 4 << 20:
            cb, cs, cv, ct = as_torch(case, "cpu")
            want_cpu = nms.batched_nms(cb, cs, cv, thr, tiebreak=ct)
            np.testing.assert_array_equal(got.cpu().numpy(), want_cpu.numpy(), err_msg=f"thr={thr}")


@pytest.mark.cuda
def test_kernel_default_tiebreak_and_side_stream(cuda):
    """tiebreak=None is the slot index; the launch follows the current stream."""
    case = make_case(3, 4, 256, "clustered")
    boxes, scores, valid, _ = as_torch(case, "cuda")
    want = nms.batched_nms_reference(boxes, scores, valid, 0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = nms.batched_nms(boxes, scores, valid, 0.5)
    side.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_kernel_refuses_mixed_devices_on_the_card(cuda):
    boxes, scores, valid, tb = as_torch(make_case(4, 2, 8, "random"), "cuda")
    with pytest.raises(ValueError, match="one device"):
        nms.batched_nms(boxes, scores.cpu(), valid, 0.5, tiebreak=tb)
    with pytest.raises(ValueError, match="scores must be torch.float32"):
        nms.batched_nms(boxes, scores.double(), valid, 0.5, tiebreak=tb)


@pytest.mark.cuda
def test_launch_refuses_a_scratch_smaller_than_b_workspaces(cuda):
    """The C launcher checks the scratch it is handed against its own
    layout, and launches nothing on a byte less."""
    boxes, scores, valid, tb = as_torch(make_case(4, 3, 100, "random"), "cuda")
    lib = kernels.load("nms")
    need = 3 * nms._workspace_bytes(100)
    out = torch.zeros((3, 100), dtype=torch.bool, device="cuda")
    for size, ok in ((need - 1, False), (need, True)):
        scratch = torch.empty(size, dtype=torch.uint8, device="cuda")
        code = lib.yogo_nms_launch(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), tb.data_ptr(),
                                   0.5, 3, 100, out.data_ptr(), scratch.data_ptr(), size,
                                   torch.cuda.current_stream().cuda_stream)
        assert (code == 0) == ok, (size, code)
    want = nms.batched_nms_reference(boxes, scores, valid, 0.5, tiebreak=tb)
    np.testing.assert_array_equal(out.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_predictor_count_makes_no_sync(cuda):
    """Predictor.count on a CUDA head with a host mask runs clean under
    torch.cuda.set_sync_debug_mode("error"), and counts as the CPU does."""
    from yogo_tpu_torch.infer import Predictor
    from yogo_tpu_torch.models.yogo import YOGO

    model = YOGO.create((96, 128), 0.08, 0.1, 3, model_version="quarter_filters")
    pred_cpu = Predictor(model, model.init(torch.Generator().manual_seed(0), device="cpu"), max_detections=64)
    pred = Predictor(model, model.init(torch.Generator().manual_seed(0), device="cuda"), max_detections=64)
    rng = np.random.default_rng(5)
    raw = torch.from_numpy(rng.normal(0, 2, (4, *model.grid[::-1], 8)).astype(np.float32))
    mask = torch.tensor([True, True, False, True])
    want = pred_cpu.count(raw, mask)
    raw_card = raw.cuda()
    torch.cuda.synchronize()
    before = dict(tracing.COUNTS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pred.count(raw_card, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tracing.COUNTS["nms_kernel_launches"] - before.get("nms_kernel_launches", 0) == 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
