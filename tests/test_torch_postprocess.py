"""The port's postprocess against the JAX package's on seeded raw heads:
detection sets and per-class counts must be EQUAL (integers and validity
decisions, boxes at 1e-6), including tied scores, NaN scores and masked
images; the batched fixed-point NMS must equal the host greedy oracle on
fuzz cases like tests/test_fuzz.py's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yogo_tpu.ops import postprocess as jpost
from yogo_tpu.ops.nms import batched_nms as jax_batched_nms
from yogo_tpu_torch.ops import nms as tnms
from yogo_tpu_torch.ops import postprocess as tpost
from yogo_tpu_torch.ops.boxes import box_area, box_cxcywh_to_xyxy, box_iou
from yogo_tpu_torch.utils.tracing import COUNTS

ANCHORS = dict(anchor_w=0.2, anchor_h=0.25, width_multiplier=1.0, height_multiplier=1.3)


def _raw_head(seed: int, b=4, sy=12, sx=16, c=2, nan_cls=False):
    """Seeded NHWC raw head with quantized logits (many exact score ties)
    and boxes large enough to overlap their neighbours."""
    rng = np.random.default_rng(seed)
    raw = np.empty((b, sy, sx, 5 + c), np.float32)
    raw[..., :2] = rng.standard_normal((b, sy, sx, 2))
    raw[..., 2:4] = 0.5 * rng.standard_normal((b, sy, sx, 2))
    raw[..., 4] = rng.integers(-6, 5, (b, sy, sx)) * 0.5
    raw[..., 5:] = rng.integers(-3, 4, (b, sy, sx, c)) * 0.5
    if nan_cls:
        raw[..., 5][rng.random((b, sy, sx)) < 0.1] = np.nan
    return raw


def _valid_rows(out, b):
    """Per image, the valid detections as rows sorted for comparison."""
    rows = []
    for i in range(b):
        v = np.asarray(out["valid"][i], bool)
        r = np.concatenate(
            [np.asarray(out["boxes_cxcywh"][i], np.float32)[v],
             np.asarray(out["objectness"][i], np.float32)[v, None],
             np.asarray(out["class_probs"][i], np.float32)[v]], axis=1)
        rows.append(r[np.lexsort(r[:, :2].T[::-1])])
    return rows


CASES = [
    # (seed, dtype, masked image, NaN class logits, iou, min class conf, max_det)
    (0, "float32", False, False, 0.5, 0.0, 256),
    (1, "float32", True, False, 0.5, 0.0, 256),
    (2, "bfloat16", True, False, 0.5, 0.0, 256),
    (3, "float32", False, True, 0.5, 0.0, 256),
    (4, "float32", True, False, 0.25, 0.6, 256),
    (5, "float32", False, False, 0.0, 0.0, 256),
    (6, "bfloat16", False, False, 0.5, 0.0, 1024),
    (7, "float32", True, True, 0.5, 0.55, 128),
]


@pytest.mark.parametrize("seed,dtype,masked,nan_cls,iou,min_conf,max_det", CASES)
def test_format_and_count_equal_jax(seed, dtype, masked, nan_cls, iou, min_conf, max_det):
    raw = _raw_head(seed, nan_cls=nan_cls)
    b = raw.shape[0]
    mask = np.ones(b, bool)
    if masked:
        mask[1] = False
    kw = dict(ANCHORS, obj_thresh=0.5, iou_thresh=iou,
              min_class_confidence_threshold=min_conf, max_detections=max_det)
    jraw = jnp.asarray(raw, getattr(jnp, dtype))
    traw = torch.from_numpy(raw).to(getattr(torch, dtype))

    want = jpost.format_preds_batched_raw(jraw, image_mask=jnp.asarray(mask), **kw)
    got = tpost.format_preds_batched_raw(traw, image_mask=torch.from_numpy(mask), **kw)
    want_rows, got_rows = _valid_rows(want, b), _valid_rows(got, b)
    assert [len(r) for r in got_rows] == [len(r) for r in want_rows]
    assert sum(len(r) for r in got_rows) > 0
    if masked:
        assert len(got_rows[1]) == 0
    for g, w in zip(got_rows, want_rows):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)

    want_counts = np.asarray(
        jpost.count_class_predictions_raw(jraw, image_mask=jnp.asarray(mask), **kw))
    got_counts = tpost.count_class_predictions_raw(traw, image_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)


def test_capacity_cut_inside_a_tie_keeps_a_true_top_k():
    """With more passing cells than K and ties at the K-th key, torch.topk
    and the JAX package's approx_max_k may keep different cells of the tie
    (the order of tied keys is implementation-defined in both). What both
    guarantee, and what is pinned here: the K kept keys are the K largest,
    as a multiset equal to JAX's."""
    raw = _raw_head(7)
    k = 64
    kw = dict(ANCHORS, iou_thresh=0.0, max_detections=k)
    got = tpost.format_preds_batched_raw(torch.from_numpy(raw), **kw)
    want = jpost.format_preds_batched_raw(jnp.asarray(raw), **kw)
    obj = 1 / (1 + np.exp(-raw[..., 4].reshape(raw.shape[0], -1).astype(np.float64)))
    n_cut_in_tie = 0
    for i in range(raw.shape[0]):
        gv, wv = got["valid"][i].numpy(), np.asarray(want["valid"][i])
        g = np.sort(got["objectness"][i].numpy()[gv])[::-1]
        np.testing.assert_allclose(g, np.sort(np.asarray(want["objectness"][i])[wv])[::-1], rtol=1e-6)
        top = np.sort(obj[i][obj[i] > 0.5])[::-1]
        np.testing.assert_allclose(g, top[:k], rtol=1e-6)
        n_cut_in_tie += int(len(top) > k and top[k - 1] == top[k])
    assert n_cut_in_tie > 0  # the case this test exists for


def test_counts_equal_host_formatter_on_decoded_preds():
    """The device count equals format_preds + argmax on the decoded grid
    (both the port's functions), and format_preds equals the JAX copy."""
    raw = _raw_head(11)
    traw = torch.from_numpy(raw)
    b, sy, sx, _ = raw.shape
    cx = (torch.sigmoid(traw[..., 0]) + torch.arange(sx)) / sx
    cy = (torch.sigmoid(traw[..., 1]) + torch.arange(sy)[:, None]) / sy
    w = ANCHORS["anchor_w"] * torch.exp(traw[..., 2]) * ANCHORS["width_multiplier"]
    h = ANCHORS["anchor_h"] * torch.exp(traw[..., 3]) * ANCHORS["height_multiplier"]
    dec = torch.cat([torch.stack([cx, cy, w, h, torch.sigmoid(traw[..., 4])], -1),
                     torch.softmax(traw[..., 5:], -1)], -1).permute(0, 3, 1, 2).numpy()
    host = np.zeros(2, np.int64)
    for p in dec:
        rows = tpost.format_preds(p)
        np.testing.assert_array_equal(rows, jpost.format_preds(p))
        np.add.at(host, rows[:, 5:].argmax(axis=1), 1)
    dev = tpost.count_class_predictions_raw(traw, **ANCHORS, max_detections=1024)
    np.testing.assert_array_equal(dev.numpy(), host)


def _quantized_scores(rng, n):
    return rng.integers(1, 21, n) / 20.0  # heavy duplication: stable tie-breaks


@pytest.mark.parametrize("seed", range(30))
def test_fuzz_batched_nms_vs_host_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    B = int(rng.integers(1, 4))
    K = int(rng.integers(4, 65))
    iou_thresh = [0.25, 0.5][int(rng.integers(0, 2))]
    s = 1.0 / 64.0
    x0 = rng.integers(0, 48, (B, K, 2))
    wh = rng.integers(0, 17, (B, K, 2))
    boxes = np.concatenate([x0 * s, (x0 + wh) * s], axis=-1).astype(np.float32)
    scores = _quantized_scores(rng, (B, K)).astype(np.float32)
    valid = rng.random((B, K)) < 0.8
    if B > 1:
        valid[0] = False

    before = dict(COUNTS)
    keep = tnms.batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), iou_thresh
    ).numpy()
    calls, rounds, syncs = (COUNTS[k] - before.get(k, 0) for k in ("nms_calls", "nms_rounds", "nms_host_syncs"))
    np.testing.assert_array_equal(
        keep, np.asarray(jax_batched_nms(boxes, scores, valid, iou_thresh), bool))
    for b in range(B):
        v_idx = np.flatnonzero(valid[b])
        want = np.zeros(K, bool)
        if len(v_idx):
            kept = tnms.nms_numpy(boxes[b, v_idx], scores[b, v_idx], iou_thresh)
            want[v_idx[kept]] = True
        np.testing.assert_array_equal(keep[b], want, err_msg=f"seed={seed} img={b}")
        single = tnms.nms_fixed(torch.from_numpy(boxes[b]), torch.from_numpy(scores[b]),
                                torch.from_numpy(valid[b]), iou_thresh)
        np.testing.assert_array_equal(single.numpy(), want)
    assert calls == 1 and 1 <= rounds <= K + 2 and syncs >= 1


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_nms_nan_scores_match_oracle(seed):
    rng = np.random.default_rng(5000 + seed)
    K = 24
    s = 1.0 / 64.0
    x0 = rng.integers(0, 20, (K, 2))
    wh = rng.integers(4, 20, (K, 2))
    boxes = np.concatenate([x0 * s, (x0 + wh) * s], axis=-1).astype(np.float32)
    scores = _quantized_scores(rng, K).astype(np.float32)
    scores[rng.random(K) < 0.3] = np.nan
    keep = tnms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.ones(K, dtype=torch.bool), 0.5).numpy()
    want = np.zeros(K, bool)
    want[tnms.nms_numpy(boxes, scores, 0.5)] = True
    np.testing.assert_array_equal(keep, want, err_msg=f"seed={seed}")


def test_nms_exp_huge_boxes_still_suppress():
    big = 4e33
    boxes = torch.tensor([[0.0, 0.0, big, big], [0.1, 0.1, big, big], [0.2, 0.2, 0.4, 0.4]])
    keep = tnms.nms_fixed(boxes, torch.tensor([0.9, 0.8, 0.7]), torch.ones(3, dtype=torch.bool), 0.5)
    assert keep.tolist() == [True, False, True]


def test_nms_tiebreak_by_given_index():
    """Equal scores: the lower tiebreak value wins, whatever the slot order."""
    boxes = torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0]])
    scores = torch.tensor([0.5, 0.5])
    valid = torch.ones(2, dtype=torch.bool)
    assert tnms.nms_fixed(boxes, scores, valid, 0.5).tolist() == [True, False]
    tb = torch.tensor([7, 3])
    assert tnms.nms_fixed(boxes, scores, valid, 0.5, tiebreak=tb).tolist() == [False, True]


def test_boxes_match_jax():
    from yogo_tpu.ops import boxes as jboxes

    rng = np.random.default_rng(9)
    cxcywh = rng.uniform(0.1, 0.9, (5, 4)).astype(np.float32)
    xyxy = box_cxcywh_to_xyxy(torch.from_numpy(cxcywh))
    np.testing.assert_allclose(
        xyxy.numpy(), np.asarray(jboxes.box_cxcywh_to_xyxy(cxcywh)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        box_area(xyxy).numpy(), np.asarray(jboxes.box_area(np.asarray(xyxy))), rtol=1e-6)
    other = xyxy[:3] + 0.05
    np.testing.assert_allclose(
        box_iou(xyxy, other).numpy(),
        np.asarray(jboxes.box_iou(np.asarray(xyxy), np.asarray(other))), rtol=1e-5, atol=1e-7)
