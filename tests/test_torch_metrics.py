"""The port's decoded formatter, matching and host metrics engine against
the JAX package's on seeded predictions and label grids. Integer outputs
are compared exactly, floats at rtol 1e-6, mAP within 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_device_metrics import CLASSES, SX, SY, make_scene
from yogo_tpu.metrics import Metrics as JMetrics
from yogo_tpu.metrics import matching as jmatching
from yogo_tpu.metrics.mean_ap import MeanAveragePrecision as JMeanAP
from yogo_tpu.ops import postprocess as jpost
from yogo_tpu.ops.grid import encode_label_grid_np
from yogo_tpu_torch.metrics import Metrics, MeanAveragePrecision, linear_sum_assignment
from yogo_tpu_torch.metrics import matching
from yogo_tpu_torch.metrics.metrics import finish_metrics
from yogo_tpu_torch.ops import postprocess as post

RTOL = 1e-6


def random_preds(seed, b=3, c=3, sy=SY, sx=SX, p_obj=0.25):
    """Decoded predictions with overlapping boxes: objectness > 0.5 in about
    p_obj of the cells, distinct scores, class probabilities that sum to 1."""
    rng = np.random.default_rng(seed)
    preds = np.zeros((b, 5 + c, sy, sx), np.float32)
    preds[:, 0] = rng.uniform(0.1, 0.9, (b, sy, sx))
    preds[:, 1] = rng.uniform(0.1, 0.9, (b, sy, sx))
    preds[:, 2:4] = rng.uniform(0.05, 0.25, (b, 2, sy, sx))
    preds[:, 4] = np.where(rng.random((b, sy, sx)) < p_obj, rng.uniform(0.5, 1, (b, sy, sx)),
                           rng.uniform(0, 0.5, (b, sy, sx)))
    logits = rng.normal(0, 3, (b, c, sy, sx))
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    preds[:, 5:] = e / e.sum(axis=1, keepdims=True)
    return preds


def random_labels(seed, b=3, c=3, sy=SY, sx=SX, n=6):
    rng = np.random.default_rng(seed + 100)
    grids = []
    for _ in range(b):
        lo = rng.uniform(0.05, 0.7, (n, 2))
        wh = rng.uniform(0.08, 0.25, (n, 2))
        rows = np.concatenate([rng.integers(0, c, (n, 1)), lo, lo + wh], axis=1)
        grids.append(encode_label_grid_np(rows.astype(np.float32), sx, sy))
    return np.stack(grids)


def assert_results_equal(got, want, map_atol=1e-6):
    """The 10-tuples of compute(): integers exact, floats rtol 1e-6."""
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_allclose(np.asarray(got[0][k], np.float64), np.asarray(want[0][k], np.float64),
                                   atol=map_atol, err_msg=f"mAP[{k}]")
    for i in (1, 7, 8, 9):
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want[i]))
    for i in (2, 4, 5):
        np.testing.assert_allclose(got[i], want[i], rtol=RTOL)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(got[6], want[6], rtol=RTOL, atol=1e-9)


# ------------------------------------------------------------------ formatter
@pytest.mark.parametrize("kw", [
    dict(),
    dict(obj_thresh=0.3, iou_thresh=0.3),
    dict(iou_thresh=0.0),
    dict(min_class_confidence_threshold=0.9),
    dict(max_detections=0),
    dict(mask=[1, 0, 1]),
])
def test_format_preds_batched_equals_jax_below_capacity(kw):
    kw = dict(kw)
    mask = kw.pop("mask", None)
    preds = random_preds(1)
    mask_np = None if mask is None else np.asarray(mask, np.float32)
    want = jpost.format_preds_batched(
        jnp.asarray(preds), image_mask=None if mask is None else jnp.asarray(mask_np), **kw)
    got = post.format_preds_batched(
        torch.from_numpy(preds), image_mask=None if mask is None else torch.from_numpy(mask_np), **kw)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    if kw.get("max_detections") != 0:  # below capacity: no cut inside the passing cells
        assert (preds[:, 4] > kw.get("obj_thresh", 0.5)).reshape(3, -1).sum(1).max() < valid.shape[1]
    for key in ("boxes_cxcywh", "boxes_xyxy", "objectness", "class_probs"):
        np.testing.assert_allclose(got[key].numpy()[valid], np.asarray(want[key])[valid], rtol=RTOL,
                                   err_msg=key)
    if mask is not None:
        assert not valid[1].any()
    if kw.get("max_detections") == 0:
        assert not valid.any()
    np.testing.assert_array_equal(
        post.count_class_predictions(
            torch.from_numpy(preds), image_mask=None if mask is None else torch.from_numpy(mask_np), **kw
        ).numpy(),
        np.asarray(jpost.count_class_predictions(
            jnp.asarray(preds), image_mask=None if mask is None else jnp.asarray(mask_np), **kw)),
    )


def test_format_preds_batched_at_capacity_keeps_the_top_scores():
    """Past capacity the lowest-objectness survivors go; scores here are
    distinct, so the cut is the same in both packages (which of several
    cells TIED at the cut survive is each framework's own choice)."""
    preds = random_preds(2, p_obj=0.9)
    want = jpost.format_preds_batched(jnp.asarray(preds), iou_thresh=0.0, max_detections=8)
    got = post.format_preds_batched(torch.from_numpy(preds), iou_thresh=0.0, max_detections=8)
    assert got["valid"].all() and got["objectness"].shape == (3, 8)
    np.testing.assert_allclose(got["objectness"].numpy(), np.asarray(want["objectness"]), rtol=RTOL)
    top = np.sort(preds[:, 4].reshape(3, -1), axis=1)[:, ::-1][:, :8]
    np.testing.assert_allclose(got["objectness"].numpy(), top, rtol=RTOL)


# ------------------------------------------------------------------- matching
@pytest.mark.parametrize("shape", [(0, 0), (3, 0), (0, 4), (5, 5), (4, 9), (9, 4)])
def test_linear_sum_assignment_equals_jax(shape):
    cost = np.random.default_rng(sum(shape)).random(shape)
    for fn, jfn in ((linear_sum_assignment, jmatching.linear_sum_assignment),
                    (matching._lsa_fallback, jmatching._lsa_fallback)
                    if hasattr(jmatching, "_lsa_fallback") else (linear_sum_assignment,) * 2):
        r, c = fn(cost)
        jr, jc = jfn(cost)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(c, jc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_preds_and_labels_and_v2_equal_jax(seed):
    preds, labels = random_preds(seed, b=1), random_labels(seed, b=1)
    got = post.format_preds_and_labels_v2(preds[0], labels[0])
    want = jpost.format_preds_and_labels_v2(preds[0], labels[0])
    for field in ("preds", "labels", "missed_labels", "extra_predictions"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=field)
    gb, wb = got.convert_background_errors(4), want.convert_background_errors(4)
    np.testing.assert_array_equal(gb.preds, wb.preds)
    np.testing.assert_array_equal(gb.labels, wb.labels)
    with pytest.raises(ValueError, match="must include the background"):
        got.convert_background_errors(3)
    both = post.PredictionLabelMatch.concat([got, got])
    assert len(both.preds) == 2 * len(got.preds)
    a = np.asarray([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.8]])
    b = np.asarray([[0.2, 0.2, 0.5, 0.5], [0.5, 0.5, 0.9, 0.8]])
    np.testing.assert_array_equal(post._pairwise_iou_xyxy(a, b), jpost._pairwise_iou_xyxy(a, b))
    np.testing.assert_array_equal(post.elementwise_iou_xyxy(a, b), jpost.elementwise_iou_xyxy(a, b))
    with pytest.warns(DeprecationWarning):
        g_old = post.format_preds_and_labels(preds[0], labels[0])
    with pytest.warns(DeprecationWarning):
        w_old = jpost.format_preds_and_labels(preds[0], labels[0])
    for g, w in zip(g_old, w_old):
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------------- metrics
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_metrics_equal_jax_on_dense_overlapping_predictions(include_background, seed):
    """Three updates of random, overlapping predictions (the Hungarian
    assignment has real work), one with padded rows."""
    kw = dict(include_background=include_background, min_class_confidence_threshold=0.5)
    got, want = Metrics(CLASSES, **kw), JMetrics(CLASSES, **kw)
    for k in range(3):
        preds, labels = random_preds(10 * seed + k), random_labels(10 * seed + k)
        mask = np.array([1, 1, 0], np.float32) if k == 1 else None
        want.update(preds, labels, image_mask=mask)
        if k == 2:  # tensors are taken as they are
            got.update(torch.from_numpy(preds), torch.from_numpy(labels), image_mask=mask)
        else:
            got.update(preds, labels, image_mask=mask)
    res = got.compute()
    assert_results_equal(res, want.compute())
    assert int(res[9][0]) > 0 and res[1].sum() > 0
    np.testing.assert_array_equal(got.roc_counts, want.roc_counts)
    np.testing.assert_array_equal(got.ece_counts, want.ece_counts)


def test_host_metrics_equal_jax_on_clean_scenes_and_forward_resets():
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    batch = [make_scene(rng) for _ in range(3)]
    [make_scene(jrng) for _ in range(3)]
    preds, labels = np.stack([p for p, _ in batch]), np.stack([l for _, l in batch])
    got, want = Metrics(CLASSES), JMetrics(CLASSES)
    assert_results_equal(got.forward(preds, labels), want.forward(preds, labels))
    assert got.total_num_true_objects == 0 and got.confusion.sum() == 0
    assert got.class_names == want.class_names == CLASSES + ["background"]
    assert Metrics(CLASSES, include_mAP=False).compute()[0] == {"map": 0.0}


def test_mean_ap_and_finish_metrics_equal_jax():
    rng = np.random.default_rng(3)
    got, want = MeanAveragePrecision(3), JMeanAP(3)
    for _ in range(4):
        n, m, k = rng.integers(1, 9, 3)
        args = (rng.random(n), rng.integers(0, 3, n), rng.integers(0, 3, n), rng.random(n),
                rng.random(m), rng.integers(0, 3, m), rng.integers(0, 3, k))
        got.update(*args)
        want.update(*args)
    g, w = got.compute(), want.compute()
    assert set(g) == set(w)
    for key in w:
        np.testing.assert_allclose(np.asarray(g[key], np.float64), np.asarray(w[key], np.float64),
                                   atol=1e-6, err_msg=key)
    ge, we = MeanAveragePrecision(3).compute(), JMeanAP(3).compute()
    assert set(ge) == set(we)
    for key in we:
        np.testing.assert_array_equal(np.asarray(ge[key]), np.asarray(we[key]), err_msg=key)
    from yogo_tpu.metrics.metrics import finish_metrics as jfinish

    state = dict(
        confusion=rng.integers(0, 9, (3, 3)), roc_counts=rng.integers(0, 9, (3, 500, 4)),
        roc_thresholds=np.linspace(0, 1, 500), ece_counts=rng.integers(0, 9, 30),
        ece_conf=rng.random(30), ece_correct=rng.random(30), mAP={"map": 0.5},
        missed_by_class=rng.integers(0, 9, 3), extra_by_class=rng.integers(0, 9, 3),
        total_true_objects=17,
    )
    assert_results_equal(finish_metrics(**state), jfinish(**state))
