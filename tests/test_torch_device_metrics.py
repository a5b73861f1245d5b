"""The port's device metrics engine against the JAX package's, on the CPU:
the greedy matching, one batch update (every accumulator of the state),
compute(), and the constructed scenes of tests/test_device_metrics.py.
Integer state and integer outputs are compared exactly; the one float
accumulator (the ECE confidence sum) and derived floats at rtol 1e-6, mAP
within 1e-6. (The state computed on the card is held against the CPU's by
chip_smoke.py, on the trained golden checkpoint's predictions.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_device_metrics import CLASSES, SX, SY, make_scene
from tests.test_torch_metrics import assert_results_equal, random_labels, random_preds
from yogo_tpu.metrics import DeviceMetrics as JDeviceMetrics
from yogo_tpu.metrics import Metrics as JMetrics
from yogo_tpu.metrics import device_metrics as jdm
from yogo_tpu.ops.grid import encode_label_grid_np
from yogo_tpu_torch.metrics import DeviceMetrics, Metrics
from yogo_tpu_torch.metrics import device_metrics as dm


def assert_state_equal(got: DeviceMetrics, want: JDeviceMetrics):
    assert sorted(got._state) == sorted(want._state)
    for key, w in want._state.items():
        g, w = got._state[key].numpy(), np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w.astype(np.int64), err_msg=key)


def engines(**kw):
    return DeviceMetrics(CLASSES, device="cpu", **kw), JDeviceMetrics(CLASSES, **kw)


# ------------------------------------------------------------------- matching
def random_iou(seed, b=4, k=9, g=7, ties=False):
    rng = np.random.default_rng(seed)
    iou = rng.random((b, k, g)).astype(np.float32)
    iou[rng.random((b, k, g)) < 0.5] = 0.0  # a zero-IoU remainder to pair up
    if ties:
        iou = np.round(iou * 4) / 4  # many equal maxima: the tie-break decides
    return iou, rng.random((b, k)) < 0.8, rng.random((b, g)) < 0.8


@pytest.mark.parametrize("seed,shape,ties", [
    (0, (9, 7), False), (1, (7, 9), False), (2, (8, 8), True), (3, (1, 5), True), (4, (6, 1), False),
    (5, (12, 12), True), (6, (5, 11), True), (7, (11, 5), True), (8, (16, 3), False), (9, (3, 16), False),
    (10, (9, 7), True), (11, (7, 9), True), (12, (2, 2), True), (13, (10, 10), False), (14, (1, 1), False),
])
def test_greedy_match_equals_jax_pair_for_pair(seed, shape, ties):
    """First-occurrence argmax on ties, index-order pairing of the zero-IoU
    remainder and the min(M, N) cardinality."""
    iou, dv, gv = random_iou(seed, k=shape[0], g=shape[1], ties=ties)
    want_p, want_m = jax.vmap(jdm._greedy_match_one)(jnp.asarray(iou), jnp.asarray(dv), jnp.asarray(gv))
    got_p, got_m = dm.greedy_match(torch.from_numpy(iou), torch.from_numpy(dv), torch.from_numpy(gv))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    matched = (got_p.numpy() >= 0).sum(axis=1)
    np.testing.assert_array_equal(matched, np.minimum(dv.sum(axis=1), gv.sum(axis=1)))


def test_greedy_rounds_past_the_last_pair_change_nothing():
    """The loop may stop at the first round that pairs nothing: a round on
    an image with no positive IoU left is the identity."""
    iou, dv, gv = (torch.from_numpy(a) for a in random_iou(20, k=6, g=6))
    want = dm.greedy_match(iou, dv, gv)
    iou_w, partner, taken = dm._match_state(iou, dv, gv)
    paired = [int(dm._greedy_round(iou_w, partner, taken).sum()) for _ in range(12)]
    assert paired[0] > 0 and paired[6:] == [0] * 6 and paired == sorted(paired, reverse=True)
    got = dm._pair_remainder(partner, taken, dv, gv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_greedy_match_all_zero_iou_pairs_in_index_order():
    iou = torch.zeros(1, 4, 3)
    dv = torch.tensor([[True, False, True, True]])
    gv = torch.tensor([[True, True, False]])
    partner, matched = dm.greedy_match(iou, dv, gv)
    assert partner.tolist() == [[0, -1, 1, -1]] and matched.tolist() == [[True, True, False]]


# --------------------------------------------------------------- batch update
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_state_equals_jax_on_dense_overlapping_predictions(include_background, seed):
    """Random overlapping predictions, where greedy matching has contested
    pairs: three updates, one with padded rows, every accumulator."""
    kw = dict(include_background=include_background, min_class_confidence_threshold=0.5)
    got, want = engines(**kw)
    for k in range(3):
        preds, labels = random_preds(10 * seed + k), random_labels(10 * seed + k)
        mask = np.array([1, 1, 0], np.float32) if k == 1 else None
        got.update(preds, labels, image_mask=mask)
        want.update(preds, labels, image_mask=mask)
    assert_state_equal(got, want)
    assert int(got._state["total_matched"]) > 0 and int(got._state["n_images"]) == 8
    assert_results_equal(got.compute(), want.compute())


@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_clean_scenes_equal_jax_and_the_host_engine(include_background, seed):
    """Where matching is unambiguous (tests/test_device_metrics.py's
    scenes: missed XOR extra per image, unique scores) the device engine,
    the JAX device engine and the host engine agree exactly, mAP too."""
    rng = np.random.default_rng(seed)
    scores = iter(rng.permutation(np.arange(2100, 4090)))
    got, want = engines(include_background=include_background)
    host = Metrics(CLASSES, include_background=include_background)
    for _ in range(2):
        batch = [make_scene(rng, p_missed=0.3 * (k % 2), p_extra=0.3 * (1 - k % 2), score_iter=scores)
                 for k in range(3)]
        preds, labels = np.stack([p for p, _ in batch]), np.stack([l for _, l in batch])
        for m in (got, want, host):
            m.update(preds, labels)
    assert_state_equal(got, want)
    res = got.compute()
    assert_results_equal(res, want.compute(), map_atol=0.0)
    assert_results_equal(res, host.compute(), map_atol=0.0)


def divergence_scene():
    """tests/test_device_metrics.py::test_ambiguous_overlap_invariants: two
    labels nearly on top of each other, two detections straddling both."""
    pred = np.zeros((5 + 3, SY, SX), np.float32)
    rows = [(0, 0.30, 0.30, 0.50, 0.50), (1, 0.32, 0.32, 0.52, 0.52)]
    label = encode_label_grid_np(np.asarray(rows, np.float32), SX, SY)
    for cx, cy, sbin, cls in ((0.38, 0.38, 3000, 0), (0.46, 0.46, 2800, 1)):
        i, j = int(cx * SX), int(cy * SY)
        pred[:4, j, i] = [cx, cy, 0.2, 0.2]
        pred[4, j, i] = sbin / 4096.0
        probs = np.full(3, 10 / 512.0, np.float32)
        probs[cls] = 492 / 512.0
        pred[5:, j, i] = probs
    return pred[None], label[None]


def test_constructed_greedy_vs_hungarian_scene_splits_as_in_jax():
    preds, labels = divergence_scene()
    got, want = engines()
    host, jhost = Metrics(CLASSES), JMetrics(CLASSES)
    for m in (got, want, host, jhost):
        m.update(preds, labels)
    assert_state_equal(got, want)
    d, h = got.compute(), host.compute()
    assert_results_equal(d, want.compute(), map_atol=0.0)
    assert_results_equal(h, jhost.compute(), map_atol=0.0)
    assert int(h[9][0]) == int(d[9][0]) and h[1].sum() == d[1].sum()


def test_empty_scene_mask_and_options_equal_jax():
    got, want = engines()
    zeros = np.zeros((2, 8, SY, SX), np.float32), np.zeros((2, 6, SY, SX), np.float32)
    got.update(*zeros)
    want.update(*zeros)
    assert_state_equal(got, want)
    assert_results_equal(got.compute(), want.compute(), map_atol=0.0)
    # no image at all: the empty mAP result
    g0, w0 = engines()
    assert_results_equal(g0.compute(), w0.compute(), map_atol=0.0)
    g1, w1 = engines(include_mAP=False)
    pred, label = make_scene(np.random.default_rng(11))
    g1.update(pred[None], label[None])
    w1.update(pred[None], label[None])
    assert "map_tp" not in g1._state and g1.compute()[0] == {"map": 0.0}
    assert_state_equal(g1, w1)
    assert_results_equal(g1.forward(pred[None], label[None]), w1.forward(pred[None], label[None]))
    assert int(g1._state["n_images"]) == 0  # forward resets


@pytest.mark.parametrize("kw", [dict(max_labels=2), dict(max_detections=2)])
def test_capacity_overflow_is_counted_and_warned_as_in_jax(kw):
    pred, label = make_scene(np.random.default_rng(3))
    got, want = engines(**kw)
    got.update(pred[None], label[None])
    want.update(pred[None], label[None])
    for key in ("gt_overflow", "det_overflow"):
        assert int(got._state[key]) == int(want._state[key])
    assert int(got._state["gt_overflow"]) + int(got._state["det_overflow"]) == 1
    with pytest.warns(UserWarning, match="capacity overflow"):
        got.compute()


def test_ece_conf_survives_float32_saturation():
    """The (sum, compensation) pair keeps absorbing ~1.0-sized confidences
    past 2^24, as the JAX engine's does."""
    pred, label = make_scene(np.random.default_rng(7))
    dev = DeviceMetrics(CLASSES, device="cpu")
    dev.update(pred[None], label[None])
    base = (dev._state["ece_conf"].double() + dev._state["ece_conf_comp"].double()).numpy()
    assert base.sum() > 0
    big = float(2**25)
    dev2 = DeviceMetrics(CLASSES, device="cpu")
    dev2._state["ece_conf"] = torch.full_like(dev2._state["ece_conf"], big)
    dev2.update(pred[None], label[None])
    total = (dev2._state["ece_conf"].double() + dev2._state["ece_conf_comp"].double()).numpy()
    np.testing.assert_allclose(total - big, base, atol=1e-3)


def test_default_device_is_the_card_and_inputs_follow_the_state():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceMetrics(CLASSES)
    dev = DeviceMetrics(CLASSES, device="cpu")
    pred, label = make_scene(np.random.default_rng(1))
    dev.update(torch.from_numpy(pred[None]).to(torch.bfloat16).float(), torch.from_numpy(label[None]),
               image_mask=torch.ones(1))
    assert all(v.device.type == "cpu" for v in dev._state.values())
    assert int(dev._state["n_images"]) == 1
