"""The port's windowed NMS count (yogo_tpu_torch/ops/window_nms.py) against
the JAX package's windowed_count and against the port's global count paths
(the decoded device formatter and the host oracle), on the seven cases of
tests/test_window_nms.py and its random grids, and on the card against
the CPU (a `cuda` test). Counts and keep masks are integers and booleans:
held equal. JAX is imported inside the tests that compare with it, so the
card's test runs on a GPU machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_window_nms.py -m cuda
"""

import numpy as np
import pytest
import torch

from yogo_tpu_torch.ops.postprocess import count_class_predictions, format_preds
from yogo_tpu_torch.ops.window_nms import premise_extents, windowed_count

# tests/test_window_nms.py's grid and window
SY, SX, C = 24, 32, 4
RY = RX = 4
IOU_T = 0.5
HMAX, WMAX = premise_extents(RY, RX, SY, SX, IOU_T)


def make_grid(rng, b=2, density=30, hmax=HMAX * 0.999, wmax=WMAX * 0.999):
    """tests/test_window_nms.make_grid, copied so that this module imports
    no JAX: centers inside their cells, bounded extents, overlap clusters
    that force suppression cascades, quantized scores that force ties."""
    pred = rng.uniform(0, 0.3, (b, 5 + C, SY, SX)).astype(np.float32)
    pred[:, 0] = (np.arange(SX)[None, :] + rng.uniform(0.02, 0.98, (b, SY, SX))) / SX
    pred[:, 1] = (np.arange(SY)[:, None] + rng.uniform(0.02, 0.98, (b, SY, SX))) / SY
    pred[:, 2] = rng.uniform(0.2, 0.98, (b, SY, SX)) * wmax
    pred[:, 3] = rng.uniform(0.2, 0.98, (b, SY, SX)) * hmax
    pred[:, 4] = np.round(rng.uniform(0, 0.49, (b, SY, SX)) * 64) / 64
    for bi in range(b):
        for _ in range(density):
            cy0, cx0 = rng.integers(0, SY), rng.integers(0, SX)
            for dy in range(-2, 3):
                for dx in range(-2, 3):
                    y, x = cy0 + dy, cx0 + dx
                    if 0 <= y < SY and 0 <= x < SX and rng.uniform() < 0.6:
                        pred[bi, 4, y, x] = round(rng.uniform(0.51, 0.99) * 64) / 64
    pred[:, 5:] = np.round(rng.uniform(0, 1, (b, C, SY, SX)) * 8) / 8
    return pred


def host_counts(pred, obj_t=0.5, iou_t=IOU_T, conf_t=0.0):
    out = np.zeros(C, np.int64)
    for row in format_preds(pred, obj_thresh=obj_t, iou_thresh=iou_t,
                            min_class_confidence_threshold=conf_t):
        out[int(np.argmax(row[5:]))] += 1
    return out


def both(pred, image_mask=None, **kw):
    """(port's result, JAX's result as numpy), with keep masks and counts
    asserted equal and the exceeded flags the same."""
    from yogo_tpu.ops.window_nms import windowed_count as jax_windowed_count

    got = windowed_count(torch.from_numpy(pred), ry=RY, rx=RX,
                         image_mask=None if image_mask is None else torch.from_numpy(image_mask), **kw)
    want = jax_windowed_count(pred, ry=RY, rx=RX, image_mask=image_mask, **kw)
    np.testing.assert_array_equal(got["keep"].numpy(), np.asarray(want["keep"]))
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(want["counts"]))
    assert bool(got["exceeded"]) == bool(want["exceeded"])
    return got


def one_row_pred():
    pred = np.zeros((1, 5 + C, SY, SX), np.float32)
    return pred


def test_premise_extents_equal_jax_s():
    """The extents, and this module's grid and window, are JAX's test's."""
    import tests.test_window_nms as jt
    from yogo_tpu.ops.window_nms import premise_extents as jax_premise_extents

    assert premise_extents(RY, RX, SY, SX, IOU_T) == jax_premise_extents(RY, RX, SY, SX, IOU_T)
    assert (SY, SX, C, RY, RX, IOU_T, HMAX, WMAX) == (jt.SY, jt.SX, jt.C, jt.RY, jt.RX, jt.IOU_T,
                                                      jt.HMAX, jt.WMAX)
    for b in (1, 3):
        np.testing.assert_array_equal(make_grid(np.random.default_rng(b), b=b),
                                      jt.make_grid(np.random.default_rng(b), b=b))


@pytest.mark.parametrize("seed", range(8))
def test_matches_jax_the_host_oracle_and_the_global_count_path(seed):
    rng = np.random.default_rng(seed)
    conf_t = 0.25 if seed % 2 else 0.0
    pred = make_grid(rng)
    res = both(pred, obj_thresh=0.5, iou_thresh=IOU_T, min_class_confidence_threshold=conf_t)
    assert not bool(res["exceeded"])
    want = sum(host_counts(p, conf_t=conf_t) for p in pred)
    np.testing.assert_array_equal(res["counts"].numpy(), want)
    dev = count_class_predictions(torch.from_numpy(pred), obj_thresh=0.5, iou_thresh=IOU_T,
                                  min_class_confidence_threshold=conf_t, max_detections=SY * SX)
    np.testing.assert_array_equal(dev.numpy(), want)


def test_tie_broken_by_lower_cell_index():
    pred = one_row_pred()
    for x_cell, frac in ((10, 0.9), (11, 0.1)):
        pred[0, 0, 5, x_cell] = (x_cell + frac) / SX
        pred[0, 1, 5, x_cell] = 5.5 / SY
        pred[0, 2, 5, x_cell] = 3.0 / SX
        pred[0, 3, 5, x_cell] = 3.0 / SY
        pred[0, 4, 5, x_cell] = 0.9
        pred[0, 5, 5, x_cell] = 1.0
    keep = both(pred)["keep"][0]
    assert keep[5, 10] and not keep[5, 11]


def test_premise_flag_on_oversize_boxes():
    pred = one_row_pred()
    pred[0, 0, 5, 10] = 10.5 / SX
    pred[0, 1, 5, 10] = 5.5 / SY
    pred[0, 2, 5, 10] = WMAX * 2
    pred[0, 3, 5, 10] = HMAX * 0.5
    pred[0, 4, 5, 10] = 0.9
    pred[0, 5, 5, 10] = 1.0
    assert bool(both(pred)["exceeded"])
    pred[0, 4, 5, 10] = 0.3
    assert not bool(both(pred)["exceeded"])


def test_iou_zero_disables_suppression():
    pred = make_grid(np.random.default_rng(7), b=1)
    res = both(pred, obj_thresh=0.5, iou_thresh=0.0)
    np.testing.assert_array_equal(res["counts"].numpy(), host_counts(pred[0], iou_t=0.0))
    assert int(res["keep"].sum()) == int((pred[0, 4] > 0.5).sum())


def test_image_mask_excludes_padding_images():
    pred = make_grid(np.random.default_rng(11), b=3)
    res = both(pred, image_mask=np.array([True, True, False]))
    np.testing.assert_array_equal(res["counts"].numpy(), sum(host_counts(p) for p in pred[:2]))


def test_nan_scores_rank_last():
    pred = one_row_pred()
    for x_cell in (10, 11):
        pred[0, 0, 5, x_cell] = (x_cell + (0.9 if x_cell == 10 else 0.1)) / SX
        pred[0, 1, 5, x_cell] = 5.5 / SY
        pred[0, 2, 5, x_cell] = 3.0 / SX
        pred[0, 3, 5, x_cell] = 3.0 / SY
        pred[0, 4, 5, x_cell] = 0.9
        pred[0, 5, 5, x_cell] = np.nan if x_cell == 10 else 1.0
    keep = both(pred)["keep"][0]
    assert keep[5, 11] and not keep[5, 10]


def test_long_suppression_chain_converges_to_greedy():
    pred = one_row_pred()
    n = 10
    for i in range(n):
        pred[0, 0, 5, 5 + i] = (5 + i + 0.5) / SX
        pred[0, 1, 5, 5 + i] = 5.5 / SY
        pred[0, 2, 5, 5 + i] = 3.2 / SX
        pred[0, 3, 5, 5 + i] = 3.2 / SY
        pred[0, 4, 5, 5 + i] = 0.9
        pred[0, 5, 5, 5 + i] = (n - i) / n
    keep = both(pred)["keep"][0, 5, 5 : 5 + n]
    assert int(keep.sum()) == len(format_preds(pred[0], obj_thresh=0.5, iou_thresh=IOU_T))
    assert keep.tolist() == [True, False] * (n // 2)


def test_shift_beyond_the_grid_fills():
    """A window wider than the grid (radius >= Sx) reads only fill: the
    result still equals JAX's on a 3x4 grid."""
    from yogo_tpu.ops.window_nms import windowed_count as jax_windowed_count

    rng = np.random.default_rng(2)
    pred = rng.uniform(0, 1, (2, 5 + C, 3, 4)).astype(np.float32)
    pred[:, 2:4] *= 0.3
    got = windowed_count(torch.from_numpy(pred), ry=4, rx=5)
    want = jax_windowed_count(pred, ry=4, rx=5)
    np.testing.assert_array_equal(got["keep"].numpy(), np.asarray(want["keep"]))
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(want["counts"]))


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA GPU (decided when the test
    runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_on_the_card_equals_the_cpu_and_the_count_path(cuda, seed):
    """windowed_count on CUDA tensors: the keep mask and counts equal the
    CPU's, and the counts equal the decoded count path's on the card."""
    pred = make_grid(np.random.default_rng(seed))
    cpu = windowed_count(torch.from_numpy(pred), ry=RY, rx=RX, obj_thresh=0.5, iou_thresh=IOU_T)
    x = torch.from_numpy(pred).cuda()
    got = windowed_count(x, ry=RY, rx=RX, obj_thresh=0.5, iou_thresh=IOU_T)
    assert got["keep"].is_cuda and not bool(got["exceeded"])
    np.testing.assert_array_equal(got["keep"].cpu().numpy(), cpu["keep"].numpy())
    np.testing.assert_array_equal(got["counts"].cpu().numpy(), cpu["counts"].numpy())
    dev = count_class_predictions(x, obj_thresh=0.5, iou_thresh=IOU_T, max_detections=SY * SX)
    np.testing.assert_array_equal(got["counts"].cpu().numpy(), dev.cpu().numpy())
