"""The port's box geometry, CIoU loss and label-grid encoders against the
JAX package's on the CPU, same seeded inputs. float32 throughout; values
at rtol 1e-5 / atol 1e-6 (the two frameworks order a few float32 sums and
evaluate atan differently), gradients at rtol 1e-4 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yogo_tpu.ops import boxes as jboxes
from yogo_tpu.ops.grid import encode_label_grid_np as jax_encode_np
from yogo_tpu_torch.ops import boxes
from yogo_tpu_torch.ops.grid import encode_label_grid_np

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _xyxy(rng, shape):
    """Random well-formed xyxy boxes inside the unit square."""
    lo = rng.uniform(0.0, 0.6, shape + (2,))
    wh = rng.uniform(0.02, 0.4, shape + (2,))
    return np.concatenate([lo, lo + wh], axis=-1).astype(np.float32)


def test_conversions_round_trip_and_match_jax():
    b = _xyxy(np.random.default_rng(0), (5, 7))
    c = boxes.box_xyxy_to_cxcywh(torch.from_numpy(b))
    np.testing.assert_allclose(c.numpy(), np.asarray(jboxes.box_xyxy_to_cxcywh(jnp.asarray(b))), **VAL)
    back = boxes.box_cxcywh_to_xyxy(c)
    np.testing.assert_allclose(back.numpy(), b, rtol=1e-6, atol=1e-6)


def test_elementwise_iou_matches_jax_and_broadcasts():
    rng = np.random.default_rng(1)
    a, b = _xyxy(rng, (4, 6)), _xyxy(rng, (6,))
    got = boxes.elementwise_box_iou(torch.from_numpy(a), torch.from_numpy(b))
    want = jboxes.elementwise_box_iou(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    same = boxes.elementwise_box_iou(torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(same.numpy(), 1.0, rtol=1e-4)  # eps sits in the union


def _ciou_value_and_grad(pred, target, weights):
    jv, jg = jax.value_and_grad(
        lambda p: jnp.sum(jboxes.complete_box_iou_loss(p, jnp.asarray(target)) * weights)
    )(jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    tv = (boxes.complete_box_iou_loss(tp, torch.from_numpy(target)) * torch.from_numpy(weights)).sum()
    tv.backward()
    return float(jv), np.asarray(jg), float(tv.detach()), tp.grad.numpy()


def test_ciou_value_and_gradient_match_jax():
    rng = np.random.default_rng(2)
    pred, target = _xyxy(rng, (3, 5, 6)), _xyxy(rng, (3, 5, 6))
    weights = rng.uniform(0.5, 1.5, (3, 5, 6)).astype(np.float32)
    elem = boxes.complete_box_iou_loss(torch.from_numpy(pred), torch.from_numpy(target))
    want = jboxes.complete_box_iou_loss(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(elem.numpy(), np.asarray(want), **VAL)
    jv, jg, tv, tg = _ciou_value_and_grad(pred, target, weights)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, **GRAD)


def test_ciou_masked_zero_boxes_stay_finite_in_value_and_gradient():
    """All-zero boxes (masked label slots, or a collapsed prediction) have
    h == 0: the guard must keep both the value and the gradient finite, so
    that mask * loss is an exact zero and not 0 * nan."""
    rng = np.random.default_rng(3)
    pred, target = _xyxy(rng, (8,)), _xyxy(rng, (8,))
    target[::2] = 0.0
    pred[1] = 0.0
    pred[2] = [0.3, 0.4, 0.5, 0.4]  # zero height only
    weights = np.ones(8, np.float32)
    weights[::2] = 0.0
    jv, jg, tv, tg = _ciou_value_and_grad(pred, target, weights)
    assert np.isfinite(tv) and np.isfinite(tg).all()
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, **GRAD)
    assert (tg[::2] == 0).all()


def test_ciou_alpha_is_a_constant_of_the_gradient():
    """d/dpred differs from the gradient with alpha attached: alpha is
    detached, as torchvision and the JAX package have it."""
    rng = np.random.default_rng(4)
    pred, target = _xyxy(rng, (16,)), _xyxy(rng, (16,))

    def attached(p, t, eps=1e-7):
        iou = boxes.elementwise_box_iou(p, t)
        w, h = p[..., 2] - p[..., 0], p[..., 3] - p[..., 1]
        wg, hg = t[..., 2] - t[..., 0], t[..., 3] - t[..., 1]
        v = (4 / np.pi**2) * (torch.atan(wg / hg) - torch.atan(w / h)) ** 2
        return v / (1 - iou + v + eps) * v

    tp = torch.tensor(pred, requires_grad=True)
    full = boxes.complete_box_iou_loss(tp, torch.from_numpy(target)).sum()
    (g_detached,) = torch.autograd.grad(full, tp)
    tp2 = torch.tensor(pred, requires_grad=True)
    t = torch.from_numpy(target)
    with_alpha = boxes.complete_box_iou_loss(tp2, t).sum()
    # swap the detached alpha*v for the attached one
    alpha_v = attached(tp2, t).sum() - attached(tp2.detach(), t).sum()
    (g_attached,) = torch.autograd.grad(with_alpha + alpha_v, tp2)
    assert not np.allclose(g_detached.numpy(), g_attached.numpy(), rtol=1e-3, atol=1e-6)


def _labels(rng, n, n_pad=0, n_outside=0):
    cls = rng.integers(0, 4, n).astype(np.float32)
    rows = np.concatenate([cls[:, None], _xyxy(rng, (n,))], axis=1)
    pad = np.full((n_pad, 5), -1.0, np.float32)
    outside = np.tile(np.array([[1.0, 0.9, 0.9, 1.3, 1.2]], np.float32), (n_outside, 1))
    if n_outside > 1:
        outside[1] = [2.0, -0.5, 0.1, 0.1, 0.3]  # centre left of the image
    return np.concatenate([rows, pad, outside]).astype(np.float32)


@pytest.mark.parametrize("sx,sy", [(16, 12), (129, 97)])
def test_device_encoder_matches_jax_and_drops_padding_and_outside(sx, sy):
    rng = np.random.default_rng(5)
    lab = _labels(rng, 12, n_pad=4, n_outside=2)
    # one box per cell (which of two stays is unspecified on the device)
    cells = rng.choice(sx * sy, 12, replace=False)
    cx, cy = (cells % sx + 0.5) / sx, (cells // sx + 0.5) / sy
    lab[:12, 1:] = np.stack([cx - 0.03, cy - 0.02, cx + 0.03, cy + 0.02], axis=1)
    got = boxes.encode_label_grid(torch.from_numpy(lab), sx, sy).numpy()
    want = np.asarray(jboxes.encode_label_grid(jnp.asarray(lab), sx, sy))
    host = encode_label_grid_np(lab, sx, sy)
    assert got.shape == (6, sy, sx)
    assert int(host[0].sum()) == 12
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    empty = boxes.encode_label_grid(torch.zeros((0, 5)), sx, sy)
    assert empty.shape == (6, sy, sx) and not empty.any()
    only_pad = boxes.encode_label_grid(torch.full((3, 5), -1.0), sx, sy)
    assert not only_pad.any()


def test_host_encoder_is_last_write_wins_and_equals_jax_package():
    rng = np.random.default_rng(6)
    lab = _labels(rng, 30, n_pad=3, n_outside=2)
    # two boxes in one cell: the later row must stay
    lab[7, 1:] = lab[2, 1:] + 1e-3
    lab[7, 0] = 3.0
    lab[2, 0] = 0.0
    got = encode_label_grid_np(lab, 8, 6)
    np.testing.assert_array_equal(got, jax_encode_np(lab, 8, 6))
    i = int((lab[2, 1] + lab[2, 3]) * 8 // 2)
    j = int((lab[2, 2] + lab[2, 4]) * 6 // 2)
    later = [r for r in lab[:30] if int((r[1] + r[3]) * 8 // 2) == i and int((r[2] + r[4]) * 6 // 2) == j][-1]
    assert got[5, j, i] == later[0]
    np.testing.assert_array_equal(got[1:5, j, i], later[1:])
    assert encode_label_grid_np(np.zeros((0, 5), np.float32), 8, 6).sum() == 0
