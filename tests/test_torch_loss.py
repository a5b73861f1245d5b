"""The port's yogo_loss against the JAX package's on the CPU: the same
seeded predictions and label grids through both, float32. The total and its
three components agree at rtol 1e-5, the gradient with respect to the
predictions at rtol 1e-4 / atol 1e-6 (same formulas; float32 sums over the
grid are ordered differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yogo_tpu.losses import smoothed_cross_entropy as jax_sce
from yogo_tpu.losses import yogo_loss as jax_yogo_loss
from yogo_tpu_torch.losses import smoothed_cross_entropy, yogo_loss

B, C, SY, SX = 4, 3, 12, 16
KW = dict(no_obj_weight=0.5, iou_weight=5.0, classify_weight=1.0, label_smoothing=0.01)


def make_preds_labels(seed=0, b=B, c=C, sy=SY, sx=SX, n_obj=9):
    """Decoded-looking predictions (centres and sizes inside the image,
    objectness in (0, 1), class logits) and a label grid with n_obj boxes
    an image."""
    rng = np.random.default_rng(seed)
    preds = rng.standard_normal((b, 5 + c, sy, sx)).astype(np.float32)
    preds[:, :2] = rng.uniform(0.05, 0.95, (b, 2, sy, sx))
    preds[:, 2:4] = rng.uniform(0.02, 0.3, (b, 2, sy, sx))
    preds[:, 4] = rng.uniform(0.01, 0.99, (b, sy, sx))
    labels = np.zeros((b, 6, sy, sx), np.float32)
    for i in range(b):
        for cell in rng.choice(sy * sx, n_obj, replace=False):
            jj, ii = divmod(int(cell), sx)
            cx, cy = (ii + rng.uniform(0.1, 0.9)) / sx, (jj + rng.uniform(0.1, 0.9)) / sy
            bw, bh = rng.uniform(0.05, 0.2, 2)
            labels[i, :, jj, ii] = [1, cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2,
                                    rng.integers(0, c)]
    return preds, labels


def both(preds, labels, image_mask=None, **kw):
    """(jax total, comps, grad), (torch total, comps, grad)."""
    jmask = None if image_mask is None else jnp.asarray(image_mask)
    (jv, jc), jg = jax.value_and_grad(
        lambda p: jax_yogo_loss(p, jnp.asarray(labels), image_mask=jmask, **kw), has_aux=True
    )(jnp.asarray(preds))
    tp = torch.tensor(preds, requires_grad=True)
    tmask = None if image_mask is None else torch.from_numpy(image_mask)
    tv, tc = yogo_loss(tp, torch.from_numpy(labels), image_mask=tmask, **kw)
    tv.backward()
    return (
        (float(jv), {k: float(v) for k, v in jc.items()}, np.asarray(jg)),
        (float(tv.detach()), {k: float(v.detach()) for k, v in tc.items()}, tp.grad.numpy()),
    )


def assert_same(jax_side, torch_side):
    (jv, jc, jg), (tv, tc, tg) = jax_side, torch_side
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    assert sorted(tc) == sorted(jc) == ["classification_loss", "iou_loss", "objectness_loss"]
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tv, sum(tc.values()), rtol=1e-6)
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.01, 0.3])
def test_smoothed_cross_entropy_matches_jax_and_torch_ce(smoothing):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((5, 7, 4))).astype(np.float32)
    targets = rng.integers(0, 4, (5, 7))
    got = smoothed_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), smoothing)
    want = jax_sce(jnp.asarray(logits), jnp.asarray(targets), smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    ce = F.cross_entropy(
        torch.from_numpy(logits).movedim(-1, 1), torch.from_numpy(targets),
        reduction="none", label_smoothing=smoothing,
    )
    np.testing.assert_allclose(got.numpy(), ce.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [KW, dict(no_obj_weight=0.2, iou_weight=2.0,
                                         classify_weight=0.5, label_smoothing=0.0)])
def test_value_components_and_gradient_match_jax(kw):
    preds, labels = make_preds_labels(1)
    assert_same(*both(preds, labels, **kw))


@pytest.mark.parametrize("mask", [[1, 1, 1, 1], [1, 0, 1, 0], [0, 0, 0, 1], [0, 0, 0, 0]])
def test_image_mask_matches_jax_and_excludes_padding(mask):
    preds, labels = make_preds_labels(2)
    mask = np.asarray(mask, np.float32)
    jax_side, torch_side = both(preds, labels, mask, **KW)
    assert_same(jax_side, torch_side)
    # masked images get no gradient at all, and garbage in them changes nothing
    assert (torch_side[2][mask == 0] == 0).all()
    if mask.sum():
        keep = mask > 0
        (_, _, _), (tv_sub, _, _) = both(preds[keep], labels[keep], **KW)
        np.testing.assert_allclose(torch_side[0], tv_sub, rtol=1e-5)
    else:
        assert torch_side[0] == 0.0  # normaliser is max(0, 1), not 0


def test_degenerate_predictions_are_excluded_and_nothing_leaks_nan():
    """Object cells whose predicted box has zero width or height drop out
    of the IoU term (nondegenerate mask), and the safe target keeps CIoU
    finite where the mask is zero."""
    preds, labels = make_preds_labels(3)
    obj = np.argwhere(labels[:, 0] > 0)
    for b, j, i in obj[:6]:
        preds[b, 2, j, i] = 0.0  # zero width
    for b, j, i in obj[6:10]:
        preds[b, 3, j, i] = 0.0  # zero height
    jax_side, torch_side = both(preds, labels, **KW)
    assert_same(jax_side, torch_side)
    untouched = make_preds_labels(3)[0]
    _, torch_full = both(untouched, labels, **KW)
    assert torch_side[1]["iou_loss"] < torch_full[1]["iou_loss"]
    for b, j, i in obj[:10]:
        assert (torch_side[2][b, :4, j, i] == 0).all()


def test_empty_label_grid_gives_objectness_only():
    preds, labels = make_preds_labels(4, n_obj=0)
    jax_side, torch_side = both(preds, labels, **KW)
    assert_same(jax_side, torch_side)
    assert torch_side[1]["iou_loss"] == 0.0 and torch_side[1]["classification_loss"] == 0.0


def test_bf16_predictions_are_taken_to_float32():
    preds, labels = make_preds_labels(5)
    p16 = torch.from_numpy(preds).to(torch.bfloat16)
    got, comps = yogo_loss(p16, torch.from_numpy(labels), **KW)
    want, _ = yogo_loss(p16.float(), torch.from_numpy(labels), **KW)
    assert got.dtype == torch.float32 and all(v.dtype == torch.float32 for v in comps.values())
    assert float(got) == float(want)
    jwant, _ = jax_yogo_loss(jnp.asarray(p16.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(labels), **KW)
    np.testing.assert_allclose(float(got), float(jwant), rtol=1e-5)
