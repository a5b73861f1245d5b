"""YOGO detection loss (port of yogo_tpu/losses.py).

Every term is computed over the full (B, Sy, Sx) grid and weighted by the
object mask, so shapes are static and no boolean gather runs on the device
(reference: yogo/yogo_loss.py:38-129 gathers; same values and gradients).
Each term is summed over the batch and divided by the batch size (the
global batch's real-image count in a data-parallel step):
  1. iou_weight * CIoU(clamp(pred_xyxy, 0, 1), label_xyxy) on object cells,
     skipping degenerate zero-width/height predicted boxes,
  2. classify_weight * masked cross-entropy with label smoothing,
  3. MSE(objectness, mask) weighted mask*(1-no_obj_weight) + no_obj_weight.
Everything is float32 whatever dtype the predictions arrive in.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from yogo_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, complete_box_iou_loss


def smoothed_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, label_smoothing: float
) -> torch.Tensor:
    """Per-element CE over the last axis with label smoothing, as
    nn.CrossEntropyLoss(reduction='none'): the target distribution is
    (1-eps)*onehot + eps/C."""
    log_probs = F.log_softmax(logits, dim=-1)
    one_hot = F.one_hot(targets, logits.shape[-1]).to(log_probs.dtype)
    nll = -(log_probs * one_hot).sum(dim=-1)
    if label_smoothing == 0.0:
        return nll
    uniform = -log_probs.mean(dim=-1)
    return (1.0 - label_smoothing) * nll + label_smoothing * uniform


def yogo_loss(
    preds: torch.Tensor,
    labels: torch.Tensor,
    no_obj_weight: float = 0.5,
    iou_weight: float = 5.0,
    classify_weight: float = 1.0,
    label_smoothing: float = 0.01,
    image_mask: Optional[torch.Tensor] = None,
    n_images: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """preds: (B, 5+C, Sy, Sx) decoded predictions (class logits);
    labels: (B, 6, Sy, Sx) [mask, x1, y1, x2, y2, class];
    image_mask: optional (B,) 0/1 validity for padded batches - padded
    images contribute nothing and the normaliser is max(real images, 1).
    n_images: the real-image count to divide by instead of this batch's -
    a rank of a data-parallel step passes the global batch's, so the sum of
    the ranks' losses (and gradients) is the global batch's.
    Returns (total loss, components dict of f32 scalars)."""
    preds = preds.float()
    labels = labels.float()

    if image_mask is None:
        batch_size = float(preds.shape[0])
        img_w = preds.new_ones((preds.shape[0], 1, 1))
    else:
        image_mask = image_mask.float()
        batch_size = torch.clamp(image_mask.sum(), min=1.0)
        img_w = image_mask[:, None, None]
    if n_images is not None:
        batch_size = torch.clamp(n_images.float(), min=1.0)

    mask = labels[:, 0] * img_w  # (B, Sy, Sx)

    # ---- IoU term: full grid, masked
    pred_xyxy = box_cxcywh_to_xyxy(preds[:, :4].movedim(1, -1))  # (B, Sy, Sx, 4)
    # degenerate (zero w or h) predicted boxes are excluded
    # (reference: yogo/yogo_loss.py:84-90)
    nondegenerate = (pred_xyxy[..., 0] != pred_xyxy[..., 2]) & (
        pred_xyxy[..., 1] != pred_xyxy[..., 3]
    )
    iou_mask = mask * nondegenerate.float()

    label_xyxy = labels[:, 1:5].movedim(1, -1)
    # masked cells get a safe unit box so no NaN can leak through 0 * nan
    safe_target = torch.where(
        iou_mask[..., None] > 0, label_xyxy, label_xyxy.new_tensor([0.0, 0.0, 1.0, 1.0])
    )
    ciou = complete_box_iou_loss(torch.clamp(pred_xyxy, 0.0, 1.0), safe_target)
    iou_loss = iou_weight * (ciou * iou_mask).sum() / batch_size

    # ---- classification term
    logits = preds[:, 5:].movedim(1, -1)  # (B, Sy, Sx, C)
    targets = labels[:, 5].long()
    ce = smoothed_cross_entropy(logits, targets, label_smoothing)
    classification_loss = classify_weight * (mask * ce).sum() / batch_size

    # ---- objectness term
    sq_err = (preds[:, 4] - labels[:, 0]) ** 2
    obj_weights = (labels[:, 0] * (1.0 - no_obj_weight) + no_obj_weight) * img_w
    objectness_loss = (sq_err * obj_weights).sum() / batch_size

    total = objectness_loss + iou_loss + classification_loss
    return total, {
        "iou_loss": iou_loss,
        "objectness_loss": objectness_loss,
        "classification_loss": classification_loss,
    }
