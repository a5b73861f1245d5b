"""Bounding-box geometry (port of yogo_tpu/ops/boxes.py), torchvision
semantics, shape-polymorphic over leading dims: box conversions, pairwise
and elementwise IoU, the CIoU loss with eps = 1e-7 and a constant alpha, and
the device label-grid encoder."""

from __future__ import annotations

import math

import torch

_EPS = 1e-7


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (...) area."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between (N, 4) and (M, 4) xyxy boxes -> (N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter)


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x1, y1, x2, y2] -> [cx, cy, w, h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def elementwise_box_iou(
    boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = _EPS
) -> torch.Tensor:
    """Elementwise IoU between two broadcastable (..., 4) xyxy box tensors."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / (union + eps)


def complete_box_iou_loss(
    pred: torch.Tensor, target: torch.Tensor, eps: float = _EPS
) -> torch.Tensor:
    """Elementwise CIoU loss between (..., 4) xyxy boxes (reduction='none'):

        loss = 1 - IoU + center_dist^2 / diag^2 + alpha * v
        v = (4 / pi^2) (atan(wg/hg) - atan(w/h))^2
        alpha = detach(v / (1 - IoU + v + eps))

    torchvision's form with one deliberate difference, shared with the JAX
    package: a zero height is replaced by 1 before the division inside atan,
    so an all-zero (masked) box gives a finite value AND a finite gradient.
    Unguarded, atan(0/0) is NaN and reaches every parameter through
    0 * NaN once the loss is multiplied by its mask."""
    iou = elementwise_box_iou(pred, target, eps=eps)

    x1, y1, x2, y2 = pred.unbind(-1)
    x1g, y1g, x2g, y2g = target.unbind(-1)

    # smallest enclosing box diagonal
    xc1 = torch.minimum(x1, x1g)
    yc1 = torch.minimum(y1, y1g)
    xc2 = torch.maximum(x2, x2g)
    yc2 = torch.maximum(y2, y2g)
    diag_sq = (xc2 - xc1) ** 2 + (yc2 - yc1) ** 2 + eps

    center_sq = ((x1 + x2 - x1g - x2g) ** 2 + (y1 + y2 - y1g - y2g) ** 2) / 4
    diou = 1.0 - iou + center_sq / diag_sq

    w_pred = x2 - x1
    h_pred = y2 - y1
    w_gt = x2g - x1g
    h_gt = y2g - y1g

    safe_h_pred = torch.where(h_pred == 0, torch.ones_like(h_pred), h_pred)
    safe_h_gt = torch.where(h_gt == 0, torch.ones_like(h_gt), h_gt)
    v = (4.0 / (math.pi**2)) * (
        torch.atan(w_gt / safe_h_gt) - torch.atan(w_pred / safe_h_pred)
    ) ** 2
    alpha = (v / (1.0 - iou + v + eps)).detach()
    return diou + alpha * v


def encode_label_grid(labels: torch.Tensor, Sx: int, Sy: int) -> torch.Tensor:
    """Scatter (N, 5) [class, x1, y1, x2, y2] labels into a (6, Sy, Sx) grid
    [mask, x1, y1, x2, y2, class] on the labels' device. A box goes to the
    cell that holds its centre: i = floor((x1+x2)*Sx/2), j likewise.

    Rows padded with class < 0 and boxes whose centre lies outside [0, 1)
    are dropped, not wrapped to the opposite edge. When two boxes share a
    cell, which one stays is unspecified here; ops.grid.encode_label_grid_np
    keeps the last."""
    labels = torch.as_tensor(labels, dtype=torch.float32)
    n = labels.shape[0]
    out = torch.zeros((6, Sy, Sx), dtype=torch.float32, device=labels.device)
    if n == 0:
        return out
    ii = torch.floor((labels[:, 1] + labels[:, 3]) * Sx / 2).long()
    jj = torch.floor((labels[:, 2] + labels[:, 4]) * Sy / 2).long()
    valid = (labels[:, 0] >= 0) & (ii >= 0) & (ii < Sx) & (jj >= 0) & (jj < Sy)
    rows = torch.cat(
        [torch.ones((n, 1), device=labels.device), labels[:, 1:5], labels[:, 0:1]], dim=1
    )[valid]
    flat = out.view(6, Sy * Sx)
    flat[:, (jj * Sx + ii)[valid]] = rows.T
    return out
