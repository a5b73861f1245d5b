"""Prediction formatting / postprocessing (port of
yogo_tpu/ops/postprocess.py).

  * host path (`format_preds`): exact reference semantics with dynamic
    shapes, numpy (copy of the JAX package's);
  * device path (`format_preds_batched_raw`, `count_class_predictions_raw`):
    fixed-capacity, batched filter -> top-K -> survivor decode -> NMS ->
    count over the UNDECODED NHWC head, the `infer --count` hot path.

Thresholds follow the reference exactly: objectness strictly > obj_thresh,
NMS at iou_thresh with score = max(class_probs) * objectness (0 disables),
then max(class_probs) strictly > min_class_confidence_threshold (0 disables).
"""

from __future__ import annotations

from typing import Dict, Literal, Optional

import numpy as np
import torch

from yogo_tpu_torch.ops.grid import WH_CLAMP
from yogo_tpu_torch.ops.nms import batched_nms, nms_numpy

BoxFormat = Literal["xyxy", "cxcywh"]
VALID_BOX_FORMATS = ("xyxy", "cxcywh")

# default fixed capacity of the device path
DEFAULT_MAX_DETECTIONS = 1024
# capacity of the `infer --count` path: ~1.5x the realistic max object
# density of a 772x1032 brightfield image (~170)
INFER_COUNT_MAX_DETECTIONS = 256


def _cxcywh_to_xyxy_np(b: np.ndarray) -> np.ndarray:
    out = np.empty_like(b)
    out[:, 0] = b[:, 0] - b[:, 2] / 2
    out[:, 1] = b[:, 1] - b[:, 3] / 2
    out[:, 2] = b[:, 0] + b[:, 2] / 2
    out[:, 3] = b[:, 1] + b[:, 3] / 2
    return out


def format_preds(
    pred: np.ndarray,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    box_format: BoxFormat = "cxcywh",
    min_class_confidence_threshold: float = 0.0,
) -> np.ndarray:
    """Host-side exact formatter: (5+C, Sy, Sx) -> (N, 5+C).

    Reference pipeline (reference: yogo/utils/prediction_formatting.py:
    23-93): objectness filter, optional box conversion, NMS on xyxy boxes
    with score max(class)*objectness, class-confidence filter."""
    pred = np.asarray(pred)
    if pred.ndim != 3:
        raise ValueError(
            "argument to format_preds should be unbatched - expected shape "
            f"(pred_dim, Sy, Sx), got {pred.shape}"
        )
    if box_format not in VALID_BOX_FORMATS:
        raise ValueError(
            f"invalid box format {box_format}; valid formats: {VALID_BOX_FORMATS}"
        )

    pred_dim = pred.shape[0]
    flat = pred.reshape(pred_dim, -1).T  # (Sy*Sx, pred_dim)

    keep = flat[:, 4] > obj_thresh
    preds = flat[keep].astype(np.float32, copy=True)

    if box_format == "xyxy":
        preds[:, :4] = _cxcywh_to_xyxy_np(preds[:, :4])
        nms_boxes = preds[:, :4]
    else:
        nms_boxes = _cxcywh_to_xyxy_np(preds[:, :4])

    if iou_thresh > 0 and len(preds):
        scores = preds[:, 5:].max(axis=1) * preds[:, 4]
        keep_idx = nms_numpy(nms_boxes, scores, iou_thresh)
        preds = preds[keep_idx]

    if min_class_confidence_threshold > 0 and len(preds):
        preds = preds[preds[:, 5:].max(axis=1) > min_class_confidence_threshold]

    return preds


def format_preds_batched_raw(
    raw: torch.Tensor,
    anchor_w: float,
    anchor_h: float,
    width_multiplier: float = 1.0,
    height_multiplier: float = 1.0,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
    max_detections: int = DEFAULT_MAX_DETECTIONS,
    image_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Selection-first batched formatter over the undecoded head:
    (B, Sy, Sx, 5+C) NHWC raw (YOGO.apply(..., decode=False)) -> padded
    detections: boxes_cxcywh (B, K, 4), boxes_xyxy (B, K, 4),
    objectness (B, K), class_probs (B, K, C), valid (B, K) bool, in
    descending-objectness order per image.

    image_mask: optional (B,) bool marking real images of a padded batch.
    Selection runs on the objectness plane; the YOLO9000 decode
    (reference: yogo/model.py:277-313) runs on the K survivors only, in f32.
    Top-K is torch.topk (exact; the JAX package's approx_max_k at recall 1.0
    is exact too): only the order of tied keys may differ, and NMS breaks
    ties by original cell index. K = min(max_detections, cells); past K the
    lowest-objectness survivors are dropped."""
    b, sy, sx, pred_dim = raw.shape
    cells = sy * sx
    k = max(1, min(max_detections, cells))
    flat = raw.reshape(b, cells, pred_dim)

    obj = torch.sigmoid(flat[..., 4].float())
    passing = obj > obj_thresh
    if image_mask is not None:
        passing = passing & image_mask.to(torch.bool)[:, None]
    sort_key = torch.where(passing, obj, -1.0)
    top_val, top_idx = torch.topk(sort_key, k, dim=1)
    valid = (top_val > 0) & (top_val > obj_thresh)
    if max_detections == 0:
        valid = torch.zeros_like(valid)

    sel = torch.gather(flat, 1, top_idx[..., None].expand(-1, -1, pred_dim)).float()

    cxs = (top_idx % sx).float() / sx
    cys = torch.div(top_idx, sx, rounding_mode="floor").float() / sy
    cx = torch.sigmoid(sel[..., 0]) * (1.0 / sx) + cxs
    cy = torch.sigmoid(sel[..., 1]) * (1.0 / sy) + cys
    w = anchor_w * torch.exp(torch.clamp(sel[..., 2], max=WH_CLAMP)) * width_multiplier
    h = anchor_h * torch.exp(torch.clamp(sel[..., 3], max=WH_CLAMP)) * height_multiplier
    objectness = torch.sigmoid(sel[..., 4])
    class_probs = torch.softmax(sel[..., 5:], dim=-1)

    boxes_cxcywh = torch.stack([cx, cy, w, h], dim=-1)
    boxes_xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)

    if iou_thresh > 0:
        scores = class_probs.amax(dim=-1) * objectness
        valid = valid & batched_nms(boxes_xyxy, scores, valid, iou_thresh, tiebreak=top_idx)

    if min_class_confidence_threshold > 0:
        valid = valid & (class_probs.amax(dim=-1) > min_class_confidence_threshold)

    return {
        "boxes_cxcywh": boxes_cxcywh,
        "boxes_xyxy": boxes_xyxy,
        "objectness": objectness,
        "class_probs": class_probs,
        "valid": valid,
    }


def count_class_predictions_raw(
    raw: torch.Tensor,
    anchor_w: float,
    anchor_h: float,
    width_multiplier: float = 1.0,
    height_multiplier: float = 1.0,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
    max_detections: int = DEFAULT_MAX_DETECTIONS,
    image_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-class counts of the detections of format_preds_batched_raw:
    (B, Sy, Sx, 5+C) -> (C,) int64, left on the device."""
    f = format_preds_batched_raw(
        raw,
        anchor_w,
        anchor_h,
        width_multiplier=width_multiplier,
        height_multiplier=height_multiplier,
        obj_thresh=obj_thresh,
        iou_thresh=iou_thresh,
        min_class_confidence_threshold=min_class_confidence_threshold,
        max_detections=max_detections,
        image_mask=image_mask,
    )
    num_classes = f["class_probs"].shape[-1]
    cls = torch.argmax(f["class_probs"], dim=-1)
    onehot = torch.nn.functional.one_hot(cls, num_classes)
    return (onehot * f["valid"][..., None]).sum(dim=(0, 1))
