"""Non-maximal suppression: fixed-capacity batched NMS + host oracle
(port of yogo_tpu/ops/nms.py).

The device path keeps the JAX package's formulation:
  1. top-K by objectness (done by the caller, static K),
  2. one (K, K) IoU matrix per image,
  3. greedy suppression resolved by fixed-point iteration
     (keep[j] <- no higher-priority *kept* box overlaps j), whose unique
     fixed point is exactly sequential greedy NMS.

The iteration is a Python loop capped at K+1 rounds that stops when `keep`
stops changing; each test costs one device->host sync (the counters
`nms_calls`, `nms_rounds` and `nms_host_syncs` of utils/tracing.COUNTS add
up the calls, keep updates and syncs).
Tie-breaking follows torch: stable sort, strictly-greater-than-threshold
suppression.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from yogo_tpu_torch.utils import tracing


def nms_numpy(
    boxes: np.ndarray, scores: np.ndarray, iou_threshold: float
) -> np.ndarray:
    """Host greedy NMS oracle with torchvision semantics (copy of the JAX
    package's). boxes: (N, 4) xyxy; scores: (N,). Returns kept indices
    sorted by descending score (stable). Box math runs in float64."""
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores, kind="stable")
    keep = []
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(boxes[i, 0], boxes[:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        union = areas[i] + areas - inter
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = np.where(union > 0, inter / union, 0.0)
        suppressed |= iou > iou_threshold
        suppressed[i] = True  # kept, but never revisited
    return np.asarray(keep, np.int64)


def _greedy_keep_from_suppression(suppress: torch.Tensor) -> torch.Tensor:
    """Resolve greedy NMS from a (..., K, K) suppression relation
    (suppress[i, j]: i precedes and suppresses j) by fixed-point iteration:
    keep[j] = not any_i(suppress[i, j] & keep[i])."""
    k = suppress.shape[-1]
    prev = torch.ones(suppress.shape[:-1], dtype=torch.bool, device=suppress.device)
    keep = ~(suppress & prev.unsqueeze(-1)).any(dim=-2)
    it = syncs = 0
    while it < k + 1:
        syncs += 1
        if torch.equal(keep, prev):  # host sync
            break
        prev, keep = keep, ~(suppress & keep.unsqueeze(-1)).any(dim=-2)
        it += 1
    tracing.add(nms_calls=1, nms_rounds=it + 1, nms_host_syncs=syncs)
    return keep


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    tiebreak: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy NMS over padded, fixed-size inputs, batched:
    boxes (B, K, 4) xyxy, scores (B, K), valid (B, K) bool -> keep (B, K)
    in the ORIGINAL slot order.

    tiebreak: optional (B, K) int priority for EQUAL scores (lower wins),
    default the slot index; the postprocess passes original grid-cell
    indices so results do not depend on the tie order of top-K.

    Sort-free: i suppresses j iff they overlap and i precedes j in the
    (score desc, tiebreak asc) total order. Extents are clipped at 1e19 so
    area products cannot overflow float32, and NaN scores rank last, as in
    yogo_tpu/ops/nms.py:121-150."""
    k = boxes.shape[-2]
    ext_lim = 1e19  # 1e19^2 = 1e38 < f32 max 3.4e38
    ext = torch.clamp(boxes[..., 2:] - boxes[..., :2], 0, ext_lim)
    area = ext[..., 0] * ext[..., 1]
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(rb - lt, 0, ext_lim)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (area[..., :, None] + area[..., None, :] - inter)

    scores = torch.where(torch.isnan(scores), float("-inf"), scores)
    if tiebreak is None:
        tiebreak = torch.arange(k, device=boxes.device).expand(scores.shape)
    s_i, s_j = scores[..., :, None], scores[..., None, :]
    precedes = (s_i > s_j) | ((s_i == s_j) & (tiebreak[..., :, None] < tiebreak[..., None, :]))
    suppress = (iou > iou_threshold) & precedes & valid[..., :, None] & valid[..., None, :]
    return _greedy_keep_from_suppression(suppress) & valid


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    tiebreak: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """batched_nms for one image: (K, 4), (K,), (K,) -> keep (K,)."""
    tb = None if tiebreak is None else tiebreak[None]
    return batched_nms(boxes[None], scores[None], valid[None], iou_threshold, tb)[0]
