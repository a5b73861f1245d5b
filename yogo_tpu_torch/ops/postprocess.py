"""Prediction formatting / postprocessing (port of
yogo_tpu/ops/postprocess.py).

  * host path (`format_preds`): exact reference semantics with dynamic
    shapes, numpy (copy of the JAX package's);
  * device path (`format_preds_batched_raw`, `count_class_predictions_raw`):
    fixed-capacity, batched filter -> top-K -> survivor decode -> NMS ->
    count over the UNDECODED NHWC head, the `infer --count` hot path;
    `format_preds_batched` / `count_class_predictions` do the same over
    DECODED predictions, for the device metrics;
  * candidate paths of `serve` and `infer --fetch-top-k`
    (`select_top_candidates{,_raw}`, `decode_raw_slice`,
    `scatter_candidates`): the top-K cells by objectness come to the host,
    and the host formatter runs on them as on the full grid;
  * host exports and counts (`format_to_numpy`,
    `count_cells_for_formatted_preds`), numpy;
  * matching for the host metrics (`PredictionLabelMatch`,
    `match_preds_and_labels`, `format_preds_and_labels_v2`), numpy.

Thresholds follow the reference exactly: objectness strictly > obj_thresh,
NMS at iou_thresh with score = max(class_probs) * objectness (0 disables),
then max(class_probs) strictly > min_class_confidence_threshold (0 disables).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Literal, Optional

import numpy as np
import torch

from yogo_tpu_torch.models.yogo import cell_offset_tensors, decode_rows
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
    return _count_valid_classes(f)


def format_preds_batched(
    preds: torch.Tensor,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
    max_detections: int = DEFAULT_MAX_DETECTIONS,
    image_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Device-side batched formatter over DECODED predictions:
    (B, 5+C, Sy, Sx) -> padded detections (the dict of
    format_preds_batched_raw), in descending-objectness order per image.

    image_mask: optional (B,) bool marking real (non-padding) images, so a
    ragged final batch keeps the fixed batch shape.

    NMS resolves in float32 whatever the dtype of `preds`: the boxes and
    scores of a bf16 / f16 tensor are widened (exactly) before the IoU test,
    on the CPU as on the card, so `valid` is the float32 IoU's answer on the
    input's own values; the returned boxes and scores keep the input dtype.

    Capacity note: K = min(max_detections, cells). If more than K cells pass
    the objectness threshold the lowest-objectness survivors are dropped
    (the reference keeps all); which of several cells TIED at the cut
    survive is torch.topk's choice and may differ from the JAX package's."""
    b, pred_dim, sy, sx = preds.shape
    cells = sy * sx
    # max_detections=0 means "keep nothing": compute at capacity 1 and mask
    # everything out, since top-k needs k >= 1
    k = max(1, min(max_detections, cells))
    flat = preds.reshape(b, pred_dim, cells).transpose(1, 2)  # (B, cells, D)

    obj = flat[..., 4]
    passing = obj > obj_thresh
    if image_mask is not None:
        passing = passing & image_mask.to(torch.bool)[:, None]
    sort_key = torch.where(passing, obj, -1.0)
    top_val, top_idx = torch.topk(sort_key, k, dim=1)
    valid = (top_val > 0) & (top_val > obj_thresh)
    if max_detections == 0:
        valid = torch.zeros_like(valid)

    sel = torch.gather(flat, 1, top_idx[..., None].expand(-1, -1, pred_dim))
    boxes_cxcywh = sel[..., :4]
    cx, cy, w, h = boxes_cxcywh.unbind(-1)
    boxes_xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    objectness = sel[..., 4]
    class_probs = sel[..., 5:]

    if iou_thresh > 0:
        scores = class_probs.amax(dim=-1) * objectness
        # ties between equal scores break by ORIGINAL cell index, like the
        # host path's stable sort over cell-ordered predictions
        valid = valid & batched_nms(boxes_xyxy.float(), scores.float(), valid, iou_thresh,
                                    tiebreak=top_idx)

    if min_class_confidence_threshold > 0:
        valid = valid & (class_probs.amax(dim=-1) > min_class_confidence_threshold)

    return {
        "boxes_cxcywh": boxes_cxcywh,
        "boxes_xyxy": boxes_xyxy,
        "objectness": objectness,
        "class_probs": class_probs,
        "valid": valid,
    }


def _count_valid_classes(f: Dict[str, torch.Tensor]) -> torch.Tensor:
    num_classes = f["class_probs"].shape[-1]
    cls = torch.argmax(f["class_probs"], dim=-1)
    onehot = torch.nn.functional.one_hot(cls, num_classes)
    return (onehot * f["valid"][..., None]).sum(dim=(0, 1))


def count_class_predictions(
    preds: torch.Tensor,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
    max_detections: int = DEFAULT_MAX_DETECTIONS,
    image_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-class counts of the detections of format_preds_batched:
    (B, 5+C, Sy, Sx) decoded, any float dtype (NMS in float32) -> (C,)
    int64, left on the device."""
    return _count_valid_classes(
        format_preds_batched(
            preds,
            obj_thresh=obj_thresh,
            iou_thresh=iou_thresh,
            min_class_confidence_threshold=min_class_confidence_threshold,
            max_detections=max_detections,
            image_mask=image_mask,
        )
    )


def select_top_candidates(out: torch.Tensor, k: int):
    """(B, 5+C, Sy, Sx) decoded predictions -> the top-k cells by
    objectness as (rows (B, k, 5+C), flat cell indices (B, k)), in
    descending objectness.

    Fetching these instead of the full tensor stays exact: a cell outside
    the top-k has objectness <= the k-th candidate's (`rows[:, -1, 4]`), so
    whenever that value <= a consumer's obj_thresh the candidates hold
    every passing cell. torch.topk keeps the same set and k-th value as the
    JAX package's approx_max_k(recall_target=1.0); only the order of tied
    keys may differ, and scatter_candidates restores cell order.

    No path of the port calls it: `infer` and `serve` select from the raw
    head (select_top_candidates_raw). It is the JAX package's public
    function over a decoded tensor, kept for such callers and held against
    it in the tests."""
    flat = out.reshape(out.shape[0], out.shape[1], -1)  # (B, D, S)
    _, idx = torch.topk(flat[:, 4, :].float(), k, dim=1, sorted=True)
    rows = torch.gather(flat, 2, idx[:, None, :].expand(-1, flat.shape[1], -1))
    return rows.transpose(1, 2), idx


def select_top_candidates_raw(
    raw: torch.Tensor,
    k: int,
    anchor_w: float,
    anchor_h: float,
    width_multiplier: float = 1.0,
    height_multiplier: float = 1.0,
):
    """select_top_candidates over the UNDECODED NHWC head (B, Sy, Sx, 5+C)
    of YOGO.apply(..., decode=False): top-k on the f32 sigmoid objectness,
    gather of the raw rows, then the inference decode (f32, class softmax)
    of the k survivors only, with their cell offsets gathered from the
    cell_offsets tables - the values the full decode gives those cells, bit
    for bit (i/Sx would be 1 ulp off). Returns (rows (B, k, 5+C) f32, flat
    cell indices (B, k)), with the same completeness proof via
    rows[:, -1, 4]."""
    b, sy, sx, pred_dim = raw.shape
    flat = raw.reshape(b, sy * sx, pred_dim)
    obj = torch.sigmoid(flat[..., 4].float())
    _, idx = torch.topk(obj, k, dim=1, sorted=True)
    sel = torch.gather(flat, 1, idx[..., None].expand(-1, -1, pred_dim))
    cxs, cys = (t.reshape(-1)[idx] for t in cell_offset_tensors(sx, sy, raw.device))
    rows = decode_rows(sel, cxs, cys, sx, sy, anchor_w, anchor_h,
                       width_multiplier, height_multiplier, inference=True)
    return rows, idx


def decode_raw_slice(
    raw: torch.Tensor,
    slot,
    anchor_w: float,
    anchor_h: float,
    width_multiplier: float = 1.0,
    height_multiplier: float = 1.0,
) -> torch.Tensor:
    """One image's decoded (5+C, Sy, Sx) inference grid from the batched
    NHWC raw head: the candidate paths' full-fetch fallback, for when a
    consumer's threshold undercuts the k-th candidate. `slot` is an int or
    a 0-d tensor."""
    one = raw[int(slot)]
    sy, sx, _ = one.shape
    cxs, cys = cell_offset_tensors(sx, sy, raw.device)
    out = decode_rows(one, cxs, cys, sx, sy, anchor_w, anchor_h,
                      width_multiplier, height_multiplier, inference=True)
    return out.permute(2, 0, 1)


def scatter_candidates(
    cand_rows: np.ndarray, cand_idx: np.ndarray, pred_dim: int,
    sy: int, sx: int,
) -> np.ndarray:
    """Top-k candidate rows + flat cell indices -> a (pred_dim, Sy, Sx)
    grid equal to the full one for any objectness threshold the candidates
    are complete for: other cells become zero rows (objectness 0), which
    the host formatter drops like the sub-threshold cells they stand for,
    and candidates land at their own cells, so cell-order NMS tie-breaks
    hold (copy of the JAX package's)."""
    flat = np.zeros((sy * sx, pred_dim), np.float32)
    flat[np.asarray(cand_idx)] = cand_rows
    return flat.T.reshape(pred_dim, sy, sx)


def count_cells_for_formatted_preds(
    formatted_class_predictions: np.ndarray,
    min_confidence_threshold: Optional[float] = None,
) -> np.ndarray:
    """Host per-class counter over (N, C) class-prob rows (reference:
    yogo/infer.py:90-124): argmax, filter max prob strictly > threshold,
    histogram."""
    p = np.asarray(formatted_class_predictions)
    if p.ndim != 2:
        raise ValueError(
            "expected formatted_class_predictions of shape (N, num_classes); "
            f"got {p.shape}"
        )
    if min_confidence_threshold is not None and not (
        0 <= min_confidence_threshold <= 1
    ):
        raise ValueError(
            "min_confidence_threshold should be between 0 and 1; "
            f"is {min_confidence_threshold}"
        )
    thresh = min_confidence_threshold or 0.0
    n_classes = p.shape[1]
    if len(p) == 0:
        return np.zeros(n_classes, np.int64)
    kept = p.argmax(axis=1)[p.max(axis=1) > thresh]
    return np.bincount(kept, minlength=n_classes).astype(np.int64)


def format_to_numpy(
    img_id: int,
    prediction_tensor: np.ndarray,
    img_h: int,
    img_w: int,
    np_dtype=np.float32,
) -> np.ndarray:
    """Scope .npy export schema (reference:
    yogo/utils/prediction_formatting.py:96-156): (8+C, N) rows =
    [img_id, tlx*w, tly*h, brx*w, bry*h, objectness, argmax label,
    peak prob, *class probs], filtered at format_preds' default
    thresholds."""
    filtered = format_preds(prediction_tensor, box_format="xyxy").T  # (5+C, N)
    n = filtered.shape[1]
    all_confs = filtered[5:].astype(np_dtype)
    pred_labels = np.argmax(all_confs, axis=0).astype(np.uint8)
    return np.vstack(
        (
            np.full(n, img_id, dtype=np_dtype),
            (filtered[0] * img_w).astype(np_dtype),
            (filtered[1] * img_h).astype(np_dtype),
            (filtered[2] * img_w).astype(np_dtype),
            (filtered[3] * img_h).astype(np_dtype),
            filtered[4].astype(np_dtype),
            pred_labels.astype(np_dtype),
            all_confs[pred_labels, np.arange(n)].astype(np_dtype),
            all_confs,
        )
    )


@dataclass
class PredictionLabelMatch:
    """Matched detections vs labels for one or more images (reference:
    yogo/utils/prediction_formatting.py:165-251). Three cases:
      1. a one-to-one match between predictions and labels (`preds`/`labels`),
      2. predictions that are actually background (`extra_predictions`),
      3. labels that were missed (`missed_labels`).

    preds: (N, 5+C) formatted predictions [x1 y1 x2 y2 obj *class_probs];
    labels: (N, 6) label rows [mask x1 y1 x2 y2 class]; missed_labels (K, 6);
    extra_predictions (M, 5+C). The latter two are None when empty.
    """

    preds: np.ndarray
    labels: np.ndarray
    missed_labels: Optional[np.ndarray]
    extra_predictions: Optional[np.ndarray]

    @staticmethod
    def concat(
        preds_and_labels: List["PredictionLabelMatch"],
    ) -> "PredictionLabelMatch":
        missed = [
            p.missed_labels
            for p in preds_and_labels
            if p.missed_labels is not None
        ]
        extra = [
            p.extra_predictions
            for p in preds_and_labels
            if p.extra_predictions is not None
        ]
        return PredictionLabelMatch(
            preds=np.concatenate([p.preds for p in preds_and_labels], axis=0),
            labels=np.concatenate([p.labels for p in preds_and_labels], axis=0),
            missed_labels=np.concatenate(missed, axis=0) if missed else None,
            extra_predictions=np.concatenate(extra, axis=0) if extra else None,
        )

    def convert_background_errors(self, num_classes: int) -> "PredictionLabelMatch":
        """Fold missed/extra into a synthetic ``background`` class, assumed to
        be the LAST of `num_classes` (reference:
        yogo/utils/prediction_formatting.py:206-251). `num_classes` must count
        the background class, i.e. num_classes == C + 1 where C is the number
        of class-prob columns in `preds` (the reference's row shapes only
        agree under that contract).

          missed label  -> pred [box, obj 1, onehot(background)], label as-is
          extra pred    -> pred [row, 0 background prob], label [1, box, bg]

        Matched `preds` gain a zero background-probability column.
        """
        c = self.preds.shape[1] - 5
        if num_classes != c + 1:
            raise ValueError(
                f"num_classes ({num_classes}) must include the background "
                f"class: expected {c + 1} for predictions with {c} class "
                "probabilities"
            )
        bg = num_classes - 1
        new_preds, new_labels = [], []

        missed = self.missed_labels if self.missed_labels is not None else []
        extra = (
            self.extra_predictions if self.extra_predictions is not None else []
        )
        for ml in np.asarray(missed, np.float32).reshape(-1, 6):
            onehot = np.zeros(num_classes, np.float32)
            onehot[bg] = 1.0
            new_preds.append(np.concatenate([ml[1:5], [1.0], onehot]))
            new_labels.append(ml)
        for ep in np.asarray(extra, np.float32).reshape(-1, 5 + c):
            new_preds.append(np.concatenate([ep, [0.0]]))
            new_labels.append(
                np.concatenate([[1.0], ep[:4], [float(bg)]])
            )

        preds_bg = np.concatenate(
            [self.preds, np.zeros((len(self.preds), 1), self.preds.dtype)],
            axis=1,
        )
        if not new_preds:
            return PredictionLabelMatch(
                preds=preds_bg,
                labels=self.labels,
                missed_labels=None,
                extra_predictions=None,
            )
        return PredictionLabelMatch(
            preds=np.concatenate([preds_bg, np.stack(new_preds)], axis=0),
            labels=np.concatenate(
                [self.labels, np.stack(new_labels)], axis=0
            ),
            missed_labels=None,
            extra_predictions=None,
        )


def match_preds_and_labels(
    formatted_preds: np.ndarray, formatted_labels: np.ndarray
) -> PredictionLabelMatch:
    """Hungarian-match formatted predictions against formatted labels for one
    image (cost = 1 - pairwise IoU; reference:
    yogo/utils/prediction_formatting.py:297-330).

    formatted_preds: (M, 5+C) [x1 y1 x2 y2 obj *probs] (xyxy);
    formatted_labels: (N, 6) [mask x1 y1 x2 y2 class].
    """
    from yogo_tpu_torch.metrics.matching import linear_sum_assignment

    formatted_preds = np.atleast_2d(np.asarray(formatted_preds, np.float32))
    formatted_labels = np.asarray(formatted_labels, np.float32).reshape(-1, 6)
    m, n = len(formatted_preds), len(formatted_labels)

    if m and n:
        iou = _pairwise_iou_xyxy(
            formatted_labels[:, 1:5], formatted_preds[:, :4]
        )
    else:
        iou = np.zeros((n, m), np.float32)
    rows, cols = linear_sum_assignment(1.0 - iou)

    matched_preds = formatted_preds[cols]
    matched_labels = formatted_labels[rows]
    extra_idx = np.setdiff1d(np.arange(m), cols, assume_unique=True)
    missed_idx = np.setdiff1d(np.arange(n), rows, assume_unique=True)
    extra = formatted_preds[extra_idx]
    missed = formatted_labels[missed_idx]
    return PredictionLabelMatch(
        preds=matched_preds,
        labels=matched_labels,
        missed_labels=missed if len(missed) else None,
        extra_predictions=extra if len(extra) else None,
    )


def format_preds_and_labels_v2(
    pred: np.ndarray,
    label: np.ndarray,
    objectness_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
) -> PredictionLabelMatch:
    """Filter+format one image's raw prediction grid, then Hungarian-match it
    against the label grid (reference:
    yogo/utils/prediction_formatting.py:254-330).

    pred: (5+C, Sy, Sx) decoded predictions; label: (6, Sy, Sx) grid.
    """
    pred = np.squeeze(np.asarray(pred))
    label = np.squeeze(np.asarray(label))
    if pred.ndim != 3:
        raise ValueError(
            "argument to format_pred should be unbatched result - "
            f"shape should be (pred_shape, Sy, Sx), got {pred.shape}"
        )
    formatted_preds = format_preds(
        pred,
        obj_thresh=objectness_thresh,
        iou_thresh=0.5,
        box_format="xyxy",
        min_class_confidence_threshold=min_class_confidence_threshold,
    )
    label_shape = label.shape[0]
    flat = label.reshape(label_shape, -1).T
    formatted_labels = flat[flat[:, 0].astype(bool)]
    return match_preds_and_labels(formatted_preds, formatted_labels)


def format_preds_and_labels(
    pred: np.ndarray,
    label: np.ndarray,
    use_IoU: bool = True,
    objectness_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
):
    """DEPRECATED: use format_preds_and_labels_v2. Reference-parity port of
    the old matching (reference: yogo/utils/prediction_formatting.py:333-424):
    per labeled cell, pick the argmax-IoU prediction among threshold
    survivors (with replacement - one prediction can serve many labels), or
    fall back to naive same-cell matching.

    Returns (preds (N, 5+C) xyxy, labels (N, 6))."""
    import warnings

    warnings.warn("use format_preds_and_labels_v2 instead", DeprecationWarning)
    pred = np.squeeze(np.asarray(pred, np.float32))
    label = np.squeeze(np.asarray(label, np.float32))
    if pred.ndim != 3:
        raise ValueError(
            "argument to format_pred should be unbatched result - "
            f"shape should be (pred_shape, Sy, Sx), got {pred.shape}"
        )
    if not 0 <= objectness_thresh < 1:
        raise ValueError(
            "must have 0 <= objectness_thresh < 1; got "
            f"objectness_thresh={objectness_thresh}"
        )
    flat_preds = pred.reshape(pred.shape[0], -1).T.copy()
    flat_labels = label.reshape(label.shape[0], -1).T
    pred_mask = (flat_preds[:, 4] > objectness_thresh) & (
        flat_preds[:, 5:].max(axis=1) > min_class_confidence_threshold
    )
    labels_mask = flat_labels[:, 0].astype(bool)
    labels_with_objects = flat_labels[labels_mask]

    if use_IoU and pred_mask.sum() >= len(labels_with_objects):
        preds_with_objects = flat_preds[pred_mask].copy()
        preds_with_objects[:, :4] = _cxcywh_to_xyxy_np(
            preds_with_objects[:, :4]
        )
        iou = _pairwise_iou_xyxy(
            labels_with_objects[:, 1:5], preds_with_objects[:, :4]
        )
        if iou.shape[1] > 0:
            idx = iou.argmax(axis=1)
        else:
            idx = np.empty(0, np.int64)
        final_preds = preds_with_objects[idx]
    else:
        final_preds = flat_preds[labels_mask].copy()
        final_preds[:, :4] = _cxcywh_to_xyxy_np(final_preds[:, :4])
    return final_preds, labels_with_objects


def _pairwise_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # f64: diverged checkpoints emit exp-huge extents whose f32 area
    # products overflow to inf -> NaN IoUs -> NaN Hungarian costs (same
    # rationale as nms_numpy and the device NMS extent clip)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def elementwise_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-for-row IoU of already-matched box pairs: (K,4),(K,4) -> (K,).
    O(K), unlike taking the diagonal of the full pairwise matrix.
    f64 for the same overflow reason as _pairwise_iou_xyxy."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lt = np.maximum(a[:, :2], b[:, :2])
    rb = np.minimum(a[:, 2:], b[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a + area_b - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(union > 0, inter / union, 0.0)
