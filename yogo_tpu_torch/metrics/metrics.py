"""Evaluation metrics engine.

Port of yogo_tpu/metrics/metrics.py, which replaces the reference's
torchmetrics collection (reference: yogo/metrics.py:23-234) with batched
prediction formatting on the predictions' device + host accumulators:

  - detections come from the batched formatter (one pass per batch, on the
    device the predictions lie on, instead of the reference's per-image
    python NMS loop),
  - Hungarian matching (1 - IoU cost) pairs detections with labels per image;
    unmatched labels are "missed", unmatched detections "extra"
    (reference: yogo/utils/prediction_formatting.py:254-330),
  - optional "background" class conversion folds missed/extra into a
    synthetic final class for the confusion matrix
    (reference: yogo/utils/prediction_formatting.py:206-251),
  - accumulators: confusion matrix, per-class accuracy/precision/recall,
    500-threshold ROC, 30-bin L1 calibration error (ECE), COCO mAP,
    per-class missed/extra counters.

Defaults mirror the reference: obj 0.5, NMS IoU 0.5, min class confidence
0.9 for eval (reference: yogo/metrics.py:30).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from yogo_tpu_torch.metrics.mean_ap import MeanAveragePrecision
from yogo_tpu_torch.ops.postprocess import (
    PredictionLabelMatch,
    elementwise_iou_xyxy,
    format_preds_batched,
    match_preds_and_labels,
)

NUM_ROC_THRESHOLDS = 500
NUM_ECE_BINS = 30


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def finish_metrics(
    confusion: np.ndarray,  # (ncb, ncb) int
    roc_counts: np.ndarray,  # (ncb, T, 4) int [tp fp fn tn]
    roc_thresholds: np.ndarray,  # (T,) ascending
    ece_counts: np.ndarray,  # (NUM_ECE_BINS,) int
    ece_conf: np.ndarray,  # (NUM_ECE_BINS,) float sums
    ece_correct: np.ndarray,  # (NUM_ECE_BINS,) float sums
    mAP: dict,
    missed_by_class: np.ndarray,
    extra_by_class: np.ndarray,
    total_true_objects: int,
) -> Tuple:
    """Finish accumulated state into the reference's 10-tuple. Shared by the
    host engine below and the device-accumulated engine
    (metrics/device_metrics.py), so both paths report identical derived
    quantities from identical counts."""
    diag = np.diag(confusion).astype(np.float64)
    row = confusion.sum(axis=1).astype(np.float64)
    col = confusion.sum(axis=0).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        accuracy = np.where(row > 0, diag / row, 0.0)
        recall = np.where(row > 0, diag / row, 0.0)
        precision = np.where(col > 0, diag / col, 0.0)

    tp = roc_counts[..., 0].astype(np.float64)
    fp = roc_counts[..., 1].astype(np.float64)
    fn = roc_counts[..., 2].astype(np.float64)
    tn = roc_counts[..., 3].astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        tpr = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        fpr = np.where(fp + tn > 0, fp / (fp + tn), 0.0)
    # torchmetrics' binned MulticlassROC flips its curves so thresholds
    # DESCEND and fpr/tpr ascend (torchmetrics _binary_roc_compute);
    # consumers ported from the reference (AUC via trapezoid over fpr,
    # left-to-right ROC plots) assume that orientation
    tpr = tpr[..., ::-1]
    fpr = fpr[..., ::-1]

    total = ece_counts.sum()
    if total > 0:
        nz = ece_counts > 0
        acc_b = np.where(nz, ece_correct / np.maximum(ece_counts, 1), 0)
        conf_b = np.where(nz, ece_conf / np.maximum(ece_counts, 1), 0)
        ece = float((np.abs(acc_b - conf_b) * ece_counts / total).sum())
    else:
        ece = 0.0

    return (
        mAP,
        np.array(confusion, np.int64, copy=True),
        accuracy,
        (fpr, tpr, np.broadcast_to(np.asarray(roc_thresholds)[::-1], tpr.shape)),
        precision,
        recall,
        ece,
        np.array(missed_by_class, np.int64, copy=True),
        np.array(extra_by_class, np.int64, copy=True),
        np.array([total_true_objects]),
    )


class Metrics:
    def __init__(
        self,
        classes: List[str],
        min_class_confidence_threshold: float = 0.9,
        include_mAP: bool = True,
        include_background: bool = True,
        obj_thresh: float = 0.5,
        iou_thresh: float = 0.5,
        max_detections: int = 1024,
    ):
        self.class_names = classes + (["background"] if include_background else [])
        self.num_classes = len(classes)
        self.min_class_confidence_threshold = min_class_confidence_threshold
        self.include_mAP = include_mAP
        self.include_background = include_background
        self.obj_thresh = obj_thresh
        self.iou_thresh = iou_thresh
        self.max_detections = max_detections
        self.reset()

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        n_conf = self.num_classes + (1 if self.include_background else 0)
        self.confusion = np.zeros((n_conf, n_conf), np.int64)
        self.roc_thresholds = np.linspace(0.0, 1.0, NUM_ROC_THRESHOLDS)
        # per class, per threshold: [tp, fp, fn, tn]
        self.roc_counts = np.zeros((n_conf, NUM_ROC_THRESHOLDS, 4), np.int64)
        self.ece_counts = np.zeros(NUM_ECE_BINS, np.int64)
        self.ece_conf = np.zeros(NUM_ECE_BINS, np.float64)
        self.ece_correct = np.zeros(NUM_ECE_BINS, np.float64)
        self.num_obj_missed_by_class = np.zeros(self.num_classes, np.int64)
        self.num_obj_extra_by_class = np.zeros(self.num_classes, np.int64)
        self.total_num_true_objects = 0
        self.mAP = MeanAveragePrecision(self.num_classes)

    # ---------------------------------------------------------------- update
    def update(self, preds, labels, image_mask=None) -> None:
        """preds: (B, 5+C, Sy, Sx) decoded inference-mode predictions
        (class probabilities); labels: (B, 6, Sy, Sx) grids.

        image_mask: optional (B,) 0/1 marking real (non-padding) images.

        preds may be a tensor on any device (the formatter then runs there
        and only the padded detections come to the host) or a numpy array;
        labels and image_mask likewise."""
        preds = torch.as_tensor(preds)
        labels = _to_numpy(labels)
        mask_np = _to_numpy(image_mask) if image_mask is not None else None
        with torch.no_grad():
            dets = format_preds_batched(
                preds.float(),
                obj_thresh=self.obj_thresh,
                iou_thresh=self.iou_thresh,
                min_class_confidence_threshold=self.min_class_confidence_threshold,
                max_detections=self.max_detections,
                image_mask=(
                    torch.as_tensor(mask_np).to(preds.device)
                    if mask_np is not None
                    else None
                ),
            )
        boxes = _to_numpy(dets["boxes_xyxy"])
        objness = _to_numpy(dets["objectness"])
        probs = _to_numpy(dets["class_probs"])
        valid = _to_numpy(dets["valid"])
        real = (
            mask_np.astype(bool)
            if mask_np is not None
            else np.ones(labels.shape[0], bool)
        )

        for i in range(labels.shape[0]):
            if not real[i]:
                continue
            self._update_one(
                boxes[i][valid[i]],
                objness[i][valid[i]],
                probs[i][valid[i]],
                labels[i],
            )

    def _update_one(
        self,
        det_boxes: np.ndarray,  # (M, 4) xyxy
        det_obj: np.ndarray,  # (M,)
        det_probs: np.ndarray,  # (M, C)
        label_grid: np.ndarray,  # (6, Sy, Sx)
    ) -> None:
        flat = label_grid.reshape(6, -1).T
        gt = flat[flat[:, 0] == 1]  # (N, 6) [mask x1 y1 x2 y2 cls]

        # no reshape here: the concatenate already yields (M, 5+C), and a
        # reshape would silently scramble rows (instead of erroring later)
        # if the model's class width ever disagreed with this Metrics config
        formatted_preds = np.concatenate(
            [det_boxes, det_obj[:, None], det_probs], axis=1
        )
        pm: PredictionLabelMatch = match_preds_and_labels(formatted_preds, gt)

        matched_gt = pm.labels[:, 5].astype(np.int64)
        matched_probs = pm.preds[:, 5:]
        matched_obj = pm.preds[:, 4]
        matched_iou = (
            elementwise_iou_xyxy(pm.labels[:, 1:5], pm.preds[:, :4])
            if len(pm.preds)
            else np.empty(0)
        )

        missed_cls = (
            pm.missed_labels[:, 5].astype(np.int64)
            if pm.missed_labels is not None
            else np.empty(0, np.int64)
        )
        extra_probs = (
            pm.extra_predictions[:, 5:]
            if pm.extra_predictions is not None
            else np.empty((0, self.num_classes))
        )
        extra_obj = (
            pm.extra_predictions[:, 4]
            if pm.extra_predictions is not None
            else np.empty(0)
        )

        # missed / extra counters (reference: yogo/metrics.py:128-144)
        np.add.at(self.num_obj_missed_by_class, missed_cls, 1)
        if len(extra_probs):
            np.add.at(
                self.num_obj_extra_by_class, extra_probs.argmax(axis=1), 1
            )
        self.total_num_true_objects += len(pm.labels)

        if self.include_mAP:
            self.mAP.update(
                matched_obj,
                matched_probs.argmax(axis=1) if len(matched_probs) else np.empty(0, np.int64),
                matched_gt,
                matched_iou,
                extra_obj,
                extra_probs.argmax(axis=1) if len(extra_probs) else np.empty(0, np.int64),
                missed_cls,
            )

        # assemble classification-prob rows + targets for the accumulators
        # via the public background-conversion API (background gets its OWN
        # index num_classes, so the confusion matrix separates it from the
        # last real class)
        if self.include_background:
            conv = pm.convert_background_errors(self.num_classes + 1)
            all_probs = conv.preds[:, 5:]
            all_tgts = conv.labels[:, 5].astype(np.int64)
        else:
            all_probs = matched_probs
            all_tgts = matched_gt
        if not len(all_probs):
            return
        self._accumulate_classification(all_probs, all_tgts)

    def _accumulate_classification(
        self, probs: np.ndarray, targets: np.ndarray
    ) -> None:
        nc = probs.shape[1]
        pred_idx = probs.argmax(axis=1)
        np.add.at(self.confusion, (targets, pred_idx), 1)

        # ROC: per class one-vs-rest at 500 thresholds (pred >= t)
        for c in range(nc):
            pc = probs[:, c]
            pos = targets == c
            ge = pc[None, :] >= self.roc_thresholds[:, None]  # (T, N)
            tp = (ge & pos[None, :]).sum(axis=1)
            fp = (ge & ~pos[None, :]).sum(axis=1)
            fn = pos.sum() - tp
            tn = (~pos).sum() - fp
            self.roc_counts[c, :, 0] += tp
            self.roc_counts[c, :, 1] += fp
            self.roc_counts[c, :, 2] += fn
            self.roc_counts[c, :, 3] += tn

        # ECE bins over max-prob confidence
        conf = probs.max(axis=1)
        correct = (pred_idx == targets).astype(np.float64)
        bins = np.clip(
            (conf * NUM_ECE_BINS).astype(np.int64), 0, NUM_ECE_BINS - 1
        )
        np.add.at(self.ece_counts, bins, 1)
        np.add.at(self.ece_conf, bins, conf)
        np.add.at(self.ece_correct, bins, correct)

    # --------------------------------------------------------------- compute
    def compute(self) -> Tuple:
        """Returns the reference's 10-tuple (reference: yogo/metrics.py:159-187):
        (mAP dict, confusion, per-class accuracy, (fpr, tpr, thresholds),
        per-class precision, per-class recall, calibration error,
        missed-by-class, extra-by-class, total true objects)."""
        # the reference returns map=0.0 when mAP is disabled
        # (yogo/metrics.py:167-172), not a -1 sentinel
        mAP = self.mAP.compute() if self.include_mAP else {"map": 0.0}
        return finish_metrics(
            confusion=self.confusion,
            roc_counts=self.roc_counts,
            roc_thresholds=self.roc_thresholds,
            ece_counts=self.ece_counts,
            ece_conf=self.ece_conf,
            ece_correct=self.ece_correct,
            mAP=mAP,
            missed_by_class=self.num_obj_missed_by_class,
            extra_by_class=self.num_obj_extra_by_class,
            total_true_objects=self.total_num_true_objects,
        )

    def forward(self, preds, labels) -> Tuple:
        self.update(preds, labels)
        res = self.compute()
        self.reset()
        return res
