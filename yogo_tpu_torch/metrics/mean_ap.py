"""COCO-style mean average precision over Hungarian-matched detection pairs.

The reference feeds torchmetrics' MeanAveragePrecision with one-box
pseudo-images - each Hungarian-matched (pred, label) pair becomes its own
"image" (reference: yogo/metrics.py:153-154,208-234). This module computes
the same quantity directly from the match structure:

  per class c, per IoU threshold t in {.50, .55, ..., .95}:
    - matched pair with pred_class==c: TP if gt_class==c and IoU >= t else FP
    - extra (unmatched) prediction of class c: FP
    - gt count for c = matched gt of class c + missed labels of class c
  AP = COCO 101-point interpolated area under P-R (sorted by score desc)

map_small mirrors COCO's area buckets: with normalized [0,1] boxes every box
falls in "small", so map_small == map and medium/large report -1, matching
what torchmetrics returns for the reference's inputs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# linspace, NOT arange(0.5, 1.0, 0.05): arange accumulates float error so 8
# of its 10 values sit strictly ABOVE the COCO thresholds (e.g.
# 0.75000000000000022), flipping exact-boundary matches (IoU exactly 0.75)
# from TP to FP vs torchmetrics' linspace(0.5, 0.95, 10)
IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


class MeanAveragePrecision:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        # matched pairs: (score, pred_class, gt_class, iou)
        self._scores: List[np.ndarray] = []
        self._pred_cls: List[np.ndarray] = []
        self._gt_cls: List[np.ndarray] = []
        self._ious: List[np.ndarray] = []
        # unmatched predictions: (score, pred_class)
        self._extra_scores: List[np.ndarray] = []
        self._extra_cls: List[np.ndarray] = []
        # unmatched labels: class
        self._missed_cls: List[np.ndarray] = []

    def update(
        self,
        matched_scores: np.ndarray,
        matched_pred_cls: np.ndarray,
        matched_gt_cls: np.ndarray,
        matched_ious: np.ndarray,
        extra_scores: np.ndarray,
        extra_cls: np.ndarray,
        missed_cls: np.ndarray,
    ) -> None:
        self._scores.append(np.asarray(matched_scores, np.float64))
        self._pred_cls.append(np.asarray(matched_pred_cls, np.int64))
        self._gt_cls.append(np.asarray(matched_gt_cls, np.int64))
        self._ious.append(np.asarray(matched_ious, np.float64))
        self._extra_scores.append(np.asarray(extra_scores, np.float64))
        self._extra_cls.append(np.asarray(extra_cls, np.int64))
        self._missed_cls.append(np.asarray(missed_cls, np.int64))

    @staticmethod
    def _ap_from_pr(tp: np.ndarray, fp: np.ndarray, n_gt: int) -> float:
        """COCO 101-point interpolated AP from score-sorted TP/FP flags."""
        if n_gt == 0:
            return -1.0
        if len(tp) == 0:
            return 0.0  # ground truth exists but nothing was detected
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        # precision envelope (monotone non-increasing from the right)
        precision = np.maximum.accumulate(precision[::-1])[::-1]
        # sample at 101 recall points
        idx = np.searchsorted(recall, RECALL_POINTS, side="left")
        prec_at = np.where(
            idx < len(precision),
            precision[np.minimum(idx, len(precision) - 1)],
            0.0,
        )
        return float(prec_at.mean())

    @staticmethod
    def assemble_result(ap: np.ndarray, mar_100: float) -> Dict[str, float]:
        """Result dict from the (T, C) AP matrix (-1.0 = class with no GT).

        Shared by the host engine and DeviceMetrics so the key set and
        conventions (the -1 sentinel, map_small = all normalized boxes,
        map_medium/large unsupported) cannot drift between the two.
        """

        def mean_valid(a: np.ndarray) -> float:
            valid = a > -1
            return float(a[valid].mean()) if valid.any() else -1.0

        t50 = int(np.argmin(np.abs(IOU_THRESHOLDS - 0.50)))
        t75 = int(np.argmin(np.abs(IOU_THRESHOLDS - 0.75)))
        per_class = np.array(
            [mean_valid(ap[:, c]) for c in range(ap.shape[1])]
        )
        return {
            "map": mean_valid(ap),
            "map_50": mean_valid(ap[t50]),
            "map_75": mean_valid(ap[t75]),
            "map_small": mean_valid(ap),  # all normalized boxes are "small"
            "map_medium": -1.0,
            "map_large": -1.0,
            "map_per_class": per_class,
            "mar_100": mar_100,
        }

    def compute(self) -> Dict[str, float]:
        if not self._scores:
            return self._empty_result()
        scores = np.concatenate(self._scores)
        pred_cls = np.concatenate(self._pred_cls)
        gt_cls = np.concatenate(self._gt_cls)
        ious = np.concatenate(self._ious)
        extra_scores = np.concatenate(self._extra_scores)
        extra_cls = np.concatenate(self._extra_cls)
        missed_cls = np.concatenate(self._missed_cls)

        ap = np.full((len(IOU_THRESHOLDS), self.num_classes), -1.0)
        for c in range(self.num_classes):
            n_gt = int((gt_cls == c).sum() + (missed_cls == c).sum())
            if n_gt == 0:
                continue
            m_sel = pred_cls == c
            e_sel = extra_cls == c
            det_scores = np.concatenate([scores[m_sel], extra_scores[e_sel]])
            order = np.argsort(-det_scores, kind="stable")
            correct_gt = (gt_cls[m_sel] == c).astype(np.float64)
            pair_iou = ious[m_sel]
            n_extra = int(e_sel.sum())
            for ti, t in enumerate(IOU_THRESHOLDS):
                tp_flags = np.concatenate(
                    [correct_gt * (pair_iou >= t), np.zeros(n_extra)]
                )[order]
                fp_flags = 1.0 - tp_flags
                ap[ti, c] = self._ap_from_pr(tp_flags, fp_flags, n_gt)

        return self.assemble_result(
            ap, self._mean_recall(gt_cls, missed_cls, ious, pred_cls)
        )

    def _mean_recall(
        self,
        gt_cls: np.ndarray,
        missed: np.ndarray,
        ious: np.ndarray,
        pred_cls: np.ndarray,
    ) -> float:
        recalls = []
        for c in range(self.num_classes):
            n_gt = int((gt_cls == c).sum() + (missed == c).sum())
            if n_gt == 0:
                continue
            r_per_t = [
                float(((gt_cls == c) & (pred_cls == c) & (ious >= t)).sum()) / n_gt
                for t in IOU_THRESHOLDS
            ]
            recalls.append(np.mean(r_per_t))
        return float(np.mean(recalls)) if recalls else -1.0

    def _empty_result(self) -> Dict[str, float]:
        return {
            "map": -1.0,
            "map_50": -1.0,
            "map_75": -1.0,
            "map_small": -1.0,
            "map_medium": -1.0,
            "map_large": -1.0,
            "map_per_class": np.full(self.num_classes, -1.0),
            "mar_100": -1.0,
        }
