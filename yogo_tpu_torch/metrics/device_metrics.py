"""Device-accumulated evaluation metrics (fast eval path; port of
yogo_tpu/metrics/device_metrics.py).

The host `Metrics` engine (metrics.py) formats predictions on the device
but matches and accumulates per image in numpy, the same host wall the
reference has (its per-image format_preds + scipy loop, reference:
yogo/metrics.py:112-157). This module keeps the WHOLE per-batch update on
the device - formatting, matching, and every accumulator - so no
prediction tensor is fetched and the only host transfer is the state fetch
at compute().

Design:
  - detections: the shared fixed-capacity batched formatter (top-K by
    objectness + NMS, ops/postprocess.py),
  - labels: fixed-capacity top-K extraction of grid cells with mask == 1,
  - matching: greedy global-max IoU assignment (rounds of masked argmaxes,
    batched over the images), then arbitrary-but-deterministic pairing of
    the zero-IoU remainder so the matched cardinality is min(M, N) exactly
    like the host's Hungarian assignment (scipy semantics). Greedy differs
    from Hungarian only when overlapping detections compete for
    overlapping labels (tests/test_torch_device_metrics.py has a
    constructed divergence); for NMS-filtered detections of a trained model
    the IoU matrix is a near-partial-permutation and the two agree,
  - confusion / ROC / ECE / missed / extra: exact integer scatter-adds
    (index_put_ with accumulate on int64 state: exact in any order).
    ROC state is a per-class histogram over "number of thresholds <= p"
    (searchsorted on the ascending threshold grid), from which the host
    compute() rebuilds the same tp/fp/fn/tn the host engine counts,
  - mAP: per-(class, IoU-threshold) TP/FP histograms over score bins
    (`map_score_bins`, default 4096) - torchmetrics' binned mode. compute()
    walks bins in descending score, which equals the host's per-detection
    sort when scores fall in distinct bins; ties inside one bin aggregate
    jointly (a documented, bounded divergence: score quantization is
    1/4096).

The greedy loop and the host: a round picks, for every image at once, its
largest remaining IoU. After every round the host asks the device whether
any image still had a positive IoU (one host sync), and the loop ends as
soon as the answer is no: with NMS-filtered detections that is after as
many rounds as the fullest image has pairs, far fewer than the min(K, G)
rounds a loop that never asks would take. PERF.md has the times of both.

The compute() output is the same 10-tuple as Metrics.compute().
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from yogo_tpu_torch.metrics.mean_ap import IOU_THRESHOLDS, MeanAveragePrecision
from yogo_tpu_torch.metrics.metrics import (
    NUM_ECE_BINS,
    NUM_ROC_THRESHOLDS,
    finish_metrics,
)
from yogo_tpu_torch.models.yogo import resolve_device
from yogo_tpu_torch.ops.postprocess import format_preds_batched

DEFAULT_MAP_SCORE_BINS = 4096
# matching IoU is computed in f32 on device; clip coordinates so the area
# products of insane (untrained-net) boxes can't overflow to inf/nan. Sane
# normalized boxes are untouched.
_COORD_CLIP = 1e3


# --------------------------------------------------------------- matching
def _batched_box_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (B, K, 4) against (B, G, 4) xyxy boxes -> (B, K, G)
    (ops.boxes.box_iou with a leading batch axis)."""
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    lt = torch.maximum(b1[:, :, None, :2], b2[:, None, :, :2])
    rb = torch.minimum(b1[:, :, None, 2:], b2[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, :, None] + area2[:, None, :] - inter)


def _match_state(
    iou: torch.Tensor, det_valid: torch.Tensor, gt_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The greedy loop's state before its first round: the IoU still to be
    taken (B, K, G; 0 where either side is invalid), partner (B, K) = -1,
    taken (B, G) = False."""
    b, k, g = iou.shape
    iou_w = torch.where(det_valid[:, :, None] & gt_valid[:, None, :], iou, 0.0)
    partner = torch.full((b, k), -1, dtype=torch.int64, device=iou.device)
    taken = torch.zeros((b, g), dtype=torch.bool, device=iou.device)
    return iou_w, partner, taken


def _greedy_round(iou_w: torch.Tensor, partner: torch.Tensor, taken: torch.Tensor) -> torch.Tensor:
    """One round, in place: every image with a positive IoU left pairs its
    largest one (first occurrence on ties: deterministic) and strikes that
    row and column. Returns (B,) bool, the images that paired; an image with
    nothing positive left passes through unchanged."""
    b, k, g = iou_w.shape
    bi = torch.arange(b, device=iou_w.device)
    val, idx = iou_w.view(b, k * g).max(dim=1)
    active = val > 0.0
    r = torch.div(idx, g, rounding_mode="floor")
    c = idx - r * g
    partner[bi, r] = torch.where(active, c, partner[bi, r])
    taken[bi, c] = taken[bi, c] | active
    iou_w[bi, r] = torch.where(active[:, None], -1.0, iou_w[bi, r])
    iou_w[bi, :, c] = torch.where(active[:, None], -1.0, iou_w[bi, :, c])
    return active


def _pair_remainder(
    partner: torch.Tensor, taken: torch.Tensor, det_valid: torch.Tensor, gt_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair the dets and gts that the greedy rounds left over (zero IoU) in
    index order -> (partner, gt_matched)."""
    g = taken.shape[1]
    left_det = det_valid & (partner < 0)
    left_gt = gt_valid & ~taken
    det_rank = torch.cumsum(left_det.to(torch.int64), dim=1) - 1  # (B, K)
    gt_rank = torch.cumsum(left_gt.to(torch.int64), dim=1) - 1  # (B, G)
    n_left_det = left_det.sum(dim=1, keepdim=True)
    n_left_gt = left_gt.sum(dim=1, keepdim=True)
    # leftover gts first (in index order), then the rest; keys are distinct
    ar = torch.arange(g, device=taken.device)
    gt_order = torch.argsort(torch.where(left_gt, ar, g + ar), dim=1)
    phase2 = torch.where(
        left_det & (det_rank < n_left_gt),
        torch.gather(gt_order, 1, det_rank.clamp(0, g - 1)),
        -1,
    )
    partner = torch.where(partner >= 0, partner, phase2)
    gt_matched = taken | (left_gt & (gt_rank < n_left_det))
    return partner, gt_matched


def greedy_match(
    iou: torch.Tensor, det_valid: torch.Tensor, gt_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy max-IoU assignment, batched over images.

    iou: (B, K, G) pairwise IoU; det_valid (B, K), gt_valid (B, G) bools.
    Returns (partner (B, K) int64 with -1 = unmatched, gt_matched (B, G)
    bool). Per image the cardinality is min(#valid dets, #valid gts):
    positive-IoU pairs are taken greedily (global max first, first-index
    tiebreak), then the zero-IoU remainder is paired in index order,
    mirroring scipy's rectangular linear_sum_assignment which always
    returns min(M, N) pairs (the zero-IoU pairing is arbitrary there too -
    any completion has equal cost).
    """
    iou_w, partner, taken = _match_state(iou, det_valid, gt_valid)
    for _ in range(min(iou.shape[1:])):
        if not bool(_greedy_round(iou_w, partner, taken).any()):  # (host sync)
            break
    return _pair_remainder(partner, taken, det_valid, gt_valid)


# ----------------------------------------------------------------- update
def _add_at(target: torch.Tensor, index: Tuple[torch.Tensor, ...], values: torch.Tensor) -> None:
    target.index_put_(index, values.to(target.dtype), accumulate=True)


@torch.no_grad()
def _update_batch(
    state: Dict[str, torch.Tensor],
    preds: torch.Tensor,  # (B, 5+C, Sy, Sx) decoded inference-mode predictions
    labels: torch.Tensor,  # (B, 6, Sy, Sx)
    image_mask: torch.Tensor,  # (B,) f32/bool: real (non-padding) images
    *,
    num_classes: int,
    include_background: bool,
    include_mAP: bool,
    obj_thresh: float,
    iou_thresh: float,
    min_class_confidence_threshold: float,
    max_detections: int,
    max_labels: int,
    map_score_bins: int,
) -> None:
    """Fold one batch into `state`, in place, on the state's device."""
    b, pred_dim, sy, sx = preds.shape
    dev = preds.device
    cells = sy * sx
    nc = num_classes
    ncb = nc + 1 if include_background else nc
    k = max(1, min(max_detections, cells))
    g = max(1, min(max_labels, cells))
    real = image_mask.to(torch.bool)
    i64 = torch.int64

    dets = format_preds_batched(
        preds,
        obj_thresh=obj_thresh,
        iou_thresh=iou_thresh,
        min_class_confidence_threshold=min_class_confidence_threshold,
        max_detections=max_detections,
        image_mask=image_mask,
    )
    det_boxes = dets["boxes_xyxy"].float()  # (B, K, 4)
    det_obj = dets["objectness"].float()  # (B, K)
    det_probs = dets["class_probs"].float()  # (B, K, C)
    det_valid = dets["valid"] & real[:, None]  # (B, K)

    # ---- fixed-capacity GT extraction: top-G cells by mask, index order
    flat = labels.reshape(b, 6, cells).transpose(1, 2)  # (B, cells, 6)
    gmask = flat[..., 0] > 0.5
    # distinct keys: mask dominates, lower cell index wins among equals
    # (arange/cells steps ~8e-5 >> f32 eps at 2.0, so keys never collide
    # and the free tie order of topk cannot matter)
    key = gmask.float() * 2.0 - torch.arange(cells, device=dev, dtype=torch.float32) / cells
    _, gt_idx = torch.topk(key, g, dim=1)  # (B, G)
    gt_rows = torch.gather(flat, 1, gt_idx[..., None].expand(-1, -1, 6))  # (B,G,6)
    gt_valid = (gt_rows[..., 0] > 0.5) & real[:, None]
    gt_boxes = gt_rows[..., 1:5].float()
    gt_cls = gt_rows[..., 5].to(i64).clamp(0, nc - 1)
    n_true = gmask.sum(dim=1)
    gt_overflow = (real & (n_true > g)).sum()
    n_passing = (preds[:, 4].reshape(b, cells) > obj_thresh).sum(dim=1)
    det_overflow = (real & (n_passing > k)).sum()

    # ---- pairwise IoU, f32, inf/nan-guarded for insane boxes
    db = det_boxes.clamp(-_COORD_CLIP, _COORD_CLIP)
    gb = gt_boxes.clamp(-_COORD_CLIP, _COORD_CLIP)
    iou = _batched_box_iou(db, gb)  # (B, K, G)
    iou = torch.where(torch.isfinite(iou), iou, 0.0)

    partner, gt_matched = greedy_match(iou, det_valid, gt_valid)  # (B, K) int64, (B, G) bool
    matched = partner >= 0
    safe_partner = partner.clamp(0, g - 1)
    pair_iou = torch.gather(iou, 2, safe_partner[:, :, None])[..., 0]  # (B, K)
    pair_gt_cls = torch.gather(gt_cls, 1, safe_partner)  # (B, K)
    missed = gt_valid & ~gt_matched  # (B, G)

    bg = nc  # background index when included

    # ---- classification rows (reference conversion semantics:
    # yogo/utils/prediction_formatting.py:206-251):
    #   matched det:  probs = [class_probs, 0], target = gt class
    #   extra det:    probs = [class_probs, 0], target = background
    #   missed label: probs = onehot(background), target = gt class
    # with include_background=False only matched rows are accumulated.
    if include_background:
        det_target = torch.where(matched, pair_gt_cls, bg)
        det_rows_p = torch.cat(
            [det_probs, torch.zeros((b, k, 1), dtype=torch.float32, device=dev)], dim=-1
        )
        miss_rows_p = torch.nn.functional.one_hot(
            torch.tensor(bg, device=dev), ncb
        ).float().expand(b, g, ncb)
        rows_p = torch.cat([det_rows_p.reshape(-1, ncb), miss_rows_p.reshape(-1, ncb)])
        rows_t = torch.cat([det_target.reshape(-1), gt_cls.reshape(-1)])
        rows_w = torch.cat([det_valid.reshape(-1), missed.reshape(-1)]).to(i64)
    else:
        rows_p = det_probs.reshape(-1, nc)
        rows_t = pair_gt_cls.reshape(-1)
        rows_w = (det_valid & matched).reshape(-1).to(i64)

    pred_idx = torch.argmax(rows_p, dim=-1)
    _add_at(state["confusion"], (rows_t, pred_idx), rows_w)

    # ---- ROC histograms: cnt = #{thresholds <= p} per (row, class)
    thr = torch.linspace(0.0, 1.0, NUM_ROC_THRESHOLDS, dtype=torch.float32, device=dev)
    cnt = torch.searchsorted(thr, rows_p.contiguous(), right=True)  # (R, ncb)
    onehot_t = torch.nn.functional.one_hot(rows_t, ncb)
    pos = onehot_t * rows_w[:, None]
    neg = (1 - onehot_t) * rows_w[:, None]
    cidx = torch.arange(ncb, device=dev).expand(cnt.shape)
    _add_at(state["roc_pos"], (cidx.reshape(-1), cnt.reshape(-1)), pos.reshape(-1))
    _add_at(state["roc_neg"], (cidx.reshape(-1), cnt.reshape(-1)), neg.reshape(-1))

    # ---- ECE over max-prob confidence (host: (conf * bins) truncated)
    conf = rows_p.amax(dim=-1)
    bins = (conf * NUM_ECE_BINS).to(i64).clamp(0, NUM_ECE_BINS - 1)
    correct = (pred_idx == rows_t).to(i64) * rows_w
    _add_at(state["ece_counts"], (bins,), rows_w)
    # the lone float accumulator: a plain f32 running sum stops absorbing
    # ~1.0-sized confidences once a bin passes 2^24, so sum per batch into
    # a fresh zero vector (exact at batch scale) and fold it in with
    # Neumaier compensation - the (sum, comp) f32 pair carries ~f64
    # precision for unbounded test sets
    batch_conf = torch.zeros(NUM_ECE_BINS, dtype=torch.float32, device=dev)
    _add_at(batch_conf, (bins,), conf * rows_w.float())
    s = state["ece_conf"]
    t = s + batch_conf
    state["ece_conf_comp"] += torch.where(
        s.abs() >= batch_conf.abs(), (s - t) + batch_conf, (batch_conf - t) + s
    )
    state["ece_conf"] = t
    _add_at(state["ece_correct"], (bins,), correct)

    # ---- missed / extra per-class counters (always accumulated)
    _add_at(state["missed_by_class"], (gt_cls.reshape(-1),), missed.reshape(-1))
    det_cls = torch.argmax(det_probs, dim=-1)  # (B, K) real classes
    _add_at(
        state["extra_by_class"],
        (det_cls.reshape(-1),),
        (det_valid & ~matched).reshape(-1),
    )
    state["total_matched"] += (det_valid & matched).sum()
    state["n_images"] += real.sum()
    state["gt_overflow"] += gt_overflow
    state["det_overflow"] += det_overflow

    # ---- binned mAP states
    if include_mAP:
        nb = map_score_bins
        sbin = (det_obj * nb).to(i64).clamp(0, nb - 1)  # (B, K)
        thr_map = torch.tensor(IOU_THRESHOLDS, dtype=torch.float32, device=dev)  # (10,)
        # every valid det contributes at each IoU threshold: TP iff matched
        # with the right class at sufficient IoU, else FP (extras included)
        dv = det_valid[..., None].to(i64)
        tp = (
            matched[..., None]
            & (pair_gt_cls == det_cls)[..., None]
            & (pair_iou[..., None] >= thr_map)
        ).to(i64) * dv
        fpw = dv - tp  # (B, K, 10)
        ti = torch.arange(10, device=dev).expand(tp.shape)
        flat_idx = ((det_cls[..., None] * 10 + ti) * nb + sbin[..., None]).reshape(-1)
        _add_at(state["map_tp"].view(-1), (flat_idx,), tp.reshape(-1))
        _add_at(state["map_fp"].view(-1), (flat_idx,), fpw.reshape(-1))
        _add_at(state["map_ngt"], (gt_cls.reshape(-1),), gt_valid.reshape(-1))


# ------------------------------------------------------------------ class
class DeviceMetrics:
    """Drop-in Metrics replacement whose update() runs wholly on the device
    and whose compute() returns the same 10-tuple.

    Capacities are smaller than the host engine's by default (the device
    state is fixed-shape): `max_detections` detections and `max_labels`
    ground-truth boxes per image. Overflow is counted and warned about at
    compute() - fall back to the host engine if a dataset exceeds them.

    device: where the state lives and update() runs (default CUDA;
    device="cpu" runs on the CPU). update() moves numpy inputs there and
    takes tensors already there as they are.
    """

    def __init__(
        self,
        classes: List[str],
        min_class_confidence_threshold: float = 0.9,
        include_mAP: bool = True,
        include_background: bool = True,
        obj_thresh: float = 0.5,
        iou_thresh: float = 0.5,
        max_detections: int = 256,
        max_labels: int = 256,
        map_score_bins: int = DEFAULT_MAP_SCORE_BINS,
        device=None,
    ):
        self.class_names = classes + (
            ["background"] if include_background else []
        )
        self.num_classes = len(classes)
        self.include_mAP = include_mAP
        self.include_background = include_background
        self.min_class_confidence_threshold = min_class_confidence_threshold
        self.obj_thresh = obj_thresh
        self.iou_thresh = iou_thresh
        self.max_detections = max_detections
        self.max_labels = max_labels
        self.map_score_bins = map_score_bins
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> None:
        nc = self.num_classes
        ncb = nc + 1 if self.include_background else nc

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        st = {
            "confusion": zeros(ncb, ncb),
            "roc_pos": zeros(ncb, NUM_ROC_THRESHOLDS + 1),
            "roc_neg": zeros(ncb, NUM_ROC_THRESHOLDS + 1),
            "ece_counts": zeros(NUM_ECE_BINS),
            "ece_conf": zeros(NUM_ECE_BINS, dtype=torch.float32),
            "ece_conf_comp": zeros(NUM_ECE_BINS, dtype=torch.float32),
            "ece_correct": zeros(NUM_ECE_BINS),
            "missed_by_class": zeros(nc),
            "extra_by_class": zeros(nc),
            "total_matched": zeros(),
            "n_images": zeros(),
            "gt_overflow": zeros(),
            "det_overflow": zeros(),
        }
        if self.include_mAP:
            st["map_tp"] = zeros(nc, 10, self.map_score_bins)
            st["map_fp"] = zeros(nc, 10, self.map_score_bins)
            st["map_ngt"] = zeros(nc)
        self._state = st

    # ---------------------------------------------------------------- api
    def update(self, preds, labels, image_mask=None) -> None:
        preds = torch.as_tensor(preds).to(self.device).float()
        labels = torch.as_tensor(labels).to(self.device)
        if image_mask is None:
            image_mask = torch.ones(preds.shape[0], dtype=torch.float32, device=self.device)
        else:
            image_mask = torch.as_tensor(image_mask).to(self.device)
        _update_batch(
            self._state,
            preds,
            labels,
            image_mask,
            num_classes=self.num_classes,
            include_background=self.include_background,
            include_mAP=self.include_mAP,
            obj_thresh=self.obj_thresh,
            iou_thresh=self.iou_thresh,
            min_class_confidence_threshold=self.min_class_confidence_threshold,
            max_detections=self.max_detections,
            max_labels=self.max_labels,
            map_score_bins=self.map_score_bins,
        )

    def compute(self) -> Tuple:
        # the one host transfer of the engine: the whole state, once
        st = {k: v.cpu().numpy() for k, v in self._state.items()}
        if st["gt_overflow"] > 0 or st["det_overflow"] > 0:
            warnings.warn(
                f"DeviceMetrics capacity overflow: {int(st['gt_overflow'])} "
                f"image(s) had more than max_labels={self.max_labels} boxes,"
                f" {int(st['det_overflow'])} had more than max_detections="
                f"{self.max_detections} passing cells; overflowing boxes "
                "were dropped. Use the host Metrics engine (or raise the "
                "capacities) for exact results on this dataset."
            )

        # rebuild the host engine's (ncb, T, 4) tp/fp/fn/tn from the
        # threshold-count histograms: tp[c,t] = #{pos rows: cnt >= t+1}
        pos_sfx = np.cumsum(st["roc_pos"][:, ::-1], axis=1)[:, ::-1]
        neg_sfx = np.cumsum(st["roc_neg"][:, ::-1], axis=1)[:, ::-1]
        tp = pos_sfx[:, 1:].astype(np.int64)  # (ncb, T)
        fp = neg_sfx[:, 1:].astype(np.int64)
        npos = st["roc_pos"].sum(axis=1).astype(np.int64)[:, None]
        nneg = st["roc_neg"].sum(axis=1).astype(np.int64)[:, None]
        roc_counts = np.stack([tp, fp, npos - tp, nneg - fp], axis=-1)

        if not self.include_mAP:
            mAP: Dict[str, float] = {"map": 0.0}
        elif st["n_images"] == 0:
            mAP = MeanAveragePrecision(self.num_classes)._empty_result()
        else:
            mAP = self._compute_map(
                st["map_tp"], st["map_fp"], st["map_ngt"]
            )

        return finish_metrics(
            confusion=st["confusion"].astype(np.int64),
            roc_counts=roc_counts,
            roc_thresholds=np.linspace(0.0, 1.0, NUM_ROC_THRESHOLDS),
            ece_counts=st["ece_counts"].astype(np.int64),
            ece_conf=st["ece_conf"].astype(np.float64)
            + st["ece_conf_comp"].astype(np.float64),
            ece_correct=st["ece_correct"].astype(np.float64),
            mAP=mAP,
            missed_by_class=st["missed_by_class"].astype(np.int64),
            extra_by_class=st["extra_by_class"].astype(np.int64),
            total_true_objects=int(st["total_matched"]),
        )

    def forward(self, preds, labels) -> Tuple:
        self.update(preds, labels)
        res = self.compute()
        self.reset()
        return res

    # ------------------------------------------------------------ mAP fin
    def _compute_map(
        self, tp_hist: np.ndarray, fp_hist: np.ndarray, ngt: np.ndarray
    ) -> Dict[str, float]:
        """Finish COCO AP from per-(class, threshold) score-binned TP/FP.

        Walking bins in descending score reproduces the host engine's
        score-sorted cumsums exactly when scores occupy distinct bins;
        same-bin ties aggregate into one P-R point (binned-mode semantics).
        """
        nc = self.num_classes
        ap = np.full((len(IOU_THRESHOLDS), nc), -1.0)
        for c in range(nc):
            n_gt = int(ngt[c])
            if n_gt == 0:
                continue
            for ti in range(len(IOU_THRESHOLDS)):
                tp_desc = tp_hist[c, ti, ::-1].astype(np.float64)
                fp_desc = fp_hist[c, ti, ::-1].astype(np.float64)
                ap[ti, c] = MeanAveragePrecision._ap_from_pr(
                    tp_desc, fp_desc, n_gt
                )

        recalls = []
        for c in range(nc):
            n_gt = int(ngt[c])
            if n_gt == 0:
                continue
            # only correct-class matches count toward recall; tp rows are
            # exactly those, so the bin sum is order-independent and exact
            recalls.append(
                float(
                    np.mean(
                        [
                            tp_hist[c, ti].sum() / n_gt
                            for ti in range(len(IOU_THRESHOLDS))
                        ]
                    )
                )
            )
        return MeanAveragePrecision.assemble_result(
            ap, float(np.mean(recalls)) if recalls else -1.0
        )
