"""Windowed (grid-local) NMS + class counting: selection-free postprocess
(port of yogo_tpu/ops/window_nms.py, in torch ops).

STATUS: EXPERIMENTAL - exact and capacity-free, but with no caller, as in
the JAX package. Its time on the card is not measured by the repo's
scripts; it runs 40 offsets of small torch ops, then a fixed point that
asks the host after every round, where the decoded count path
(ops/postprocess.count_class_predictions) is one selection and one NMS.
Kept with tests against the JAX package (tests/test_torch_window_nms.py,
on the CPU and on the card): correct, off the hot path, and the
capacity-free semantics are useful as an oracle.

The fused count path (`infer --count`, reference: yogo/infer.py:60-124)
needs only the per-class histogram of NMS survivors - not their boxes. The
standard device path (ops/postprocess.py) pays for a global top-K
selection plus a (K, K) pairwise NMS, because greedy NMS is formulated over
a compacted candidate list.

This module reformulates greedy NMS *in grid layout*: every prediction's box
center lies inside its own grid cell (the YOLO9000 direct-location decode,
models/yogo.py: cx = (sigmoid + col)/Sx), so two boxes can only overlap -
let alone exceed an IoU threshold - if their cells are near each other.
Suppression is then a stencil: each cell is compared against a fixed window
of neighbor offsets via shifted (zero-padded) plane reads, and the same
fixed-point iteration as ops/nms.py resolves the greedy cascade. No top-K,
no gathers, no (K, K) matrix, and no capacity limit: ALL passing cells
participate, like the reference's dynamically-shaped host path.

Exactness guarantee (the "premise"):
  For boxes i, j with IoU > t:  inter > t * union >= t * max(a_i, a_j),
  and overlap_y <= min(h_i, h_j), so
    overlap_x >= inter / overlap_y > t * max(a_i, a_j) / min(h_i, h_j)
               >= t * max(w_i, w_j)
  (apply max(a_i,a_j) >= a_k with k the *other* box than the min-height one:
  a_k = w_k * h_k and h_k >= min(h_i, h_j)).  Since the boxes overlap,
  |cx_i - cx_j| <= (w_i + w_j)/2 - overlap_x < max(w)*(1 - t) <= Wmax*(1-t).
  Centers sit inside their cells, so the column distance obeys
  |col_i - col_j| < Wmax*(1-t)*Sx + 1.  Hence a window radius
    rx >= Wmax * (1 - t) * Sx        (same for ry with Hmax, Sy)
  sees EVERY suppressing pair, and the windowed fixed point equals global
  greedy NMS exactly - including the (score desc, original-cell-index asc)
  tie order of ops/nms.py, which maps to a direction constant per offset
  (a +offset neighbor always has the larger cell index).

  Conversely a given radius certifies boxes up to Wmax = rx / ((1-t)*Sx),
  Hmax = ry / ((1-t)*Sy).  At the defaults (rx=ry=4, t=0.5, 97x129 grid)
  that is 64x64 px on a 772x1032 image - ~1.5x the production anchor box.
  `windowed_count` returns an `exceeded` flag = any passing box beyond
  (Wmax, Hmax); a production caller would rerun flagged batches through
  the exact global path (ops/postprocess.py) so end-to-end semantics stay
  exact for arbitrary inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

# matches ops/nms.py: extents clipped so f32 area/inter products can't
# overflow to inf on diverged checkpoints (1e19^2 < f32 max)
_EXT_LIM = 1e19

DEFAULT_RADIUS = 4


def premise_extents(
    ry: int, rx: int, sy: int, sx: int, iou_thresh: float
) -> Tuple[float, float]:
    """Largest (Hmax, Wmax) normalized box extents for which a (ry, rx)
    window provably sees every pair with IoU > iou_thresh."""
    return ry / ((1.0 - iou_thresh) * sy), rx / ((1.0 - iou_thresh) * sx)


def _shift(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = a[..., y+dy, x+dx], `fill` outside the grid."""
    sy, sx = a.shape[-2], a.shape[-1]
    out = torch.full_like(a, fill)
    if abs(dy) >= sy or abs(dx) >= sx:
        return out
    out[..., max(0, -dy) : sy - max(0, dy), max(0, -dx) : sx - max(0, dx)] = a[
        ..., max(0, dy) : sy - max(0, -dy), max(0, dx) : sx - max(0, -dx)
    ]
    return out


def _half_offsets(ry: int, rx: int) -> List[Tuple[int, int]]:
    """Offsets with positive row-major direction: the (dy, dx) neighbor of
    any cell has a strictly larger original cell index. Each unordered cell
    pair within the full (2ry+1, 2rx+1) window appears exactly once."""
    return [
        (dy, dx)
        for dy in range(0, ry + 1)
        for dx in range(-rx, rx + 1)
        if not (dy == 0 and dx <= 0)
    ]


def windowed_count(
    preds: torch.Tensor,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
    ry: int = DEFAULT_RADIUS,
    rx: int = DEFAULT_RADIUS,
    image_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Selection-free fused count: decoded (B, 5+C, Sy, Sx) -> per-class
    survivor histogram, exact greedy-NMS semantics whenever `exceeded` is
    False. Runs on the device of `preds`; each round of the fixed point
    asks the host whether the keep mask still moves.

    Returns {"counts": (C,) int64, "exceeded": () bool, "keep": (B, Sy, Sx)}.
    `exceeded` True means some passing box was larger than the window's
    certified (Hmax, Wmax) - the result MAY then differ from global NMS and
    the caller should rerun the batch through the exact path.
    """
    b, d, sy, sx = preds.shape
    f = preds.float()
    cx, cy, w, h = f[:, 0], f[:, 1], f[:, 2], f[:, 3]
    obj = f[:, 4]
    class_probs = f[:, 5:]  # (B, C, Sy, Sx)

    passing = obj > obj_thresh
    if image_mask is not None:
        passing = passing & image_mask.to(device=f.device, dtype=torch.bool)[:, None, None]

    x1, y1 = cx - w / 2, cy - h / 2
    x2, y2 = cx + w / 2, cy + h / 2
    ew = torch.clamp(x2 - x1, 0, _EXT_LIM)
    eh = torch.clamp(y2 - y1, 0, _EXT_LIM)
    area = ew * eh
    # score and NaN ordering exactly as ops/nms.py:nms_fixed
    score = class_probs.amax(dim=1) * obj
    score = torch.where(torch.isnan(score), float("-inf"), score)

    hmax, wmax = premise_extents(ry, rx, sy, sx, iou_thresh)
    exceeded = torch.any(passing & ((ew > wmax) | (eh > hmax)))

    if iou_thresh > 0:
        offsets = _half_offsets(ry, rx)
        incoming = []  # [p]: neighbor at +offset suppresses this cell
        outgoing = []  # [p]: this cell suppresses neighbor at +offset
        for dy, dx in offsets:
            nx1 = _shift(x1, dy, dx, 0.0)
            ny1 = _shift(y1, dy, dx, 0.0)
            nx2 = _shift(x2, dy, dx, 0.0)
            ny2 = _shift(y2, dy, dx, 0.0)
            narea = _shift(area, dy, dx, 0.0)
            npass = _shift(passing, dy, dx, False)
            nscore = _shift(score, dy, dx, float("-inf"))
            iw = torch.clamp(torch.minimum(x2, nx2) - torch.maximum(x1, nx1), 0, _EXT_LIM)
            ih = torch.clamp(torch.minimum(y2, ny2) - torch.maximum(y1, ny1), 0, _EXT_LIM)
            inter = iw * ih
            iou = inter / (area + narea - inter)
            ov = (iou > iou_thresh) & passing & npass
            n_first = nscore > score  # ties: lower cell index = this cell
            incoming.append(ov & n_first)
            outgoing.append(ov & ~n_first)

        def suppressed_by_kept(keep: torch.Tensor) -> torch.Tensor:
            supp = torch.zeros_like(keep)
            for p, (dy, dx) in enumerate(offsets):
                supp = supp | (incoming[p] & _shift(keep, dy, dx, False))
                supp = supp | _shift(outgoing[p] & keep, -dy, -dx, False)
            return supp

        # same fixed-point recurrence as ops/nms.py: keep <- passing & no
        # kept neighbor suppresses me; unique fixed point = sequential
        # greedy NMS (at most one round a cell)
        keep, prev, it = passing & ~suppressed_by_kept(passing), passing, 0
        while it < sy * sx and bool(torch.any(keep != prev)):
            keep, prev, it = passing & ~suppressed_by_kept(keep), keep, it + 1
    else:
        keep = passing

    if min_class_confidence_threshold > 0:
        keep = keep & (class_probs.amax(dim=1) > min_class_confidence_threshold)

    cls = torch.argmax(class_probs, dim=1)  # (B, Sy, Sx)
    onehot = torch.nn.functional.one_hot(cls, d - 5)
    counts = (onehot * keep[..., None]).sum(dim=(0, 1, 2))
    return {"counts": counts, "exceeded": exceeded, "keep": keep}
