"""Non-maximal suppression: fixed-capacity batched NMS + host oracle
(port of yogo_tpu/ops/nms.py).

`batched_nms` resolves greedy NMS over padded (B, K) slots on the device
the input lies on, with no device-to-host sync on a CUDA tensor:

  - CUDA tensors launch csrc/nms.cu: one block an image ranks the valid
    slots, fills the rank-ordered suppression bitmask and scans it with one
    warp (the JAX package's `while_loop`, yogo_tpu/ops/nms.py:68-89, in one
    launch). It raises on what it does not take; nothing falls back.
  - CPU tensors take the plain version, `batched_nms_reference` (any
    device): the JAX package's formulation, one (K, K) IoU matrix an image
    and greedy suppression resolved by fixed-point iteration
    (keep[j] <- no higher-priority *kept* box overlaps j), whose unique
    fixed point is exactly sequential greedy NMS. The iteration is a Python
    loop capped at K+1 rounds that stops when `keep` stops changing; each
    test costs one device->host sync.

Both give the same keep bit for bit (the kernel computes the IoU op for op
as the torch chain does). The counters of utils/tracing.COUNTS: `nms_calls`
counts every resolve on either path, `nms_kernel_launches` the kernel's,
`nms_rounds` and `nms_host_syncs` the loop's keep updates and syncs.
Tie-breaking follows torch: stable sort, strictly-greater-than-threshold
suppression.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from yogo_tpu_torch import kernels
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


def _suppression(boxes, scores, valid, iou_threshold, tiebreak=None) -> torch.Tensor:
    """The (..., K, K) suppression relation of batched_nms_reference
    (suppress[i, j]: i precedes and suppresses j): the torch chain the
    kernel replaces, before the loop.

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
    return (iou > iou_threshold) & precedes & valid[..., :, None] & valid[..., None, :]


def batched_nms_reference(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    tiebreak: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version of batched_nms, on any device: the (B, K, K) torch
    chain (_suppression) and the fixed-point loop (one host sync a
    round)."""
    suppress = _suppression(boxes, scores, valid, iou_threshold, tiebreak)
    return _greedy_keep_from_suppression(suppress) & valid


def _workspace_bytes(k: int) -> int:
    """Bytes of csrc/nms.cu's workspace an image for K slots (its Layout:
    two float4 arrays, the (K, ceil(K/64)) u64 bitmask, two int64 arrays,
    five 4-byte arrays and the kept bytes, rounded up to 256)."""
    nw = (k + 63) // 64
    return -(-k * (69 + 8 * nw) // 256) * 256


def _check_args(boxes, scores, valid, tiebreak) -> None:
    """Raise on what the kernel does not take: (B, K, 4) f32 boxes, (B, K)
    f32 scores, bool valid and int64 tiebreak (or None), K >= 1, one
    device."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.shape[1] < 1:
        raise ValueError(f"boxes must be (B, K, 4) with K >= 1, got {tuple(boxes.shape)}")
    bk = boxes.shape[:2]
    for name, t, dtype in (("boxes", boxes, torch.float32), ("scores", scores, torch.float32),
                           ("valid", valid, torch.bool), ("tiebreak", tiebreak, torch.int64)):
        if t is None:
            continue
        if name != "boxes" and t.shape != bk:
            raise ValueError(f"{name} must be {tuple(bk)}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != boxes.device:
            raise ValueError(f"{name} is on {t.device}, boxes on {boxes.device}: one device")


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

    CPU tensors take batched_nms_reference; CUDA tensors ((B, K, 4) f32,
    (B, K) f32, bool, int64) launch csrc/nms.cu on the current stream,
    with no sync."""
    if boxes.device.type == "cpu":
        return batched_nms_reference(boxes, scores, valid, iou_threshold, tiebreak)
    _check_args(boxes, scores, valid, tiebreak)
    dev = boxes.device
    if dev.type != "cuda":
        raise ValueError(f"no NMS kernel for device {dev}")
    b, k = scores.shape
    if tiebreak is None:
        tiebreak = torch.arange(k, device=dev).expand(b, k)
    out = torch.empty((b, k), dtype=torch.bool, device=dev)
    if b == 0:
        return out
    boxes, scores, valid, tiebreak = (t.contiguous() for t in (boxes, scores, valid, tiebreak))
    lib = kernels.load("nms")
    scratch = torch.empty(b * _workspace_bytes(k), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = lib.yogo_nms_launch(
            boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), tiebreak.data_ptr(),
            float(iou_threshold), b, k, out.data_ptr(), scratch.data_ptr(), scratch.numel(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(lib, code, "NMS kernel")
    tracing.add(nms_calls=1, nms_kernel_launches=1)
    return out


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
