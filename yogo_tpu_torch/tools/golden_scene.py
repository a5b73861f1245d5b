"""The golden scene of the scripts that run on a GPU machine (chip_smoke.py,
tools/serve_profile.py)."""

from __future__ import annotations

import numpy as np

HW = (772, 1032)


def gen_golden_images(n: int = 4, seed: int = 3, hw=HW):
    """((n, 1, 772, 1032) uint8, n label arrays (N_i, 5) [class, x1, y1,
    x2, y2] in image fractions): the frozen generator of
    tests/test_golden_fullres.py (gen_test_images), without the PNG round
    trip (which is lossless), and with every blob's class and rectangle."""
    h, w = hw
    blobs = {0: (36, 36), 1: (24, 48)}
    r = np.random.default_rng(seed)
    out, labels = [], []
    for _ in range(n):
        arr = np.full((h, w), 225, np.uint8)
        rows = []
        for _ in range(int(r.integers(20, 61))):
            cls = int(r.integers(0, 2))
            bh, bw = blobs[cls]
            y = int(r.integers(2, h - 2 - bh))
            x = int(r.integers(2, w - 2 - bw))
            arr[y : y + bh, x : x + bw] = 60 if cls == 0 else 130
            rows.append([cls, x / w, y / h, (x + bw) / w, (y + bh) / h])
        arr += r.integers(0, 12, arr.shape).astype(np.uint8)
        out.append(arr)
        labels.append(np.asarray(rows, np.float32))
    return np.stack(out)[:, None], labels


def _xyxy(d: np.ndarray) -> np.ndarray:
    return np.stack([d[:, 0] - d[:, 2] / 2, d[:, 1] - d[:, 3] / 2,
                     d[:, 0] + d[:, 2] / 2, d[:, 1] + d[:, 3] / 2], axis=1)


def greedy_iou_match(a: np.ndarray, b: np.ndarray, thresh: float = 0.5):
    """(i, j, iou) pairs greedily matched one to one between two cxcywh
    detection lists, best IoU first (tests/test_golden_fullres_int8.py's
    matcher)."""
    if len(a) == 0 or len(b) == 0:
        return []
    A, B = _xyxy(a), _xyxy(b)
    lt = np.maximum(A[:, None, :2], B[None, :, :2])
    rb = np.minimum(A[:, None, 2:], B[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = ((A[:, 2] - A[:, 0]) * (A[:, 3] - A[:, 1]))[:, None] + (
        (B[:, 2] - B[:, 0]) * (B[:, 3] - B[:, 1]))[None] - inter
    iou = inter / (union + 1e-9)
    out, used = [], set()
    for i in np.argsort(-iou.max(axis=1)):
        for j in np.argsort(-iou[i]):
            if j not in used and iou[i, j] >= thresh:
                used.add(int(j))
                out.append((int(i), int(j), float(iou[i, j])))
                break
    return out


def int8_gates(dets, golden) -> dict:
    """The int8 golden gates of tests/test_golden_fullres_int8.py: `dets`,
    per image the (N, 5+C) cxcywh detections of the int8 program, against
    golden[f"dets_{i}"], the committed bf16 ones. Every image within 2
    detections, every matched IoU > 0.8 with the same argmax class, >= 97%
    matched, mean IoU > 0.94. Returns the numbers, with "failures" (empty
    when every gate holds)."""
    per_image, n_gold, n_int8, ious, failures = [], 0, 0, [], []
    for i, d in enumerate(dets):
        g = golden[f"dets_{i}"]
        per_image.append(len(d))
        n_gold, n_int8 = n_gold + len(g), n_int8 + len(d)
        if abs(len(d) - len(g)) > 2:
            failures.append(f"image {i}: int8 {len(d)} detections vs bf16 {len(g)}")
        for ii, jj, iou in greedy_iou_match(d, g):
            if iou <= 0.8 or d[ii, 5:].argmax() != g[jj, 5:].argmax():
                failures.append(f"image {i}: matched IoU {iou:.3f}, classes "
                                f"{d[ii, 5:].argmax()} / {g[jj, 5:].argmax()}")
            ious.append(iou)
    mean_iou = float(np.mean(ious)) if ious else 0.0
    if not n_gold or len(ious) < 0.97 * max(n_gold, n_int8) or mean_iou <= 0.94:
        failures.append(f"matched {len(ious)} of bf16 {n_gold} / int8 {n_int8}, mean IoU {mean_iou:.3f}")
    return {"per_image": per_image, "golden": n_gold, "int8": n_int8, "matched": len(ious),
            "mean_iou": mean_iou, "min_iou": float(np.min(ious)) if ious else 0.0, "failures": failures}
