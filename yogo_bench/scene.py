"""The golden scene, frozen here: synthetic 772x1032 brightfield frames of
two blob classes on a noisy background, with their labels.

The drawing is yogo_tpu_torch/tools/golden_scene.py's gen_golden_images
(itself tests/test_golden_fullres.py's generator), with one change: each
frame draws from its own generator, seeded by (seed, index), so that any
process can make any frame of a pool without making the ones before it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

HW = (772, 1032)
# class -> (height, width) in pixels; class 0 is drawn at grey 60, class 1 at 130
BLOBS = {0: (36, 36), 1: (24, 48)}


def frame(seed: int, index: int, hw=HW, blobs: Sequence[int] = (20, 60)) -> Tuple[np.ndarray, np.ndarray]:
    """((1, H, W) uint8, (N, 5) float32 labels [class, x1, y1, x2, y2] in
    image fractions): frame `index` of the pool of `seed`, with between
    blobs[0] and blobs[1] blobs."""
    h, w = hw
    r = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, int(index)])
    arr = np.full((h, w), 225, np.uint8)
    rows = []
    for _ in range(int(r.integers(blobs[0], blobs[1] + 1))):
        cls = int(r.integers(0, 2))
        bh, bw = BLOBS[cls]
        y = int(r.integers(2, h - 2 - bh))
        x = int(r.integers(2, w - 2 - bw))
        arr[y: y + bh, x: x + bw] = 60 if cls == 0 else 130
        rows.append([cls, x / w, y / h, (x + bw) / w, (y + bh) / h])
    arr += r.integers(0, 12, arr.shape, dtype=np.uint8)
    return arr[None], np.asarray(rows, np.float32).reshape(-1, 5)


def pool(seed: int, indices: Sequence[int], hw=HW, blobs=(20, 60)) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Frames `indices` of the pool of `seed`: ((n, 1, H, W) uint8, labels)."""
    frames, labels = zip(*(frame(seed, i, hw, blobs) for i in indices))
    return np.stack(frames), list(labels)


def label_grid(labels: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """(N, 5) [class, x1, y1, x2, y2] -> (6, Sy, Sx) [mask, x1, y1, x2, y2,
    class]: each box in the cell that holds its centre, the last box of a
    cell kept (the reference's yogo/data/yogo_dataset.py:24-46)."""
    out = np.zeros((6, sy, sx), np.float32)
    labels = np.asarray(labels, np.float32).reshape(-1, 5)
    ii = ((labels[:, 1] + labels[:, 3]) * sx // 2).astype(np.int64)
    jj = ((labels[:, 2] + labels[:, 4]) * sy // 2).astype(np.int64)
    ok = (labels[:, 0] >= 0) & (ii >= 0) & (ii < sx) & (jj >= 0) & (jj < sy)
    for i, j, row in zip(ii[ok], jj[ok], labels[ok]):
        out[0, j, i] = 1.0
        out[1:5, j, i] = row[1:]
        out[5, j, i] = row[0]
    return out
