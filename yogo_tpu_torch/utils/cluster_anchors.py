"""Anchor selection by k-means over label boxes (1 - IoU distance): the
port's copy of yogo_tpu/utils/cluster_anchors.py (numpy only, k_means
seeded the same way, so both packages pick the same anchors).

Numpy re-implementation of the reference anchor clustering (reference:
yogo/utils/cluster_anchors.py:24-146): corner/center conversions, vectorized
IoU, 20-iteration k-means, and best_anchor() which reduces label dirs to a
single (w, h) anchor.
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import List, Sequence, Tuple, Union

import numpy as np

# box layouts: corner = [xmin, xmax, ymin, ymax]; center = [xc, yc, w, h]


def centers_to_corners(b: np.ndarray) -> np.ndarray:
    return np.array(
        (
            b[..., 0] - b[..., 2] / 2,
            b[..., 0] + b[..., 2] / 2,
            b[..., 1] - b[..., 3] / 2,
            b[..., 1] + b[..., 3] / 2,
        )
    ).T


def corners_to_centers(b: np.ndarray) -> np.ndarray:
    return np.array(
        (
            (b[..., 1] + b[..., 0]) / 2,
            (b[..., 3] + b[..., 2]) / 2,
            (b[..., 1] - b[..., 0]),
            (b[..., 3] - b[..., 2]),
        )
    ).T


def iou(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """IoU over corner boxes [xmin, xmax, ymin, ymax], broadcastable."""

    def area(b):
        return np.abs((b[..., 1] - b[..., 0]) * (b[..., 3] - b[..., 2]))

    intersection = np.maximum(
        np.minimum(b1[..., [1, 3]], b2[..., [1, 3]])
        - np.maximum(b1[..., [0, 2]], b2[..., [0, 2]]),
        0,
    ).prod(-1)
    return intersection / (area(b1) + area(b2) - intersection)


def gen_random_box(n: int = 1, center_box: bool = False, rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    xmin = rng.random((n, 1)) / 2
    xmax = rng.random((n, 1)) / 2 + xmin
    ymin = rng.random((n, 1)) / 2
    ymax = rng.random((n, 1)) / 2 + ymin
    cb = np.hstack((xmin, xmax, ymin, ymax))
    return corners_to_centers(cb) if center_box else cb


def get_bounding_boxes(bb_dir: str, center_box: bool = False) -> np.ndarray:
    """Read every box from all .csv/.txt label files in a dir."""
    bbs = []
    for fname in sorted(
        glob.glob(f"{bb_dir}/*.csv") + glob.glob(f"{bb_dir}/*.txt")
    ):
        with open(fname, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                sep = "," if "," in line else " "
                vs = np.array([float(v) for v in line.split(sep)[1:]])
                bbs.append(vs if center_box else centers_to_corners(vs))
    if not bbs:
        print(bb_dir, "is empty!")
        # shape (0, 4), not (0,): np.vstack in get_dataset_bounding_boxes
        # needs matching trailing dims to combine with non-empty dirs
        return np.empty((0, 4))
    return np.array(bbs)


def get_dataset_bounding_boxes(
    bb_dirs: Sequence[Union[Path, str]], center_box: bool = False
) -> np.ndarray:
    return np.vstack(
        tuple(get_bounding_boxes(str(d), center_box=center_box) for d in bb_dirs)
    )


def k_means(data: np.ndarray, k: int = 3, seed: int = 0) -> np.ndarray:
    """k-means over corner boxes with 1 - IoU distance, 20 iterations."""
    rng = np.random.default_rng(seed)

    def dist(b1, b2):
        return 1 - iou(b1[:, np.newaxis, :], b2[np.newaxis, :, :])

    means = np.concatenate(
        [gen_random_box(rng=rng) for _ in range(k)], axis=0
    )
    for _ in range(20):
        groups = np.argmin(dist(data, means), axis=1)
        for m in range(k):
            sel = data[groups == m]
            if len(sel):
                means[m] = sel.mean(axis=0)
    return means


def _calculate_best_anchor(data: np.ndarray) -> Tuple[float, float]:
    corners = k_means(centers_to_corners(data), k=1)[0]
    centers = corners_to_centers(corners)
    return float(centers[2]), float(centers[3])


def best_anchor(label_paths: List[Union[Path, str]]) -> Tuple[float, float]:
    """label dirs -> single best (anchor_w, anchor_h)
    (reference: yogo/utils/cluster_anchors.py:143-146)."""
    bbs = get_dataset_bounding_boxes(label_paths, center_box=True)
    if len(bbs) == 0:
        # with zero boxes k-means would silently return its random init
        raise ValueError(f"no bounding boxes found in any of {label_paths}")
    return _calculate_best_anchor(bbs)
