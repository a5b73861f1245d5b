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
