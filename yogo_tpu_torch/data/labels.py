"""YOLO-format label file parsing -> label grids.

Host-side (numpy) re-implementation of the reference label loading
(reference: yogo/data/yogo_dataset.py:17-133): csv-dialect sniffing (space or
comma separated, optional header), the ~200 px^2 area filter, notes.json
class-id remapping, cxcywh->xyxy conversion, and the (6, Sy, Sx) grid
encoding [mask, x1, y1, x2, y2, class].
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from yogo_tpu_torch.ops.grid import encode_label_grid_np

LABEL_TENSOR_PRED_DIM_SIZE = 1 + 4 + 1

# boxes under ~200 px^2 at the canonical 772x1032 resolution are dropped
# (reference: yogo/data/yogo_dataset.py:19-21)
AREA_FILTER_THRESHOLD = 200 / (772 * 1032)


def correct_label_idx(
    label: str,
    classes: List[str],
    notes_data: Optional[Dict[str, Any]] = None,
) -> int:
    """Map a raw label token to a class index, honoring notes.json category
    remapping (reference: yogo/data/yogo_dataset.py:49-69)."""
    if notes_data is None:
        return int(label)
    if label.isnumeric():
        label_name: Optional[str] = None
        for row in notes_data["categories"]:
            if int(label) == int(row["id"]):
                label_name = row["name"]
                break
        if label_name is None:
            raise ValueError(f"label index {label} not found in notes.json file")
        return classes.index(label_name)
    return classes.index(label)


def load_labels(
    label_path: Union[str, Path],
    classes: List[str],
    notes_data: Optional[Dict[str, Any]] = None,
) -> List[List[float]]:
    """Parse one YOLO txt file -> [[class_idx, xc, yc, w, h], ...]."""
    # fast path: native C parser (no dialect sniffing overhead); falls back to
    # python when class tokens are names or a notes.json remap is active
    if notes_data is None:
        from yogo_tpu_torch import native

        rows = native.parse_labels(label_path)
        if rows is not None and (len(rows) == 0 or (rows[:, 0] >= 0).all()):
            return [
                [float(c), float(xc), float(yc), float(w), float(h)]
                for c, xc, yc, w, h in rows
                if w * h >= AREA_FILTER_THRESHOLD
            ]

    labels: List[List[float]] = []
    with open(label_path, "r") as f:
        chunk = f.read(1024)
        f.seek(0)
        try:
            dialect = csv.Sniffer().sniff(chunk)
            reader = csv.reader(f, dialect)
        except csv.Error:
            # empty file: no labels
            return []

        # header detection: the reference uses csv.Sniffer().has_header,
        # which misfires on single-row numeric files; instead treat the first
        # row as a header iff its coordinate fields don't parse as floats
        first = next(reader, None)
        if first is None:
            return []
        try:
            [float(v) for v in first[1:]]
            rows = [first]
        except ValueError:
            rows = []

        for row in rows + list(reader):
            if len(row) != 5:
                raise ValueError(
                    f"should have [class,xc,yc,w,h] - got length {len(row)} {row}"
                )
            xc, yc, w, h = map(float, row[1:])
            if w * h < AREA_FILTER_THRESHOLD:
                continue
            label_idx = correct_label_idx(row[0], classes, notes_data)
            labels.append([float(label_idx), xc, yc, w, h])
    return labels


def read_notes_json(label_dir: Union[str, Path]) -> Optional[Dict[str, Any]]:
    """Load the notes.json sidecar next to a label dir, if present
    (reference: yogo/data/yogo_dataset.py:215-217)."""
    notes_path = Path(label_dir).parent / "notes.json"
    if notes_path.exists():
        with open(notes_path, "r") as f:
            return json.load(f)
    return None


def labels_to_grid(
    labels: Union[List[List[float]], np.ndarray], Sx: int, Sy: int
) -> np.ndarray:
    """[[cls, xc, yc, w, h], ...] (list or (k, 5) array) -> (6, Sy, Sx)
    grid (cxcywh -> xyxy first)."""
    if len(labels) == 0:
        return np.zeros((LABEL_TENSOR_PRED_DIM_SIZE, Sy, Sx), np.float32)
    arr = np.asarray(labels, np.float32)
    xyxy = np.empty_like(arr)
    xyxy[:, 0] = arr[:, 0]
    xyxy[:, 1] = arr[:, 1] - arr[:, 3] / 2
    xyxy[:, 2] = arr[:, 2] - arr[:, 4] / 2
    xyxy[:, 3] = arr[:, 1] + arr[:, 3] / 2
    xyxy[:, 4] = arr[:, 2] + arr[:, 4] / 2
    return encode_label_grid_np(xyxy, Sx, Sy)


def label_file_to_grid(
    label_path: Union[str, Path],
    Sx: int,
    Sy: int,
    classes: List[str],
    notes_data: Optional[Dict[str, Any]] = None,
) -> np.ndarray:
    try:
        labels = load_labels(label_path, classes=classes, notes_data=notes_data)
    except Exception as e:
        raise RuntimeError(f"exception from {label_path}") from e
    return labels_to_grid(labels, Sx, Sy)
