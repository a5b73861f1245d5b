"""Prediction drawing and small utilities (port of yogo_tpu/utils/drawing.py).

PIL equivalents of the reference's drawing helpers (reference:
yogo/utils/utils.py:29-264): a Timer context manager, HSL class colours,
boxes drawn onto a PIL image, chunked iteration. PIL is imported by the
function that draws, not at import.
"""

from __future__ import annotations

import colorsys
import time
from contextlib import contextmanager
from typing import Generator, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

from yogo_tpu_torch.ops.postprocess import format_preds

T = TypeVar("T")


@contextmanager
def Timer(description: str, precision: int = 5, post_print: bool = False):
    """Print-timing context manager (reference: yogo/utils/utils.py:29-47)."""
    try:
        start = time.perf_counter()
        if not post_print:
            print(f"{description}...", end=" ", flush=True)
        yield
    finally:
        end = time.perf_counter()
        print(f"{str(description) + ' ' if post_print else ''}{end - start:.{precision}f} s")


def iter_in_chunks(s: Sequence[T], n: int = 1) -> Generator[Sequence[T], None, None]:
    for i in range(0, len(s), n):
        yield s[i : i + n]


def bbox_colour(label_index: int, num_classes: int) -> Tuple[int, int, int, int]:
    """Deterministic per-class RGBA colour via HSL
    (reference: yogo/utils/utils.py:170-180)."""
    rate_factor, constant_factor = 5 / 3, 0
    hue = (label_index / num_classes * rate_factor + constant_factor) % 1
    r, g, b = colorsys.hls_to_rgb(hue, 0.5, 1.0)
    return int(r * 255), int(g * 255), int(b * 255), 255


def format_rects(
    prediction: np.ndarray,
    img_h: int,
    img_w: int,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
) -> np.ndarray:
    """(pred_dim, Sy, Sx) -> (N, 6) [x1px, y1px, x2px, y2px, class, objectness]
    (reference: yogo/utils/utils.py:143-167)."""
    preds = format_preds(
        prediction,
        obj_thresh=obj_thresh,
        iou_thresh=iou_thresh,
        box_format="xyxy",
        min_class_confidence_threshold=min_class_confidence_threshold,
    )
    rects = np.zeros((len(preds), 6), np.float32)
    if len(preds):
        rects[:, (0, 2)] = preds[:, (0, 2)] * img_w
        rects[:, (1, 3)] = preds[:, (1, 3)] * img_h
        rects[:, 4] = preds[:, 5:].argmax(axis=1)
        rects[:, 5] = preds[:, 4]
    return rects


def draw_yogo_prediction(
    img: np.ndarray,
    prediction: np.ndarray,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
    labels: Optional[List[str]] = None,
    images_are_normalized: bool = False,
):
    """Boxes and class labels drawn onto an image -> RGBA PIL image
    (reference: yogo/utils/utils.py:183-255). img is (H, W), (1, H, W) or
    3-channel CHW / HWC; prediction is one decoded (5+C, Sy, Sx) grid."""
    from PIL import Image, ImageDraw

    img = np.asarray(img).squeeze()
    prediction = np.asarray(prediction).squeeze()
    if images_are_normalized:
        img = img * 255
    img = img.astype(np.uint8)

    if img.ndim not in (2, 3):
        raise ValueError(
            "img must be 2-dimensional (grayscale) or 3-dimensional "
            f"(1 or 3 channels) but has {img.ndim} dimensions"
        )
    if img.ndim == 3:
        # the squeeze removed size-1 dims, so a 3-dim img is 3-channel in
        # CHW or HWC layout
        if img.shape[0] == 3:
            img = img.transpose(1, 2, 0)
        elif img.shape[2] != 3:
            raise ValueError(f"invalid image shape {img.shape}")
    if prediction.ndim != 3:
        raise ValueError(
            f"prediction must be unbatched (pred_dim, Sy, Sx) - got shape {prediction.shape}"
        )

    img_h, img_w = img.shape[:2]
    num_classes = prediction.shape[0] - 5
    rects = format_rects(
        prediction,
        img_h=img_h,
        img_w=img_w,
        obj_thresh=obj_thresh,
        iou_thresh=iou_thresh,
        min_class_confidence_threshold=min_class_confidence_threshold,
    )
    pil = Image.fromarray(img).convert("RGBA")
    draw = ImageDraw.Draw(pil)
    for r in rects:
        label_idx = int(r[4])
        label = labels[label_idx] if labels is not None else str(label_idx)
        draw.rectangle(
            [float(r[0]), float(r[1]), float(r[2]), float(r[3])],
            outline=bbox_colour(label_idx, num_classes=num_classes),
        )
        draw.text((float(r[0]), float(r[1])), label, fill=(0, 0, 0, 255))
    return pil
