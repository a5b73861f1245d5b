"""Inference driver: `python -m yogo_tpu_torch infer` and predict()
(port of yogo_tpu/infer.py:87-650, single device).

  - fixed-shape batches: the ragged last batch is padded by repeating its
    first image and the padding is masked out of the counts;
  - `--count` runs selection-first on the device: forward to the undecoded
    head, then filter -> top-K -> survivor decode -> NMS -> count, and only
    the (C,) counts come back;
  - return_full_predictions runs the decoded forward and the host formatter;
  - a one-thread prefetcher decodes the next batch while this one computes.

The per-batch work lives in `Predictor`, which other drivers (chip_smoke.py)
call directly with arrays.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from yogo_tpu_torch.data.image_source import ImagePathDataset
from yogo_tpu_torch.models.yogo import YOGO, ConvStack, resolve_device
from yogo_tpu_torch.ops.postprocess import (
    INFER_COUNT_MAX_DETECTIONS,
    count_class_predictions_raw,
    format_preds,
)
from yogo_tpu_torch.utils.checkpoint import load_checkpoint
from yogo_tpu_torch.utils.weights import state_dict_from_flax


class Predictor:
    """A loaded model on one device and the per-batch steps of predict():
    `forward_raw` (uint8 batch -> NHWC head), `count` (head + image mask ->
    per-class counts on the device) and `forward` (decoded predictions)."""

    def __init__(
        self,
        model: YOGO,
        stack: ConvStack,
        *,
        obj_thresh: float = 0.5,
        iou_thresh: float = 0.5,
        min_class_confidence_threshold: float = 0.0,
        max_detections: int = INFER_COUNT_MAX_DETECTIONS,
        meta: Optional[dict] = None,
    ):
        self.model = model
        self.meta = meta or {}
        self.stack = stack
        self.device = next(stack.parameters()).device
        self.obj_thresh = obj_thresh
        self.iou_thresh = iou_thresh
        self.min_class_confidence_threshold = min_class_confidence_threshold
        self.max_detections = max_detections

    @classmethod
    def from_checkpoint(
        cls,
        path_to_ckpt: Union[str, Path],
        *,
        half: bool = False,
        device=None,
        channels_last: bool = True,
        **thresholds,
    ) -> "Predictor":
        """Load a .ckpt onto `device` (default CUDA); `half` computes in
        bf16, which runs block 0 as the fused stem kernel."""
        model, variables, meta = load_checkpoint(path_to_ckpt)
        if half:
            model = model.with_compute_dtype(torch.bfloat16)
        stack = model.module(device, channels_last=channels_last)
        stack.load_state_dict(state_dict_from_flax(variables), strict=True)
        return cls(model, stack, meta=meta, **thresholds)

    def to_device(self, imgs) -> torch.Tensor:
        """(B, C, H, W) numpy or tensor -> tensor on the model's device."""
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        return imgs.to(self.device, non_blocking=True)

    def forward_raw(self, imgs) -> torch.Tensor:
        """(B, C, H, W) batch -> undecoded NHWC head (B, Sy, Sx, 5+C)."""
        return self.model.apply(self.stack, self.to_device(imgs), decode=False)

    def forward(self, imgs) -> torch.Tensor:
        """(B, C, H, W) batch -> decoded (B, 5+C, Sy, Sx) f32, class
        softmax applied."""
        return self.model.apply(self.stack, self.to_device(imgs), inference=True)

    def count(self, raw: torch.Tensor, image_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Head -> (C,) per-class detection counts, on the device."""
        m = self.model
        if image_mask is not None:
            image_mask = image_mask.to(raw.device)
        return count_class_predictions_raw(
            raw,
            m.anchor_w,
            m.anchor_h,
            width_multiplier=m.width_multiplier,
            height_multiplier=m.height_multiplier,
            obj_thresh=self.obj_thresh,
            iou_thresh=self.iou_thresh,
            min_class_confidence_threshold=self.min_class_confidence_threshold,
            max_detections=self.max_detections,
            image_mask=image_mask,
        )


def host_class_counts(
    batch_preds: np.ndarray,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
) -> np.ndarray:
    """Per-class counts of decoded (N, 5+C, Sy, Sx) predictions via the
    host formatter (reference: yogo/infer.py:60-87)."""
    total = np.zeros(batch_preds.shape[1] - 5, np.int64)
    for pred in batch_preds:
        rows = format_preds(
            pred,
            obj_thresh=obj_thresh,
            iou_thresh=iou_thresh,
            min_class_confidence_threshold=min_class_confidence_threshold,
        )
        if len(rows):
            np.add.at(total, rows[:, 5:].argmax(axis=1), 1)
    return total


def predict(
    path_to_ckpt: Union[str, Path],
    *,
    path_to_images: Union[str, Path],
    count_predictions: bool = False,
    return_full_predictions: bool = False,
    batch_size: int = 64,
    half: bool = False,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
    max_detections: int = INFER_COUNT_MAX_DETECTIONS,
    device=None,
) -> Optional[np.ndarray]:
    """Mirrors yogo_tpu.infer.predict for --count and full predictions on
    one device (default CUDA; device="cpu" runs on the CPU). Prints the
    per-class counts with count_predictions; returns (N, 5+C, Sy, Sx) f32
    with return_full_predictions."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    device = resolve_device(device)
    thresholds = dict(
        obj_thresh=obj_thresh,
        iou_thresh=iou_thresh,
        min_class_confidence_threshold=min_class_confidence_threshold,
        max_detections=max_detections,
    )
    pred = Predictor.from_checkpoint(path_to_ckpt, half=half, device=device, **thresholds)
    model = pred.model
    num_classes = model.num_classes
    class_names = pred.meta.get("class_names") or pred.meta.get("classes")
    if class_names is not None and len(class_names) != num_classes:
        warnings.warn(
            f"checkpoint lists {len(class_names)} class names but the "
            f"model has {num_classes} classes; falling back to indices"
        )
        class_names = None

    dataset = ImagePathDataset(
        path_to_images,
        normalize_images=bool(model.normalize_images),
        rgb=bool(model.is_rgb),
    )
    n_images = len(dataset)
    sx, sy = model.grid
    results = (
        np.zeros((n_images, 5 + num_classes, sy, sx), np.float32)
        if return_full_predictions
        else None
    )
    tot_counts = torch.zeros(num_classes, dtype=torch.int64, device=device)
    host_counts = np.zeros(num_classes, np.int64)

    def load_batch(start: int):
        items = [dataset[i] for i in range(start, min(start + batch_size, n_images))]
        imgs = np.stack([im for im, _ in items])
        real = len(items)
        if real < batch_size:  # pad to the fixed batch shape
            imgs = np.concatenate([imgs, np.repeat(imgs[:1], batch_size - real, axis=0)])
        return imgs, real

    starts = list(range(0, n_images, batch_size))
    with ThreadPoolExecutor(max_workers=1) as prefetcher:
        pending = prefetcher.submit(load_batch, starts[0])
        for bi, start in enumerate(starts):
            imgs, real = pending.result()
            if bi + 1 < len(starts):
                pending = prefetcher.submit(load_batch, starts[bi + 1])
            if return_full_predictions:
                res = pred.forward(imgs).cpu().numpy()[:real]
                results[start : start + real] = res
                if count_predictions:
                    host_counts += host_class_counts(
                        res, obj_thresh, iou_thresh, min_class_confidence_threshold
                    )
            elif count_predictions:
                mask = torch.arange(batch_size) < real
                tot_counts += pred.count(pred.forward_raw(imgs), mask)

    if count_predictions:
        counts = host_counts if return_full_predictions else tot_counts.cpu().numpy()
        print(list(zip(class_names or range(num_classes), map(int, counts))))
    return results
