"""Inference image sources: a directory of PNGs or one PNG file (port of
yogo_tpu/data/image_source.py: ImagePathDataset, center_crop).

Items are (CHW uint8 numpy, name). PIL is imported by the reader only, so
machines without it can import this module and feed arrays instead.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np


def read_image(img_path: Union[str, Path], rgb: bool = False) -> np.ndarray:
    """Decode an image to (C, H, W) uint8 (C=1 grayscale or 3 RGB)."""
    from PIL import Image

    try:
        with Image.open(img_path) as im:
            arr = np.asarray(im.convert("RGB" if rgb else "L"), np.uint8)
    except OSError as e:
        raise RuntimeError(f"file {img_path} threw: {e}") from e
    return arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)


class ImagePathDataset:
    """Sorted *.png files from a directory (or one .png file), hidden files
    skipped."""

    def __init__(
        self,
        root: Union[str, Path],
        crop_hw: Optional[Tuple[int, int]] = None,
        normalize_images: bool = False,
        rgb: bool = False,
    ):
        self.root = Path(root)
        if not self.root.exists():
            raise FileNotFoundError(f"{self.root} does not exist")
        if self.root.is_file() and self.root.suffix == ".png":
            paths = [self.root]
        else:
            paths = sorted(
                p for p in self.root.glob("*.png") if not p.name.startswith(".")
            )
        if not paths:
            raise FileNotFoundError(f"{self.root} does not contain any images")
        self.image_paths = [str(p) for p in paths]
        self.crop_hw = crop_hw
        self.normalize_images = normalize_images
        self.rgb = rgb

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        path = self.image_paths[idx]
        img = center_crop(read_image(path, rgb=self.rgb), self.crop_hw)
        if self.normalize_images:
            img = img.astype(np.float32) / 255.0
        return img, path


def center_crop(
    img_chw: np.ndarray, crop_hw: Optional[Tuple[int, int]]
) -> np.ndarray:
    """torchvision CenterCrop semantics (reference: yogo/infer.py:220-226):
    zero-pad symmetrically when the image is smaller than the target, and
    place the window at round((h-th)/2) with Python's rounding."""
    if crop_hw is None:
        return img_chw
    th, tw = crop_hw
    _, h, w = img_chw.shape
    if th > h or tw > w:
        pt = (th - h) // 2 if th > h else 0
        pb = (th - h + 1) // 2 if th > h else 0
        pl = (tw - w) // 2 if tw > w else 0
        pr = (tw - w + 1) // 2 if tw > w else 0
        img_chw = np.pad(img_chw, ((0, 0), (pt, pb), (pl, pr)))
        _, h, w = img_chw.shape
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return img_chw[:, top : top + th, left : left + tw]
