"""Host-side image IO and small data utilities.

PIL-based replacements for the reference's torchvision.io C decoders
(reference: yogo/data/utils.py:16-63): grayscale/RGB decode returning CHW
uint8 numpy and retry-with-backoff robustness. PIL is imported inside the
functions that decode, so the package imports without it. (The
ultralytics-format dataset exporter is not ported yet.)
"""

from __future__ import annotations

import warnings
from pathlib import Path
from time import sleep
from typing import List, Optional, Tuple, Union

import numpy as np


def read_image(img_path: Union[str, Path], rgb: bool = False) -> np.ndarray:
    """Decode an image to (C, H, W) uint8 (C=1 grayscale or 3 RGB)."""
    from PIL import Image

    try:
        with Image.open(img_path) as im:
            im = im.convert("RGB" if rgb else "L")
            arr = np.asarray(im, np.uint8)
    except Exception as e:
        raise RuntimeError(f"file {img_path} threw: {e}") from e
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


def read_image_robust(
    img_path: Union[str, Path],
    retries: int = 3,
    min_duration: float = 0.1,
    rgb: bool = False,
) -> Optional[np.ndarray]:
    """Retry-with-backoff image read; returns None after exhausting retries
    (reference: yogo/data/utils.py:24-46)."""
    for i in range(retries):
        try:
            return read_image(img_path, rgb=rgb)
        except Exception as e:
            warnings.warn(f"file {img_path} threw: {e}")
            if i == retries - 1:
                warnings.warn(f"all attempts to read {img_path} failed")
                break
            sleep(min_duration * (2**retries))
    return None


def resize_image(img_chw: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Antialiased bilinear resize to (H, W), preserving channel count.

    PIL's bilinear resize applies the antialias filter on downscale, matching
    torchvision Resize(antialias=True) behavior (reference:
    yogo/data/yogo_dataset.py:160) at the detection-level tolerance.
    """
    c, h, w = img_chw.shape
    if (h, w) == tuple(hw):
        return img_chw
    from PIL import Image

    out = np.empty((c, hw[0], hw[1]), img_chw.dtype)
    for i in range(c):
        out[i] = np.asarray(
            Image.fromarray(img_chw[i]).resize(
                (hw[1], hw[0]), Image.Resampling.BILINEAR
            )
        )
    return out


def collate_batch_robust(samples: List[Optional[Tuple[np.ndarray, np.ndarray]]]):
    """Drop failed (None) samples, stack the rest
    (reference: yogo/data/utils.py:49-63)."""
    pairs = [p for p in samples if p is not None]
    if not pairs:
        return None
    imgs, labels = zip(*pairs)
    return np.stack(imgs), np.stack(labels)
