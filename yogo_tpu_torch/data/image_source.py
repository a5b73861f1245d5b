"""Inference image sources: directories of PNGs, single files, or zarr
stores (port of yogo_tpu/data/image_source.py).

Items are (CHW uint8 numpy, name). PIL is imported by the reader only
(data/utils.read_image), so machines without it can import this module and
feed arrays instead; zarr support is gated on the zarr package being
importable, as in the JAX package.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np

from yogo_tpu_torch.data.utils import read_image


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


class ZarrDataset:
    """Images from a zarr array ((H, W, N) stack) or group, with synthesized
    zero-padded names (reference: yogo/data/image_path_dataset.py:76-126)."""

    def __init__(
        self,
        zarr_path: Union[str, Path],
        image_name_from_idx: Optional[Callable[[int], str]] = None,
        crop_hw: Optional[Tuple[int, int]] = None,
        normalize_images: bool = False,
    ):
        try:
            import zarr
        except ImportError as e:
            raise ImportError("zarr is not installed; use --path-to-images instead") from e

        self.zarr_path = Path(zarr_path)
        if not self.zarr_path.exists():
            raise FileNotFoundError(f"{self.zarr_path} does not exist")
        self.store = zarr.open(str(self.zarr_path), mode="r")
        self._is_array = isinstance(self.store, zarr.Array)
        self.image_name_from_idx = image_name_from_idx or self._default_name
        self.crop_hw = crop_hw
        self.normalize_images = normalize_images
        self._N = int(math.log(max(len(self), 1), 10) + 1)

    def _default_name(self, idx: int) -> str:
        return f"img_{idx:0{self._N}}.png"

    def __len__(self) -> int:
        if self._is_array:
            return self.store.initialized
        return len(self.store)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        if self._is_array:
            img = np.asarray(self.store[:, :, idx])[None]
        else:
            img = np.asarray(self.store[idx][:])[None]
        img = center_crop(img, self.crop_hw)
        if self.normalize_images:
            img = img.astype(np.float32) / 255.0
        return img, self.image_name_from_idx(idx)


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


def get_dataset(
    path_to_images: Optional[Union[str, Path]] = None,
    path_to_zarr: Optional[Union[str, Path]] = None,
    crop_hw: Optional[Tuple[int, int]] = None,
    normalize_images: bool = False,
    rgb: bool = False,
) -> Union[ImagePathDataset, ZarrDataset]:
    """One of two sources, exclusively
    (reference: yogo/data/image_path_dataset.py:136-159)."""
    if path_to_images is not None and path_to_zarr is not None:
        raise ValueError(
            "can only take one of 'path_to_images' or 'path_to_zarr', but got both"
        )
    if path_to_images is not None:
        return ImagePathDataset(
            path_to_images, crop_hw=crop_hw, normalize_images=normalize_images, rgb=rgb
        )
    if path_to_zarr is not None:
        if rgb:
            # zarr stacks are (H, W, N) single-channel: a 3-channel model
            # would only fail later as a conv channel mismatch
            raise ValueError(
                "zarr sources are single-channel; an RGB checkpoint cannot "
                "be used with --path-to-zarr"
            )
        return ZarrDataset(path_to_zarr, crop_hw=crop_hw, normalize_images=normalize_images)
    raise ValueError("one of 'path_to_images' or 'path_to_zarr' must not be None")
