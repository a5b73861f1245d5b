"""Host-side image IO and small data utilities.

PIL-based replacements for the reference's torchvision.io C decoders
(reference: yogo/data/utils.py:16-63): grayscale/RGB decode returning CHW
uint8 numpy, retry-with-backoff robustness, and the ultralytics-format
dataset exporter. PIL and yaml are imported inside the functions that use
them, so the package imports without them.
"""

from __future__ import annotations

import os
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


def convert_dataset_definition_to_ultralytics_format(
    dataset_definition_path: Path, target_dir: Path
) -> None:
    """Symlink-tree + yaml exporter for ultralytics-format training
    (reference: yogo/data/utils.py:66-138)."""
    import yaml

    from yogo_tpu_torch.data.definition import DatasetDefinition

    defn = DatasetDefinition.from_yaml(dataset_definition_path)
    target_dir = Path(target_dir)
    target_dir.mkdir(exist_ok=True, parents=True)
    train_dir = target_dir / "train"
    val_dir = target_dir / "val"
    train_dir.mkdir(exist_ok=True)
    val_dir.mkdir(exist_ok=True)

    def link_specs(specs, base_dir):
        out_paths = []
        for spec in specs:
            d = base_dir / spec.image_path.parent.name
            d.mkdir(exist_ok=True)
            for src, name in ((spec.image_path, "images"), (spec.label_path, "labels")):
                try:
                    os.symlink(src, d / name)
                except FileExistsError:
                    pass
            out_paths.append(str(d / "images"))
        return out_paths

    train_paths = link_specs(defn.dataset_paths, train_dir)
    test_paths = link_specs(defn.test_dataset_paths, val_dir)

    with open(target_dir / "dataset_defn.yaml", "w") as f:
        yaml.safe_dump(
            {
                "path": str(target_dir.resolve()),
                "train": train_paths,
                "val": test_paths,
                "names": dict(enumerate(defn.classes)),
            },
            f,
            default_flow_style=False,
        )
