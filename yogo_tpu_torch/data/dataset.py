"""Object-detection dataset: (image dir, label dir) -> (uint8 CHW image, label grid).

Host-side counterpart of the reference dataset (reference:
yogo/data/yogo_dataset.py:136-301): pairs every label txt with a .png/.jpg
image, errors listing missing images, loads notes.json remapping, decodes +
resizes images, encodes label grids. Paths are stored as numpy unicode
arrays (cheap to fork/share; no per-item python object churn).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from yogo_tpu_torch.data.labels import (
    label_file_to_grid,
    load_labels,
    read_notes_json,
)
from yogo_tpu_torch.data.utils import read_image_robust, resize_image

IMAGE_EXTENSIONS = (".png", ".jpg")


class ObjectDetectionDataset:
    def __init__(
        self,
        image_folder_path: Union[str, Path],
        label_folder_path: Union[str, Path],
        Sx: int,
        Sy: int,
        classes: List[str],
        image_hw: Tuple[int, int] = (772, 1032),
        rgb: bool = False,
        normalize_images: bool = False,
    ):
        self.image_folder_path = Path(image_folder_path)
        self.label_folder_path = Path(label_folder_path)
        self.Sx = Sx
        self.Sy = Sy
        self.classes = classes
        self.image_hw = tuple(image_hw)
        self.rgb = rgb
        self.normalize_images = normalize_images
        self.notes_data: Optional[Dict[str, Any]] = read_notes_json(
            self.label_folder_path
        )

        image_paths, label_paths = self._pair_files()
        self._image_paths = np.array(image_paths, dtype=np.str_)
        self._label_paths = np.array(label_paths, dtype=np.str_)

    def _pair_files(self) -> Tuple[List[str], List[str]]:
        """Pair label txt files to images; raise FileNotFoundError listing
        missing images (reference: yogo/data/yogo_dataset.py:224-262)."""
        image_paths: List[str] = []
        label_paths: List[str] = []
        missing: List[str] = []

        for label_file in sorted(self.label_folder_path.glob("*.txt")):
            if label_file.name.startswith("."):
                continue
            for sfx in IMAGE_EXTENSIONS:
                candidate = self.image_folder_path / label_file.with_suffix(sfx).name
                if candidate.exists():
                    image_paths.append(str(candidate))
                    label_paths.append(str(label_file))
                    break
            else:
                missing.append(str(label_file))
                if len(missing) >= 10:
                    break

        if missing:
            sample = missing if len(missing) < 5 else missing[:3]
            raise FileNotFoundError(
                f"{'at least ' if len(missing) >= 10 else ''}{len(missing)} "
                f"images not found in {self.image_folder_path}; "
                f"({len(image_paths)} images were found). Sample of missing:\n"
                f"{sample}"
            )
        return image_paths, label_paths

    def __len__(self) -> int:
        return len(self._image_paths)

    def load_image(self, index: int) -> Optional[np.ndarray]:
        """Decode + resize one image to uint8 (C, H, W); None on failure.
        Shared by __getitem__ and the packed-cache build
        (data/packed_cache.py)."""
        # fast path: fused native decode+antialias-resize (C++, libpng/libjpeg)
        from yogo_tpu_torch import native

        image = native.decode_image(
            self._image_paths[index],
            self.image_hw,
            channels=3 if self.rgb else 1,
        )
        if image is None:
            # fallback: python decode with retry/backoff
            image = read_image_robust(self._image_paths[index], rgb=self.rgb)
            if image is None:
                return None
            image = resize_image(image, self.image_hw)
        return image

    def __getitem__(
        self, index: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        image = self.load_image(index)
        if image is None:
            return None
        labels = label_file_to_grid(
            self._label_paths[index],
            self.Sx,
            self.Sy,
            self.classes,
            self.notes_data,
        )
        if self.normalize_images:
            image = image.astype(np.float32) / 255.0
        return image, labels

    def calc_class_counts(self) -> np.ndarray:
        """(num_classes,) occurrence counts over the whole dataset
        (reference: yogo/data/yogo_dataset.py:289-301)."""
        counts = np.zeros(len(self.classes), np.int64)
        for label_path in self._label_paths:
            for row in load_labels(
                label_path, classes=self.classes, notes_data=self.notes_data
            ):
                counts[int(row[0])] += 1
        return counts


class ConcatDataset:
    """Concatenation of map-style datasets (like torch's ConcatDataset)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.cumulative_sizes[-1]) if len(self.datasets) else 0

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self.cumulative_sizes[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]

    def set_epoch(self, epoch: int) -> None:
        """Forward the epoch to children that resample per epoch
        (BlobDataset)."""
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def get_batch(self, indices):
        """Vectorized batch read (see PackedDataset.get_batch), routing
        each index to its child; None when any child lacks the fast path
        (e.g. the per-epoch-resampling BlobDataset) - the caller then
        falls back to per-item reads."""
        if not all(hasattr(d, "get_batch") for d in self.datasets):
            return None
        idxs = np.asarray(indices, np.int64)
        ds_idx = np.searchsorted(self.cumulative_sizes, idxs, side="right")
        starts = np.concatenate([[0], self.cumulative_sizes[:-1]])
        imgs = labels = valid = None
        for d in np.unique(ds_idx):
            sel = ds_idx == d
            res = self.datasets[int(d)].get_batch(idxs[sel] - starts[int(d)])
            if res is None:
                return None
            if imgs is None:
                imgs = np.empty((len(idxs), *res[0].shape[1:]), res[0].dtype)
                labels = np.empty(
                    (len(idxs), *res[1].shape[1:]), res[1].dtype
                )
                valid = np.empty(len(idxs), bool)
            imgs[sel], labels[sel], valid[sel] = res
        return imgs, labels, valid


class Subset:
    """Index-selected view of a dataset (like torch's Subset)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices, np.int64)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[int(self.indices[idx])]

    def get_batch(self, indices):
        """Vectorized batch read through the index view (see
        PackedDataset.get_batch); None when the wrapped dataset has no
        fast path."""
        if not hasattr(self.dataset, "get_batch"):
            return None
        return self.dataset.get_batch(
            self.indices[np.asarray(indices, np.int64)]
        )
