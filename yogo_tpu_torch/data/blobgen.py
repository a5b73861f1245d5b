"""Synthetic training data: paste object thumbnails onto plain backgrounds.

Re-implementation of the reference BlobDataset (reference:
yogo/data/blobgen.py:23-263): per sample, pick n random pre-loaded
thumbnails, random h/v flips, rejection-sample non-overlapping placements
(zero pairwise IoU, 100 tries), paste onto a background filled with the
thumbnails' mean bright shade, and emit the standard (6, Sy, Sx) label grid.
Pure numpy on the host - this feeds the same device pipeline as real data.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from yogo_tpu_torch.data.utils import read_image_robust
from yogo_tpu_torch.ops.grid import encode_label_grid_np

PathLike = Union[str, Path]


class BlobDataset:
    def __init__(
        self,
        thumbnail_dir_paths: Mapping[Union[str, int], List[PathLike]],
        Sx: int,
        Sy: int,
        classes: List[str],
        n: int = 50,
        length: int = 1000,
        background_img_shape: Tuple[int, int] = (772, 1032),
        normalize_images: bool = False,
        seed: Optional[int] = None,
    ):
        self.Sx = Sx
        self.Sy = Sy
        self.n = n
        self.length = length
        self.background_img_shape = tuple(background_img_shape)
        self.normalize_images = normalize_images
        self.area_threshold = 500
        # np.random.Generator is NOT thread-safe and the loader calls
        # __getitem__ from worker threads: hand each item its own child
        # generator derived deterministically from (entropy, epoch, idx).
        # Lock-free AND reproducible - dataset[i] is identical on every
        # access within an epoch and across runs for a fixed seed,
        # regardless of call/thread order - while set_epoch (called by the
        # DataLoader each epoch) keeps the reference's fresh-synthetic-
        # sample-per-epoch augmentation diversity (the reference draws from
        # one np.random per access in DataLoader worker *processes*)
        self._entropy = np.random.SeedSequence(seed).entropy
        self._epoch = 0

        dir_paths: Dict[int, List[Path]] = {
            self._convert_label(k, classes): [Path(p) for p in v]
            for k, v in thumbnail_dir_paths.items()
        }
        for dirs in dir_paths.values():
            for d in dirs:
                if not d.exists():
                    raise FileNotFoundError(f"{d} does not exist")
        if not dir_paths:
            raise FileNotFoundError("no thumbnail directories provided")

        self.thumb_classes, thumb_paths = self._collect_paths(dir_paths)
        self.thumbnails = self._load_thumbnails(thumb_paths)
        if not self.thumbnails:
            raise FileNotFoundError("no readable thumbnails found")

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    @staticmethod
    def _convert_label(label: Union[str, int], classes: List[str]) -> int:
        if isinstance(label, int):
            if not 0 <= label < len(classes):
                raise ValueError(
                    f"label {label} is out of range [0, {len(classes)})"
                )
            return label
        try:
            return classes.index(label)
        except ValueError as e:
            raise ValueError(f"label {label} is not a valid YOGO class") from e

    @staticmethod
    def _collect_paths(
        dir_paths: Dict[int, List[Path]]
    ) -> Tuple[np.ndarray, List[Path]]:
        pairs: List[Tuple[int, Path]] = []
        for cls, dirs in dir_paths.items():
            for d in dirs:
                pairs.extend(
                    (cls, p)
                    for p in sorted(d.glob("*.png"))
                    if not p.name.startswith(".")
                )
        if not pairs:
            raise FileNotFoundError(
                f"no thumbnails found in any of {list(dir_paths.values())}"
            )
        classes, paths = zip(*pairs)
        return np.array(classes), list(paths)

    def _load_thumbnails(self, paths: List[Path]) -> List[np.ndarray]:
        """Threaded decode; drops unreadable or sub-threshold-area thumbnails
        (reference: yogo/data/blobgen.py:82-112). Kept as a ragged list of
        (h, w) uint8 arrays - simpler than the reference's padded tensor and
        host-side anyway."""
        with ThreadPoolExecutor() as ex:
            loaded = list(ex.map(read_image_robust, paths))
        bg_h, bg_w = self.background_img_shape
        thumbs, classes = [], []
        n_oversized = 0
        for img, cls in zip(loaded, self.thumb_classes):
            if img is None:
                continue
            img2d = img[0]
            if img2d.shape[0] > bg_h or img2d.shape[1] > bg_w:
                n_oversized += 1  # cannot be placed on the background at all
                continue
            if img2d.shape[0] * img2d.shape[1] > self.area_threshold:
                thumbs.append(img2d)
                classes.append(cls)
        if n_oversized:
            warnings.warn(
                f"dropped {n_oversized} thumbnails larger than the "
                f"{bg_h}x{bg_w} background"
            )
        self.thumb_classes = np.array(classes)
        return thumbs

    def __len__(self) -> int:
        return self.length

    def _background_shade(
        self, thumbs: List[np.ndarray], brightness_threshold: int = 210
    ) -> int:
        vals = []
        for t in thumbs:
            bright = t[t > brightness_threshold]
            vals.append(
                float(bright.mean()) if bright.size else float(brightness_threshold)
            )
        return int(np.mean(vals)) if vals else brightness_threshold

    def _propose_coords(
        self,
        rng: np.random.Generator,
        h: int,
        w: int,
        previous: List[np.ndarray],
        num_tries: int = 100,
    ) -> Optional[Tuple[int, int, np.ndarray]]:
        bg_h, bg_w = self.background_img_shape
        # `previous` is invariant across the rejection loop: concatenate
        # once, not once per try (dense scenes run n x num_tries tries on
        # the host data hot path)
        prev = np.concatenate(previous) if previous else None
        for _ in range(num_tries):
            # inclusive upper placement: a h-tall thumbnail fits at any
            # y in [0, bg_h - h] (also keeps h == bg_h from crashing)
            y = int(rng.integers(0, bg_h - h + 1))
            x = int(rng.integers(0, bg_w - w + 1))
            box = np.array(
                [[x / bg_w, y / bg_h, (x + w) / bg_w, (y + h) / bg_h]],
                np.float32,
            )
            if prev is None:
                return x, y, box
            ix1 = np.maximum(box[0, 0], prev[:, 0])
            iy1 = np.maximum(box[0, 1], prev[:, 1])
            ix2 = np.minimum(box[0, 2], prev[:, 2])
            iy2 = np.minimum(box[0, 3], prev[:, 3])
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            if (inter == 0).all():
                return x, y, box
        return None

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if idx < 0:  # python sequence semantics; also keeps the negative
            idx += self.length  # value out of SeedSequence.spawn_key below
        if not 0 <= idx < self.length:
            raise IndexError(f"index {idx} is out of bounds for length {self.length}")

        rng = np.random.default_rng(
            np.random.SeedSequence(
                entropy=self._entropy, spawn_key=(self._epoch, idx)
            )
        )
        choice = rng.integers(0, len(self.thumbnails), size=self.n)
        picked = [
            (int(self.thumb_classes[i]), self.thumbnails[i]) for i in choice
        ]

        shade = self._background_shade([t for _, t in picked])
        img = np.full(self.background_img_shape, shade, np.uint8)

        coords: List[np.ndarray] = []
        classes: List[int] = []
        for cls, thumb in picked:
            if rng.random() < 0.5:
                thumb = thumb[:, ::-1]
            if rng.random() < 0.5:
                thumb = thumb[::-1, :]
            h, w = thumb.shape
            proposal = self._propose_coords(rng, h, w, coords)
            if proposal is None:
                continue
            x, y, box = proposal
            img[y : y + h, x : x + w] = thumb
            coords.append(box)
            classes.append(cls)

        if coords:
            rows = np.concatenate(
                [np.asarray(classes, np.float32)[:, None], np.concatenate(coords)],
                axis=1,
            )
        else:  # every placement was rejected: a valid empty-label image
            rows = np.zeros((0, 5), np.float32)
        label_grid = encode_label_grid_np(rows, self.Sx, self.Sy)

        out_img: np.ndarray = img[None]  # (1, H, W)
        if self.normalize_images:
            out_img = out_img.astype(np.float32) / 255.0
        return out_img, label_grid
