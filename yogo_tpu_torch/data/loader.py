"""Dataset splitting + host-side batch loading.

Port of yogo_tpu/data/loader.py, which replaces the reference's torch
DataLoader machinery (reference: yogo/data/yogo_dataloader.py:28-324):

  - deterministic split with seed 7271978: the permutation is
    bit-identical to the reference's
    random_split(generator.manual_seed(7271978)), drawn from a CPU
    generator whatever device trains,
  - a threaded map-style loader producing fixed-shape numpy batches: the
    final ragged batch is padded and accompanied by a per-image validity
    mask so every step sees one batch shape (the reference's
    DistributedSampler similarly pads to equalize ranks),
  - sharding by shard=(rank, world) instead of DistributedSampler (kept
    as a parameter; the port's Trainer runs one process on one device).

Augmentation (random flips) happens on device inside the train step
(yogo_tpu_torch.data.transforms), not here.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from yogo_tpu_torch.data.blobgen import BlobDataset
from yogo_tpu_torch.data.dataset import ConcatDataset, ObjectDetectionDataset, Subset
from yogo_tpu_torch.data.definition import DatasetDefinition
from yogo_tpu_torch.data.split_fractions import SplitFractions

SPLIT_SEED = 7271978  # reference: yogo/data/yogo_dataloader.py:176


def split_permutation(n: int, seed: int = SPLIT_SEED) -> np.ndarray:
    """Permutation used for splitting: torch's
    randperm(generator.manual_seed(seed)) on a CPU generator."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randperm(n, generator=g, device="cpu").numpy()


def split_dataset(dataset, split_fractions: SplitFractions) -> Dict[str, Subset]:
    """Split a dataset into designation -> Subset with the reference's
    deterministic permutation and partition sizing."""
    sizes = split_fractions.partition_sizes(len(dataset))
    perm = split_permutation(len(dataset))
    out: Dict[str, Subset] = {}
    offset = 0
    for key in split_fractions.keys():
        out[key] = Subset(dataset, perm[offset : offset + sizes[key]])
        offset += sizes[key]
    return out


def choose_dataloader_num_workers(
    dataset_size: int, requested_num_workers: Optional[int] = None
) -> int:
    """Reference worker-count heuristic (reference:
    yogo/data/yogo_dataloader.py:61-69): 0 for small datasets, else the
    requested count or the CPU count (capped at 64)."""
    if dataset_size < 1000:
        return 0
    if requested_num_workers is not None:
        return requested_num_workers
    try:
        cpus = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover
        cpus = os.cpu_count() or 32
    return min(cpus, 64)


class DataLoader:
    """Threaded map-style batch loader yielding (images, labels, image_mask).

    Fixed output shapes: the last ragged batch is padded by wrapping around
    the epoch's index order, with image_mask marking real samples. Failed
    reads (dataset returns None) are also padded out via the mask.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = SPLIT_SEED,
        num_workers: int = 0,
        shard: Optional[Tuple[int, int]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.epoch = 0
        self.rank, self.world_size = shard or (0, 1)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)  # BlobDataset resamples per epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, self.epoch)
            ).permutation(n)
        else:
            order = np.arange(n)
        if self.world_size > 1:
            # pad so every shard sees the same count (DistributedSampler-like,
            # which also repeats indices). np.resize repeats `order`
            # cyclically: a single `order[: total - n]` slice under-fills
            # when the pad exceeds the dataset size (3 samples over 8
            # processes), leaving ranks with UNEQUAL step counts - a
            # cross-host collective deadlock
            total = -(-n // self.world_size) * self.world_size
            order = np.resize(order, total)
            order = order[self.rank :: self.world_size]
        return order

    def __len__(self) -> int:
        # batches are ALWAYS padded to the fixed batch shape (masks mark
        # real rows); a drop-last mode never existed in working form and no
        # caller asked for one. Pure arithmetic - generating an epoch
        # permutation just to count it would be O(n) RNG work per call
        n = len(self.dataset)
        if self.world_size > 1:
            n = -(-n // self.world_size)
        return -(-n // self.batch_size)

    def __iter__(
        self,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = self._epoch_indices()
        n = len(order)
        if n == 0:
            return

        num_batches = len(self)
        # np.resize repeats `order` as many times as needed: a single slice
        # under-fills when the pad exceeds the dataset size (e.g. 10 images
        # at batch_size 64), breaking the fixed-batch-shape contract
        padded = np.resize(order, num_batches * self.batch_size)
        real = np.zeros(len(padded), bool)
        real[:n] = True

        def fetch(i: int):
            return self.dataset[int(i)]

        # vectorized fast path (packed caches): one gather per batch
        # instead of per-item python reads; batches are bit-identical to
        # the per-item path (tests/test_packed_cache.py)
        use_get_batch = hasattr(self.dataset, "get_batch")

        pool = (
            ThreadPoolExecutor(max_workers=self.num_workers)
            if self.num_workers > 0
            else None
        )
        try:
            for b in range(num_batches):
                idxs = padded[b * self.batch_size : (b + 1) * self.batch_size]
                mask = real[b * self.batch_size : (b + 1) * self.batch_size].copy()
                if use_get_batch:
                    res = self.dataset.get_batch(idxs)
                    if res is None:
                        use_get_batch = False  # no fast path; stop probing
                    else:
                        imgs, labels, valid = res
                        if not valid.any():
                            warnings.warn(
                                "entire batch failed to load; skipping"
                            )
                            continue
                        yield imgs, labels, (mask & valid).astype(np.float32)
                        continue
                if pool is not None:
                    samples = list(pool.map(fetch, idxs))
                else:
                    samples = [fetch(i) for i in idxs]

                # robust collate: failed reads stay in the batch but masked out
                # (reference drops them: yogo/data/utils.py:49-63)
                template = next((s for s in samples if s is not None), None)
                if template is None:
                    warnings.warn("entire batch failed to load; skipping")
                    continue
                imgs = np.empty(
                    (len(samples), *template[0].shape), template[0].dtype
                )
                labels = np.empty(
                    (len(samples), *template[1].shape), template[1].dtype
                )
                for i, s in enumerate(samples):
                    if s is None:
                        mask[i] = False
                        imgs[i] = 0
                        labels[i] = 0
                    else:
                        imgs[i], labels[i] = s
                yield imgs, labels, mask.astype(np.float32)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


def get_datasets(
    dataset_definition: DatasetDefinition,
    Sx: int,
    Sy: int,
    rgb: bool = False,
    image_hw: Tuple[int, int] = (772, 1032),
    normalize_images: bool = False,
    split_fraction_override: Optional[SplitFractions] = None,
    packed_cache: Union[bool, str, os.PathLike, None] = None,
) -> Dict[str, object]:
    """Dataset definition -> designation -> dataset, reproducing the
    reference's split topology (reference: yogo/data/yogo_dataloader.py:72-154):
    explicit test_paths stay a dedicated test set unless overridden; the
    thumbnail-augmentation BlobDataset is appended to train with
    length = len(train) // 2.

    packed_cache (extension): truthy enables the decode-once packed image
    cache (data/packed_cache.py) - first epoch decodes to uint8 memmap
    shards, later reads are page-cache memcpys at device rate. True uses
    the default cache root (YOGO_CACHE_DIR or ~/.cache/yogo_tpu_torch/packed);
    a path uses that root."""

    def maybe_pack(ds: ObjectDetectionDataset):
        if not packed_cache:
            return ds
        from yogo_tpu_torch.data.packed_cache import PackedDataset

        root = None if packed_cache is True else packed_cache
        return PackedDataset(ds, Sx=Sx, Sy=Sy, cache_root=root)

    def build(specs):
        return ConcatDataset(
            maybe_pack(
                ObjectDetectionDataset(
                    s.image_path,
                    s.label_path,
                    Sx,
                    Sy,
                    image_hw=image_hw,
                    rgb=rgb,
                    classes=dataset_definition.classes,
                    normalize_images=normalize_images,
                )
            )
            for s in specs
        )

    full = build(dataset_definition.dataset_paths)

    if dataset_definition.test_dataset_paths:
        test = build(dataset_definition.test_dataset_paths)
        if split_fraction_override is not None:
            split = split_dataset(
                ConcatDataset([full, test]), split_fraction_override
            )
        else:
            assert "test" not in dataset_definition.split_fractions
            split = {
                **split_dataset(full, dataset_definition.split_fractions),
                "test": test,
            }
    else:
        split = split_dataset(
            full, split_fraction_override or dataset_definition.split_fractions
        )

    if dataset_definition.thumbnail_augmentation is not None:
        if rgb:
            # BlobDataset emits (1, H, W) images (as does the reference's,
            # reference: yogo/data/blobgen.py:263); mixing them into an RGB
            # train split would only surface as a shape mismatch deep in
            # batch collation mid-epoch - fail fast instead.
            raise ValueError(
                "thumbnail_augmentation produces single-channel images and "
                "cannot be combined with an RGB model"
            )
        bd = BlobDataset(
            dataset_definition.thumbnail_augmentation,
            Sx=Sx,
            Sy=Sy,
            classes=dataset_definition.classes,
            n=100,
            length=len(split["train"]) // 2,
            background_img_shape=image_hw,
            normalize_images=normalize_images,
        )
        split["train"] = ConcatDataset([split["train"], bd])

    return split


def get_dataloader(
    dataset_definition: DatasetDefinition,
    batch_size: int,
    Sx: int,
    Sy: int,
    image_hw: Tuple[int, int] = (772, 1032),
    rgb: bool = False,
    normalize_images: bool = False,
    split_fraction_override: Optional[SplitFractions] = None,
    requested_num_workers: Optional[int] = None,
    shard: Optional[Tuple[int, int]] = None,
    packed_cache: Union[bool, str, os.PathLike, None] = None,
) -> Dict[str, DataLoader]:
    """Per-split loaders (reference: yogo/data/yogo_dataloader.py:182-241).

    The reference's `training: bool` parameter - which gates whether the
    loader attaches flip augmentations - has no analogue here: paired
    flips run jitted INSIDE the train step (data/transforms.py), so the
    loader only ever yields raw batches and a dead parameter would
    mislead."""
    split = get_datasets(
        dataset_definition,
        Sx,
        Sy,
        rgb=rgb,
        image_hw=image_hw,
        normalize_images=normalize_images,
        split_fraction_override=split_fraction_override,
        packed_cache=packed_cache,
    )
    out: Dict[str, DataLoader] = {}
    for designation, ds in split.items():
        if len(ds) == 0:
            continue
        nw = choose_dataloader_num_workers(len(ds), requested_num_workers)
        out[designation] = DataLoader(
            ds,
            batch_size=batch_size,
            shuffle=(designation == "train"),
            num_workers=nw,
            shard=shard,
        )
    return out


def get_image_count(loader: DataLoader) -> int:
    """Number of images behind a loader
    (reference: yogo/data/yogo_dataloader.py:316-324)."""
    return len(loader.dataset)


def get_class_counts(loader: DataLoader, num_classes: int) -> np.ndarray:
    """Per-class object counts over a loader's label grids
    (reference: yogo/data/yogo_dataloader.py:287-313)."""
    counts = np.zeros(num_classes, np.int64)
    for _, labels, mask in loader:
        sel = labels[mask.astype(bool)]
        flat_mask = sel[:, 0].reshape(-1) == 1
        cls = sel[:, 5].reshape(-1)[flat_mask].astype(np.int64)
        counts += np.bincount(cls, minlength=num_classes)
    return counts
