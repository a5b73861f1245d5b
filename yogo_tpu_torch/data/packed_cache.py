"""Decode-once packed dataset cache: disk-backed training without the
per-epoch decode (port of yogo_tpu/data/packed_cache.py; the on-disk format
is the same, so a cache either package built is read by the other when
pointed at it).

The reference feeds its trainer by re-decoding PNGs every epoch, scaled
across N DataLoader worker processes (reference:
yogo/data/yogo_dataloader.py:258-272, worker heuristic :61-69). On a host
with few cores the 772x1032 decode cannot keep up with the training step
(PERF.md has the loader rates measured beside the step rate). The answer
is to pay the decode cost ONCE:

  - first construction decodes + antialias-resizes every image to uint8
    (C, H, W) and parses every label file to [cls, xc, yc, w, h] rows,
    writing both into standard .npy files under a content-addressed cache
    directory;
  - afterwards the images are a memory-mapped array: a __getitem__ is a
    page-cache memcpy plus a cheap grid encode, and the OS shares the
    pages across processes.

Label rows are stored instead of encoded grids, so the cache is
INDEPENDENT of the model's grid (Sx, Sy): one cache per
(files, image_hw, rgb, classes, notes.json) serves every architecture;
grids are encoded at read time.

The cache key is a content signature over every (path, size, mtime_ns)
pair plus the decode parameters - touching any source file invalidates
the cache. Builds are atomic (tmp dir + rename), so concurrent
processes (multi-host training on a shared FS) race benignly: the loser
discards its build and maps the winner's.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from yogo_tpu_torch.data.labels import labels_to_grid, load_labels

CACHE_FORMAT_VERSION = 1

# hard cap on stored boxes per image; beyond this a label file is almost
# certainly malformed (the densest reference datasets run ~100s of cells)
MAX_BOXES_CAP = 4096


def default_cache_root() -> Path:
    """YOGO_CACHE_DIR env override, else ~/.cache/yogo_tpu_torch/packed."""
    env = os.environ.get("YOGO_CACHE_DIR")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "yogo_tpu_torch" / "packed"


def dataset_signature(dataset) -> str:
    """Content signature of an ObjectDetectionDataset's sources + decode
    parameters. Any change to a source file's path/size/mtime, the target
    resolution, channel count, class list, or notes.json yields a new
    signature (and so a fresh cache directory)."""
    h = hashlib.sha256()
    h.update(f"v{CACHE_FORMAT_VERSION}".encode())
    h.update(repr(tuple(dataset.image_hw)).encode())
    h.update(b"rgb" if dataset.rgb else b"gray")
    h.update(repr(list(dataset.classes)).encode())
    h.update(json.dumps(dataset.notes_data, sort_keys=True).encode())
    for ip, lp in zip(dataset._image_paths, dataset._label_paths):
        for p in (str(ip), str(lp)):
            st = os.stat(p)
            h.update(p.encode())
            h.update(str(st.st_size).encode())
            h.update(str(st.st_mtime_ns).encode())
    return h.hexdigest()


def _build(dataset, out_dir: Path, signature: str) -> None:
    """Decode every image + parse every label file into .npy files inside
    out_dir (which must not yet exist; caller renames atomically)."""
    n = len(dataset)
    c = 3 if dataset.rgb else 1
    hh, ww = dataset.image_hw

    # pass 1: labels (cheap) - also determines the row capacity
    all_rows: List[np.ndarray] = []
    for i in range(n):
        rows = load_labels(
            dataset._label_paths[i],
            classes=dataset.classes,
            notes_data=dataset.notes_data,
        )
        all_rows.append(np.asarray(rows, np.float32).reshape(-1, 5))
    m = max(1, min(MAX_BOXES_CAP, max((len(r) for r in all_rows), default=1)))

    out_dir.mkdir(parents=True)
    imgs = np.lib.format.open_memmap(
        out_dir / "images.npy", mode="w+", dtype=np.uint8, shape=(n, c, hh, ww)
    )
    rows_arr = np.lib.format.open_memmap(
        out_dir / "label_rows.npy", mode="w+", dtype=np.float32, shape=(n, m, 5)
    )
    counts = np.zeros(n, np.int32)
    valid = np.zeros(n, bool)

    for i in range(n):
        r = all_rows[i][:m]
        rows_arr[i, : len(r)] = r
        counts[i] = len(r)

    # decode with a thread pool: the native decoder releases the GIL, so
    # the one-time build scales with host cores (the same reason the
    # reference sizes its DataLoader worker pool)
    try:
        workers = max(1, min(len(os.sched_getaffinity(0)), 32))
    except (AttributeError, OSError):  # pragma: no cover
        workers = max(1, min(os.cpu_count() or 1, 32))

    def decode(i: int) -> bool:
        img = dataset.load_image(i)
        if img is None:
            # failed decode: row stays zero, masked out at read time (the
            # live dataset's robust-read path has the same semantics)
            return False
        imgs[i] = img
        return True

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for i, ok in enumerate(pool.map(decode, range(n))):
            valid[i] = ok
            if (i + 1) % 500 == 0 or i + 1 == n:
                print(
                    f"packed-cache: decoded {i + 1}/{n} images",
                    file=sys.stderr,
                )

    np.save(out_dir / "counts.npy", counts)
    np.save(out_dir / "valid.npy", valid)
    imgs.flush()
    rows_arr.flush()
    # meta written LAST: its presence marks a complete build
    (out_dir / "meta.json").write_text(
        json.dumps(
            {
                "signature": signature,
                "n": n,
                "channels": c,
                "image_hw": [hh, ww],
                "max_boxes": m,
                "format_version": CACHE_FORMAT_VERSION,
            }
        )
    )


def _is_complete(cache_dir: Path, signature: str) -> bool:
    meta = cache_dir / "meta.json"
    if not meta.exists():
        return False
    try:
        return json.loads(meta.read_text())["signature"] == signature
    except (json.JSONDecodeError, KeyError):
        return False


class PackedDataset:
    """Drop-in replacement for an ObjectDetectionDataset backed by the
    packed cache: same length, order, and __getitem__ contract
    ((uint8-or-f32 CHW image, (6, Sy, Sx) grid) or None), so Subset /
    ConcatDataset / DataLoader compose unchanged."""

    def __init__(
        self,
        source,
        Sx: int,
        Sy: int,
        cache_root: Optional[Union[str, Path]] = None,
    ):
        self.Sx = Sx
        self.Sy = Sy
        self.normalize_images = source.normalize_images
        self.classes = source.classes

        root = Path(cache_root) if cache_root is not None else default_cache_root()
        sig = dataset_signature(source)
        cache_dir = root / sig[:24]

        if not _is_complete(cache_dir, sig):
            root.mkdir(parents=True, exist_ok=True)
            # a crashed build can leave a meta-less cache_dir behind
            # (builds are tmp+rename, so only a crash mid-rename or an
            # interrupted legacy layout gets here); clear it or every
            # future construction would fail the rename forever
            if cache_dir.exists():
                shutil.rmtree(cache_dir, ignore_errors=True)
            tmp = Path(
                tempfile.mkdtemp(prefix=f".build-{sig[:8]}-", dir=root)
            )
            build_dir = tmp / "pack"
            try:
                _build(source, build_dir, sig)
                try:
                    build_dir.rename(cache_dir)
                except OSError:
                    # a concurrent build won the race; use its complete
                    # cache and drop ours
                    if not _is_complete(cache_dir, sig):
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)

        self.cache_dir = cache_dir
        self._imgs = np.load(cache_dir / "images.npy", mmap_mode="r")
        self._rows = np.load(cache_dir / "label_rows.npy", mmap_mode="r")
        self._counts = np.load(cache_dir / "counts.npy")
        self._valid = np.load(cache_dir / "valid.npy")

    def __len__(self) -> int:
        return len(self._imgs)

    def __getitem__(
        self, index: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if not self._valid[index]:
            return None
        image: np.ndarray = np.asarray(self._imgs[index])
        if self.normalize_images:
            image = image.astype(np.float32) / 255.0
        k = int(self._counts[index])
        rows = np.asarray(self._rows[index, :k])
        grid = labels_to_grid(rows, self.Sx, self.Sy)
        return image, grid

    def get_batch(
        self, indices
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized batch read: one fancy-index gather for the images and
        one batched scatter for the label grids (last-write-wins in
        (image, row) order - the same order as the per-image encoder, so
        results are bit-identical to [self[i] for i in indices]).

        Returns (images (B, C, H, W), grids (B, 6, Sy, Sx), valid (B,));
        invalid rows (failed decodes) are zero with valid=False, matching
        the DataLoader's robust-collate semantics."""
        idxs = np.asarray(indices, np.int64)
        b = len(idxs)
        images: np.ndarray = self._imgs[idxs]
        if self.normalize_images:
            images = images.astype(np.float32) / 255.0
        valid = self._valid[idxs].copy()
        counts = self._counts[idxs]
        grids = np.zeros((b, 6, self.Sy, self.Sx), np.float32)

        rows = np.asarray(self._rows[idxs])  # (B, M, 5) [cls, xc, yc, w, h]
        live = np.arange(rows.shape[1])[None, :] < counts[:, None]  # (B, M)
        if live.any():
            bidx = np.broadcast_to(np.arange(b)[:, None], live.shape)[live]
            r = rows[live]  # (K, 5), (image, row) order preserved
            x1 = r[:, 1] - r[:, 3] / 2
            y1 = r[:, 2] - r[:, 4] / 2
            x2 = r[:, 1] + r[:, 3] / 2
            y2 = r[:, 2] + r[:, 4] / 2
            # identical index arithmetic to ops/grid.encode_label_grid_np
            ii = ((x1 + x2) * self.Sx // 2).astype(np.int64)
            jj = ((y1 + y2) * self.Sy // 2).astype(np.int64)
            ok = (
                (r[:, 0] >= 0)
                & (ii >= 0) & (ii < self.Sx)
                & (jj >= 0) & (jj < self.Sy)
            )
            bo, io, jo = bidx[ok], ii[ok], jj[ok]
            grids[bo, 0, jo, io] = 1.0
            grids[bo, 1, jo, io] = x1[ok]
            grids[bo, 2, jo, io] = y1[ok]
            grids[bo, 3, jo, io] = x2[ok]
            grids[bo, 4, jo, io] = y2[ok]
            grids[bo, 5, jo, io] = r[ok, 0]
        return images, grids, valid

    def calc_class_counts(self) -> np.ndarray:
        """(num_classes,) occurrence counts - from the packed rows, no
        label-file re-parse (mirrors ObjectDetectionDataset)."""
        counts = np.zeros(len(self.classes), np.int64)
        for i in range(len(self)):
            k = int(self._counts[i])
            if k:
                cls = self._rows[i, :k, 0].astype(np.int64)
                counts += np.bincount(cls, minlength=len(self.classes))
        return counts
