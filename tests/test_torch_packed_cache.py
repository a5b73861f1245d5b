"""The port's packed dataset cache against the JAX package's: equal
signatures, bit-equal items and batches, and a cache built by either
package read by the other without a rebuild. All comparisons are exact."""

import json
import time

import numpy as np
import pytest

from tests.data_fixtures import CLASSES, make_label_file, make_pair_dirs, write_defn
from yogo_tpu.data import packed_cache as jpacked
from yogo_tpu.data.dataset import ObjectDetectionDataset as JDataset
from yogo_tpu.data.definition import DatasetDefinition as JDefinition
from yogo_tpu.data.loader import get_dataloader as jget_dataloader
from yogo_tpu_torch.data import packed_cache as packed
from yogo_tpu_torch.data.dataset import ObjectDetectionDataset
from yogo_tpu_torch.data.definition import DatasetDefinition
from yogo_tpu_torch.data.loader import get_dataloader
from yogo_tpu_torch.data.prefetch import prefetch_to_device

SX, SY = 7, 5
HW = (40, 56)


def sources(tmp_path, name="pk", normalize=False, **kw):
    img_dir, lbl_dir = make_pair_dirs(tmp_path, name, **kw)
    args = (img_dir, lbl_dir, SX, SY)
    kwargs = dict(classes=CLASSES, image_hw=HW, normalize_images=normalize)
    return ObjectDetectionDataset(*args, **kwargs), JDataset(*args, **kwargs)


def boom(*a, **k):  # pragma: no cover - failure path
    raise AssertionError("the cache should not be rebuilt")


def test_signature_format_version_and_default_root(tmp_path, monkeypatch):
    src, jsrc = sources(tmp_path, n_images=3)
    assert packed.dataset_signature(src) == jpacked.dataset_signature(jsrc)
    assert packed.CACHE_FORMAT_VERSION == jpacked.CACHE_FORMAT_VERSION
    assert packed.MAX_BOXES_CAP == jpacked.MAX_BOXES_CAP
    # each package has a root of its own, and YOGO_CACHE_DIR overrides both
    monkeypatch.delenv("YOGO_CACHE_DIR", raising=False)
    assert packed.default_cache_root().parts[-2:] == ("yogo_tpu_torch", "packed")
    assert packed.default_cache_root() != jpacked.default_cache_root()
    monkeypatch.setenv("YOGO_CACHE_DIR", str(tmp_path / "env"))
    assert packed.default_cache_root() == jpacked.default_cache_root() == tmp_path / "env"


@pytest.mark.parametrize("normalize", [False, True])
def test_items_and_batches_bit_equal_the_jax_cache_and_the_live_dataset(tmp_path, normalize):
    src, jsrc = sources(tmp_path, normalize=normalize, n_images=5, boxes_per_image=3)
    got = packed.PackedDataset(src, Sx=SX, Sy=SY, cache_root=tmp_path / "a")
    want = jpacked.PackedDataset(jsrc, Sx=SX, Sy=SY, cache_root=tmp_path / "b")
    assert len(got) == len(want) == 5
    for i in range(5):
        for g, w, live in zip(got[i], want[i], src[i]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, live)
    idx = np.array([4, 0, 0, 2])
    for g, w in zip(got.get_batch(idx), want.get_batch(idx)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    imgs, grids, valid = got.get_batch(idx)
    for row, i in enumerate(idx):
        np.testing.assert_array_equal(imgs[row], got[i][0])
        np.testing.assert_array_equal(grids[row], got[i][1])
    assert valid.all()
    np.testing.assert_array_equal(got.calc_class_counts(), want.calc_class_counts())
    # the files on disk are the same bytes, the meta the same record
    for name in ("images.npy", "label_rows.npy", "counts.npy", "valid.npy"):
        assert (got.cache_dir / name).read_bytes() == (want.cache_dir / name).read_bytes(), name
    assert json.loads((got.cache_dir / "meta.json").read_text()) == \
        json.loads((want.cache_dir / "meta.json").read_text())
    assert got.cache_dir.name == want.cache_dir.name


@pytest.mark.parametrize("built_by", ["jax", "port"])
def test_a_cache_built_by_one_package_is_read_by_the_other(tmp_path, monkeypatch, built_by):
    src, jsrc = sources(tmp_path, n_images=4)
    root = tmp_path / "shared"
    if built_by == "jax":
        built = jpacked.PackedDataset(jsrc, Sx=SX, Sy=SY, cache_root=root)
        monkeypatch.setattr(packed, "_build", boom)
        reader = packed.PackedDataset(src, Sx=SX, Sy=SY, cache_root=root)
    else:
        built = packed.PackedDataset(src, Sx=SX, Sy=SY, cache_root=root)
        monkeypatch.setattr(jpacked, "_build", boom)
        reader = jpacked.PackedDataset(jsrc, Sx=SX, Sy=SY, cache_root=root)
    assert reader.cache_dir == built.cache_dir and len(list(root.iterdir())) == 1
    for i in range(4):
        np.testing.assert_array_equal(reader[i][0], built[i][0])
        np.testing.assert_array_equal(reader[i][1], built[i][1])
    # another grid reads the same cache: rows are stored, not grids
    other = packed.PackedDataset(src, Sx=3, Sy=2, cache_root=root) if built_by == "jax" else \
        jpacked.PackedDataset(jsrc, Sx=3, Sy=2, cache_root=root)
    assert other.cache_dir == built.cache_dir and other[0][1].shape == (6, 2, 3)


def test_source_change_invalidates_and_incomplete_dir_is_rebuilt(tmp_path):
    src, _ = sources(tmp_path, n_images=3)
    root = tmp_path / "cache"
    first = packed.PackedDataset(src, Sx=SX, Sy=SY, cache_root=root)
    (first.cache_dir / "meta.json").unlink()  # what a crashed build leaves behind
    again = packed.PackedDataset(src, Sx=SX, Sy=SY, cache_root=root)
    assert again.cache_dir == first.cache_dir and (again.cache_dir / "meta.json").exists()
    time.sleep(0.01)
    make_label_file(src._label_paths[0], [[1, 0.5, 0.5, 0.2, 0.2]])
    src2, _ = sources(tmp_path, n_images=3)
    make_label_file(src2._label_paths[0], [[1, 0.5, 0.5, 0.2, 0.2]])
    changed = packed.PackedDataset(src2, Sx=SX, Sy=SY, cache_root=root)
    assert changed.cache_dir != first.cache_dir
    assert not list(root.glob(".build-*"))  # no build directory left behind


def test_failed_decode_is_masked_like_jax(tmp_path):
    src, jsrc = sources(tmp_path, n_images=3)
    open(str(src._image_paths[1]), "wb").write(b"not a png")
    got = packed.PackedDataset(src, Sx=SX, Sy=SY, cache_root=tmp_path / "a")
    want = jpacked.PackedDataset(jsrc, Sx=SX, Sy=SY, cache_root=tmp_path / "b")
    assert got[1] is None and want[1] is None and got[0] is not None
    for g, w in zip(got.get_batch([0, 1, 2]), want.get_batch([0, 1, 2])):
        np.testing.assert_array_equal(g, w)
    assert got.get_batch([0, 1, 2])[2].tolist() == [True, False, True]


@pytest.mark.parametrize("cache_side", ["both", "port_only"])
def test_loader_batches_with_the_cache_equal_jax_and_the_live_loader(tmp_path, cache_side):
    pairs = [make_pair_dirs(tmp_path, str(i), n_images=5, seed=i) for i in range(2)]
    defn = write_defn(tmp_path / "d.yml", dataset_pairs=pairs,
                      split={"train": 0.6, "val": 0.2, "test": 0.2})
    kw = dict(Sx=SX, Sy=SY, image_hw=HW)
    got = get_dataloader(DatasetDefinition.from_yaml(defn), 4, packed_cache=tmp_path / "c", **kw)
    want = jget_dataloader(JDefinition.from_yaml(defn), 4,
                           packed_cache=tmp_path / "c" if cache_side == "both" else None, **kw)
    for key in ("train", "val", "test"):
        got[key].set_epoch(1)
        want[key].set_epoch(1)
        g_batches, w_batches = list(got[key]), list(want[key])
        assert len(g_batches) == len(w_batches) == len(got[key])
        for g, w in zip(g_batches, w_batches):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_cached_batches_reach_the_device_hand_off_without_a_read_only_warning(tmp_path):
    import warnings

    pairs = [make_pair_dirs(tmp_path, "a", n_images=6, seed=0)]
    defn = write_defn(tmp_path / "d.yml", dataset_pairs=pairs, split={"train": 1.0, "val": 0.0})
    dl = get_dataloader(DatasetDefinition.from_yaml(defn), 4, Sx=SX, Sy=SY, image_hw=HW,
                        packed_cache=tmp_path / "c")["train"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        batches = list(prefetch_to_device(dl, "cpu"))
    assert [tuple(b[0].shape) for b in batches] == [(4, 1, *HW)] * 2
    assert batches[1][2].tolist() == [1.0, 1.0, 0.0, 0.0]
    batches[0][0].add_(1)  # the tensors own their memory
