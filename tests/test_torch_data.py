"""The port's data pipeline against the JAX package's on the same fixture
trees: dataset definitions, label parsing, datasets, the split, the loader
and the hand-off to the device. Everything here is numpy on both sides, so
every comparison is exact (bit-equal arrays, equal lists) unless a test
says otherwise."""

import json
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from tests.data_fixtures import CLASSES, make_image, make_pair_dirs, write_defn
from yogo_tpu.data import blobgen as jblobgen
from yogo_tpu.data import dataset as jdataset
from yogo_tpu.data import definition as jdefinition
from yogo_tpu.data import labels as jlabels
from yogo_tpu.data import loader as jloader
from yogo_tpu.data.split_fractions import SplitFractions as JSplitFractions
from yogo_tpu_torch import native
from yogo_tpu_torch.data import blobgen, dataset, definition, labels, loader, prefetch
from yogo_tpu_torch.data import utils as data_utils
from yogo_tpu_torch.data.split_fractions import SplitFractions

SX, SY = 7, 5
HW = (40, 56)


@pytest.fixture()
def pairs(tmp_path):
    return [make_pair_dirs(tmp_path, str(i), n_images=4, seed=i) for i in range(3)]


def spec_set(specs):
    return {(str(s.image_path), str(s.label_path)) for s in specs}


# ----------------------------------------------------------------- definition
def test_definition_equals_jax_on_literal_recursive_and_test_paths(tmp_path, pairs):
    child = write_defn(tmp_path / "child.yml", dataset_pairs=pairs[1:2])
    top = write_defn(
        tmp_path / "top.yml", dataset_pairs=pairs[:1], defn_paths=[child.name],
        test_pairs=pairs[2:], split={"train": 0.75, "val": 0.25},
    )
    got = definition.DatasetDefinition.from_yaml(top)
    want = jdefinition.DatasetDefinition.from_yaml(top)
    assert got.classes == want.classes == CLASSES
    assert spec_set(got.dataset_paths) == spec_set(want.dataset_paths)
    assert spec_set(got.test_dataset_paths) == spec_set(want.test_dataset_paths)
    assert len(got.dataset_paths) == 2 and len(got.test_dataset_paths) == 1
    assert got.split_fractions.to_dict() == want.split_fractions.to_dict()
    assert got.thumbnail_augmentation is None and want.thumbnail_augmentation is None


def test_definition_thumbnail_augmentation_equals_jax(tmp_path, pairs):
    thumbs = tmp_path / "thumbs"
    thumbs.mkdir()
    make_image(thumbs / "t.png")
    defn = write_defn(tmp_path / "d.yml", dataset_pairs=pairs[:1], thumbs={"ring": str(thumbs)})
    got = definition.DatasetDefinition.from_yaml(defn).thumbnail_augmentation
    want = jdefinition.DatasetDefinition.from_yaml(defn).thumbnail_augmentation
    assert {k: [str(p) for p in v] for k, v in got.items()} == \
        {k: [str(p) for p in v] for k, v in want.items()}


@pytest.mark.parametrize("case", ["cycle", "duplicate", "class_mismatch", "missing_dir",
                                  "no_class_names", "test_overlap", "empty"])
def test_definition_raises_the_same_errors_as_jax(tmp_path, pairs, case):
    path = tmp_path / "d.yml"
    if case == "cycle":
        write_defn(path, defn_paths=[path.name])
    elif case == "duplicate":
        write_defn(path, dataset_pairs=[pairs[0], pairs[0]])
    elif case == "class_mismatch":
        child = write_defn(tmp_path / "c.yml", dataset_pairs=pairs[:1], classes=["a", "b"])
        write_defn(path, dataset_pairs=pairs[1:2], defn_paths=[child.name])
    elif case == "missing_dir":
        write_defn(path, dataset_pairs=[(tmp_path / "nope", tmp_path / "nope_l")])
    elif case == "no_class_names":
        path.write_text("dataset_paths: {}\n")
    elif case == "test_overlap":
        write_defn(path, dataset_pairs=pairs[:1], test_pairs=pairs[:1])
    else:
        path.write_text("")
    with pytest.raises(Exception) as want:
        jdefinition.DatasetDefinition.from_yaml(path)
    with pytest.raises(Exception) as got:
        definition.DatasetDefinition.from_yaml(path)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_definition_reads_json_text_with_and_without_pyyaml(tmp_path, pairs, monkeypatch):
    """JSON is YAML: the same file loads through PyYAML and, with PyYAML
    made unimportable, through the json reader; a real YAML file then
    raises and names the missing package."""
    img, lbl = pairs[0]
    as_json = tmp_path / "j.yml"
    as_json.write_text(json.dumps({
        "class_names": CLASSES,
        "dataset_paths": {"a": {"image_path": str(img), "label_path": str(lbl)}},
        "dataset_split_fractions": {"train": 0.5, "val": 0.25, "test": 0.25},
    }))
    as_yaml = write_defn(tmp_path / "y.yml", dataset_pairs=pairs[:1],
                         split={"train": 0.5, "val": 0.25, "test": 0.25})
    with_yaml = definition.DatasetDefinition.from_yaml(as_json)
    assert with_yaml == definition.DatasetDefinition.from_yaml(as_yaml)
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    without = definition.DatasetDefinition.from_yaml(as_json)
    assert without == with_yaml
    assert without.split_fractions.to_dict() == {"train": 0.5, "val": 0.25, "test": 0.25}
    with pytest.raises(definition.InvalidDatasetDefinitionFile, match="PyYAML is not installed"):
        definition.DatasetDefinition.from_yaml(as_yaml)


def test_split_fractions_equal_jax():
    for fr in ([0.75, 0.125, 0.125], [0.6, 0.2, 0.2], [1.0, 0.0, 0.0]):
        got = SplitFractions.from_list(fr, test_paths_present=False)
        want = JSplitFractions.from_list(fr, test_paths_present=False)
        for n in (0, 1, 7, 20, 321):
            assert got.partition_sizes(n) == want.partition_sizes(n)
    for bad in ([0.5, 0.2, 0.2], [1.2, -0.2, 0.0]):
        with pytest.raises(Exception) as want:
            JSplitFractions.from_list(bad, test_paths_present=False)
        with pytest.raises(Exception) as got:
            SplitFractions.from_list(bad, test_paths_present=False)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- labels
NOTES = {"categories": [{"id": 0, "name": "ring"}, {"id": 1, "name": "healthy"}, {"id": 2, "name": "misc"}]}
LABEL_FILES = {
    "numeric_space": "0 0.5 0.5 0.1 0.1\n2 0.25 0.75 0.2 0.1",
    "numeric_comma": "1,0.5,0.5,0.1,0.1\n0,0.3,0.3,0.2,0.2",
    "named": "ring 0.5 0.5 0.1 0.1\nmisc 0.2 0.2 0.1 0.1",
    "headered": "class,xc,yc,w,h\n0,0.5,0.5,0.1,0.1",
    "tiny_boxes_filtered": "0 0.5 0.5 0.001 0.001\n1 0.4 0.4 0.1 0.1",
    "empty": "",
}


# class names in a label file are resolved only beside a notes.json
LABEL_CASES = [(n, notes) for n in sorted(LABEL_FILES) for notes in (None, NOTES)
               if not (n == "named" and notes is None)]


@pytest.mark.parametrize("name,notes", LABEL_CASES)
@pytest.mark.parametrize("use_native", [True, False])
def test_load_labels_equals_jax(tmp_path, monkeypatch, name, use_native, notes):
    """Both parsers (the native one where it builds, and the csv one) give
    the JAX package's rows, with and without a notes.json remap."""
    if not use_native:
        monkeypatch.setattr(native, "parse_labels", lambda *a, **k: None)
    path = tmp_path / "l.txt"
    path.write_text(LABEL_FILES[name])
    want = jlabels.load_labels(path, CLASSES, notes_data=notes)
    got = labels.load_labels(path, CLASSES, notes_data=notes)
    assert got == want
    np.testing.assert_array_equal(
        labels.label_file_to_grid(path, SX, SY, CLASSES, notes_data=notes),
        jlabels.label_file_to_grid(path, SX, SY, CLASSES, notes_data=notes),
    )


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # the comparison is the test
        return type(e)


@pytest.mark.parametrize("text", ["0 0.5 0.5 0.1", "0 a b c d", "nosuchclass 0.5 0.5 0.1 0.1",
                                  "7 0.5 0.5 0.1 0.1 0.3", "0 0.5 0.5 0.1 0.1\nx"])
def test_load_labels_malformed_does_what_jax_does(tmp_path, text):
    """The same rows, or the same exception type, file by file."""
    path = tmp_path / "bad.txt"
    path.write_text(text)
    want = _outcome(lambda: jlabels.load_labels(path, CLASSES))
    assert _outcome(lambda: labels.load_labels(path, CLASSES)) == want
    if text.startswith(("0 0.5 0.5 0.1\n", "nosuch")) or text == "0 0.5 0.5 0.1":
        assert isinstance(want, type) and issubclass(want, Exception)


def test_notes_json_and_area_threshold_equal_jax(tmp_path):
    (tmp_path / "notes.json").write_text(json.dumps(NOTES))
    assert labels.read_notes_json(tmp_path) == jlabels.read_notes_json(tmp_path)
    assert labels.AREA_FILTER_THRESHOLD == jlabels.AREA_FILTER_THRESHOLD
    for idx in ("0", "1", "2"):
        assert labels.correct_label_idx(idx, CLASSES, NOTES) == jlabels.correct_label_idx(idx, CLASSES, NOTES)


# ------------------------------------------------------------------- datasets
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("normalize,hw", [(False, HW), (True, HW), (False, (20, 28))])
def test_object_detection_dataset_items_bit_equal(tmp_path, monkeypatch, use_native, normalize, hw):
    """Every item, through the native decoder and through PIL, with and
    without a resize; the JAX dataset reads with its own native library."""
    if not use_native:
        monkeypatch.setattr(native, "decode_image", lambda *a, **k: None)
        from yogo_tpu import native as jnative

        monkeypatch.setattr(jnative, "decode_image", lambda *a, **k: None)
    img_dir, lbl_dir = make_pair_dirs(tmp_path, "a", n_images=4, seed=3)
    kw = dict(classes=CLASSES, image_hw=hw, normalize_images=normalize)
    got = dataset.ObjectDetectionDataset(img_dir, lbl_dir, SX, SY, **kw)
    want = jdataset.ObjectDetectionDataset(img_dir, lbl_dir, SX, SY, **kw)
    assert len(got) == len(want) == 4
    for i in range(4):
        (gi, gl), (wi, wl) = got[i], want[i]
        assert gi.dtype == wi.dtype and gi.shape == wi.shape == (1, *hw)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_read_image_and_resize_equal_pil(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, (30, 44, 3)).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "rgb.png")
    got = data_utils.read_image(tmp_path / "rgb.png", rgb=True)
    np.testing.assert_array_equal(got, arr.transpose(2, 0, 1))
    gray = data_utils.read_image(tmp_path / "rgb.png")
    np.testing.assert_array_equal(gray[0], np.asarray(Image.fromarray(arr).convert("L")))
    small = data_utils.resize_image(gray, (15, 22))
    want = np.asarray(Image.fromarray(gray[0]).resize((22, 15), Image.Resampling.BILINEAR))
    np.testing.assert_array_equal(small[0], want)
    assert data_utils.read_image_robust(tmp_path / "nope.png", retries=1) is None
    assert data_utils.collate_batch_robust([None, None]) is None
    imgs, lbls = data_utils.collate_batch_robust([(gray, np.zeros(3)), None, (gray, np.ones(3))])
    assert imgs.shape == (2, 1, 30, 44) and lbls.tolist() == [[0, 0, 0], [1, 1, 1]]


def test_concat_and_subset_route_get_batch_like_jax(tmp_path):
    a = make_pair_dirs(tmp_path, "a", n_images=3, seed=1)
    b = make_pair_dirs(tmp_path, "b", n_images=2, seed=2)
    kw = dict(classes=CLASSES, image_hw=HW)
    got = dataset.ConcatDataset([dataset.ObjectDetectionDataset(*p, SX, SY, **kw) for p in (a, b)])
    want = jdataset.ConcatDataset([jdataset.ObjectDetectionDataset(*p, SX, SY, **kw) for p in (a, b)])
    assert len(got) == len(want) == 5
    idx = np.array([4, 0, 3])
    gs, ws = dataset.Subset(got, idx), jdataset.Subset(want, idx)
    for i in range(3):
        np.testing.assert_array_equal(gs[i][0], ws[i][0])
        np.testing.assert_array_equal(gs[i][1], ws[i][1])
    # live datasets have no vectorised fast path in either package
    assert gs.get_batch(np.arange(3)) is None and ws.get_batch(np.arange(3)) is None


def test_blob_dataset_items_bit_equal_after_set_epoch(tmp_path):
    thumbs = {}
    for name, shade in (("healthy", 60), ("ring", 120)):
        d = tmp_path / f"th_{name}"
        d.mkdir()
        rng = np.random.default_rng(shade)
        for i in range(3):
            arr = np.full((30, 34), shade, np.uint8) + rng.integers(0, 10, (30, 34)).astype(np.uint8)
            arr[0, :2] = 230
            Image.fromarray(arr).save(d / f"t{i}.png")
        thumbs[name] = [d]
    kw = dict(Sx=SX, Sy=SY, classes=CLASSES, n=5, length=4, background_img_shape=(200, 260), seed=5)
    got, want = blobgen.BlobDataset(thumbs, **kw), jblobgen.BlobDataset(thumbs, **kw)
    for epoch in (0, 3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(want)):
            np.testing.assert_array_equal(got[i][0], want[i][0])
            np.testing.assert_array_equal(got[i][1], want[i][1])
    got.set_epoch(4)
    assert not np.array_equal(got[0][0], want[0][0])  # the epoch decides the sample


# ---------------------------------------------------------------------- split
@pytest.mark.parametrize("n", [1, 20, 321])
def test_split_permutation_and_split_dataset_index_for_index(n):
    np.testing.assert_array_equal(loader.split_permutation(n), jloader.split_permutation(n))
    g = torch.Generator().manual_seed(loader.SPLIT_SEED)
    np.testing.assert_array_equal(loader.split_permutation(n), torch.randperm(n, generator=g).numpy())
    assert loader.SPLIT_SEED == jloader.SPLIT_SEED == 7271978
    fr = [0.6, 0.2, 0.2]
    got = loader.split_dataset(list(range(n)), SplitFractions.from_list(fr, test_paths_present=False))
    want = jloader.split_dataset(list(range(n)), JSplitFractions.from_list(fr, test_paths_present=False))
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key].indices, want[key].indices)


# --------------------------------------------------------------------- loader
class ArrayDataset:
    def __init__(self, n, fail_at=()):
        self.n = n
        self.fail_at = set(fail_at)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.fail_at:
            return None
        return np.full((1, 8, 8), i, np.uint8), np.full((6, 2, 2), i, np.float32)


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(n=10, batch_size=4),
    dict(n=10, batch_size=4, shuffle=True, epoch=3),
    dict(n=3, batch_size=8),  # smaller than a batch
    dict(n=8, batch_size=4, fail_at=(3,)),
    dict(n=8, batch_size=4, fail_at=(0, 1, 2, 3)),  # a whole batch fails
    dict(n=10, batch_size=2, shard=(1, 4)),
    dict(n=3, batch_size=2, shard=(7, 8), shuffle=True, epoch=1),
    dict(n=10, batch_size=4, num_workers=2),
    dict(n=0, batch_size=4),
])
def test_dataloader_batches_masks_and_len_equal_jax(kw):
    kw = dict(kw)
    n, fail_at, epoch = kw.pop("n"), kw.pop("fail_at", ()), kw.pop("epoch", 0)
    got = loader.DataLoader(ArrayDataset(n, fail_at), **kw)
    want = jloader.DataLoader(ArrayDataset(n, fail_at), **kw)
    got.set_epoch(epoch)
    want.set_epoch(epoch)
    assert len(got) == len(want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "entire batch failed to load" in both
        assert_same_batches(got, want)


def test_choose_num_workers_equals_jax():
    for n, req in ((100, None), (5000, 4), (5000, None), (999, 8)):
        assert loader.choose_dataloader_num_workers(n, req) == jloader.choose_dataloader_num_workers(n, req)


@pytest.mark.parametrize("override", [None, [0.5, 0.25, 0.25]])
def test_get_dataloader_end_to_end_equals_jax(tmp_path, pairs, override):
    defn = write_defn(tmp_path / "d.yml", dataset_pairs=pairs[:2], test_pairs=pairs[2:],
                      split={"train": 0.75, "val": 0.25})
    kw = dict(Sx=SX, Sy=SY, image_hw=HW)
    got = loader.get_dataloader(
        definition.DatasetDefinition.from_yaml(defn), 4, **kw,
        split_fraction_override=override and SplitFractions.from_list(override, test_paths_present=False))
    want = jloader.get_dataloader(
        jdefinition.DatasetDefinition.from_yaml(defn), 4, **kw,
        split_fraction_override=override and JSplitFractions.from_list(override, test_paths_present=False))
    assert sorted(got) == sorted(want) == ["test", "train", "val"]
    for key in want:
        got[key].set_epoch(2)
        want[key].set_epoch(2)
        assert got[key].shuffle == want[key].shuffle
        assert_same_batches(got[key], want[key])
        assert loader.get_image_count(got[key]) == jloader.get_image_count(want[key])
    np.testing.assert_array_equal(
        loader.get_class_counts(got["test"], len(CLASSES)),
        jloader.get_class_counts(want["test"], len(CLASSES)),
    )


def test_rgb_with_thumbnail_augmentation_is_refused(tmp_path, pairs):
    thumbs = tmp_path / "thumbs"
    thumbs.mkdir()
    make_image(thumbs / "t.png")
    defn = write_defn(tmp_path / "d.yml", dataset_pairs=pairs[:1], thumbs={"ring": str(thumbs)})
    with pytest.raises(ValueError, match="single-channel"):
        loader.get_datasets(definition.DatasetDefinition.from_yaml(defn), SX, SY, rgb=True, image_hw=HW)


# ------------------------------------------------------------------- hand-off
def test_pad_batch_helpers_equal_jax():
    from yogo_tpu.parallel import mesh

    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 255, (3, 1, 4, 4)).astype(np.uint8),
             rng.random((3, 6, 2, 2)).astype(np.float32), np.array([1, 1, 0], np.float32))
    for got, want in (
        (prefetch.pad_batch_to_size(*batch, 5), mesh.pad_batch_to_size(*batch, 5)),
        (prefetch.pad_batch_to_size(*batch, 3), mesh.pad_batch_to_size(*batch, 3)),
        (prefetch.pad_batch_to_multiple(*batch, 4), mesh.pad_batch_to_multiple(*batch, 4)),
    ):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("accumulate", [1, 2, 3])
def test_prefetch_yields_the_loader_batches_as_tensors_and_groups_them(accumulate):
    """5 loader batches: as they are, or stacked by `accumulate` with the
    short final group filled by zero-mask copies of its first micro-batch,
    as the JAX package's prefetch_to_device does on its mesh."""
    from yogo_tpu.parallel.mesh import get_mesh, prefetch_to_device as jprefetch

    dl = loader.DataLoader(ArrayDataset(18), batch_size=4)
    got = list(prefetch.prefetch_to_device(dl, "cpu", accumulate=accumulate))
    want = list(jprefetch(jloader.DataLoader(ArrayDataset(18), batch_size=4), get_mesh(),
                          accumulate=accumulate))
    assert len(got) == len(want) == -(-5 // accumulate)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            b = np.asarray(b)
            if accumulate == 1:
                b = b[: a.shape[0]]  # the mesh pads the batch to its 8 devices
            else:
                b = b[:, : a.shape[1]]
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b)
    if accumulate == 2:
        imgs, _, mask = got[-1]
        assert imgs.shape == (2, 4, 1, 8, 8) and mask[1].sum() == 0
        assert torch.equal(imgs[1], imgs[0])


def test_prefetch_never_wraps_a_read_only_array():
    ro = np.zeros((2, 1, 4, 4), np.uint8)
    ro.setflags(write=False)
    batches = [(ro, np.zeros((2, 6, 1, 1), np.float32), np.ones(2, np.float32))]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (imgs, labels, mask), = prefetch.prefetch_to_device(batches, "cpu")
    imgs += 1  # writable, and not the source's memory
    assert ro.sum() == 0 and mask.tolist() == [1.0, 1.0]
    assert list(prefetch.prefetch_to_device([], "cpu")) == []


@pytest.mark.parametrize("accumulate", [1, 2])
def test_prefetch_thread_hands_out_what_the_caller_s_thread_would(accumulate):
    """The thread yields the loader's batches, in the loader's order: the
    same as reading the loader and grouping it in the caller's thread."""
    dl = loader.DataLoader(ArrayDataset(18), batch_size=4, shuffle=True)
    direct = list(prefetch._grouped(iter(dl), accumulate))
    threaded = list(prefetch.prefetch_to_device(dl, "cpu", accumulate=accumulate))
    assert len(direct) == len(threaded) > 0
    for a, t in zip(direct, threaded):
        for x, y in zip(a, t):
            np.testing.assert_array_equal(x, y.numpy())


def test_prefetch_thread_forwards_errors_and_stops_when_the_consumer_leaves():
    import threading

    def failing():
        yield (np.zeros((1, 1, 2, 2), np.uint8), np.zeros((1, 6, 1, 1), np.float32), np.ones(1, np.float32))
        raise OSError("disk gone")

    it = prefetch.prefetch_to_device(failing(), "cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    pulled = []

    def endless():
        while True:
            pulled.append(1)
            yield (np.zeros((1, 1, 2, 2), np.uint8), np.zeros((1, 6, 1, 1), np.float32),
                   np.ones(1, np.float32))

    it = prefetch.prefetch_to_device(endless(), "cpu")
    next(it)
    it.close()  # what a break in the epoch loop does
    assert not any(t.name == "yogo-prefetch" for t in threading.enumerate())
    assert len(pulled) <= 4  # it ran ahead by the queue's depth, not without end
