"""The port's auxiliaries against the JAX package's on the CPU: anchor
clustering (utils/cluster_anchors.py), the wandb helpers with a fake
`wandb` (utils/wandb_helpers.py, as tests/test_gated_paths.py fakes it),
and the ultralytics-format exporter (data/utils.py). All numpy or file
outputs: held equal."""

import sys
import types

import numpy as np
import pytest
import yaml

from tests.data_fixtures import CLASSES, make_label_file, make_pair_dirs, write_defn
from yogo_tpu.data.utils import (
    convert_dataset_definition_to_ultralytics_format as jax_convert,
)
from yogo_tpu.utils import cluster_anchors as jca
from yogo_tpu.utils import wandb_helpers as jwh
from yogo_tpu_torch.data.utils import convert_dataset_definition_to_ultralytics_format
from yogo_tpu_torch.utils import cluster_anchors as ca
from yogo_tpu_torch.utils import wandb_helpers as wh


# ------------------------------------------------------------------ anchors
def test_box_conversions_iou_and_random_boxes_equal_jax_s():
    rng = np.random.default_rng(0)
    centers = np.stack([rng.uniform(0.3, 0.7, 16), rng.uniform(0.3, 0.7, 16),
                        rng.uniform(0.05, 0.2, 16), rng.uniform(0.05, 0.2, 16)], axis=1)
    corners = ca.centers_to_corners(centers)
    np.testing.assert_array_equal(corners, jca.centers_to_corners(centers))
    np.testing.assert_allclose(ca.corners_to_centers(corners), centers, atol=1e-12)
    np.testing.assert_array_equal(ca.iou(corners[:, None], corners[None]),
                                  jca.iou(corners[:, None], corners[None]))
    np.testing.assert_allclose(np.diag(ca.iou(corners[:, None], corners[None])), 1.0)
    np.testing.assert_array_equal(ca.gen_random_box(4, rng=np.random.default_rng(3)),
                                  jca.gen_random_box(4, rng=np.random.default_rng(3)))


@pytest.mark.parametrize("k,seed", [(1, 0), (3, 0), (3, 7)])
def test_k_means_equals_jax_s(k, seed):
    rng = np.random.default_rng(1)
    small = np.stack([np.full(50, 0.3), np.full(50, 0.4)] * 2, axis=1) + rng.normal(0, 0.002, (50, 4))
    big = np.stack([np.full(50, 0.1), np.full(50, 0.5)] * 2, axis=1) + rng.normal(0, 0.01, (50, 4))
    data = np.concatenate([small, big])
    means = ca.k_means(data, k=k, seed=seed)
    np.testing.assert_array_equal(means, jca.k_means(data, k=k, seed=seed))
    if k == 1:
        np.testing.assert_allclose(means[0], data.mean(axis=0), atol=0.01)


def test_best_anchor_equals_jax_s_and_tolerates_empty_dirs(tmp_path):
    full = tmp_path / "labels"
    full.mkdir()
    make_label_file(full / "a.txt", [[0, 0.5, 0.5, 0.1, 0.2], [1, 0.3, 0.3, 0.12, 0.18]])
    make_label_file(full / "b.csv", [[0, 0.7, 0.7, 0.09, 0.21]])
    (full / "b.csv").write_text((full / "b.csv").read_text().replace(" ", ","))
    empty = tmp_path / "empty"
    empty.mkdir()
    w, h = ca.best_anchor([full, empty])
    assert (w, h) == jca.best_anchor([full, empty])
    assert abs(w - 0.1) < 0.02 and abs(h - 0.2) < 0.02
    np.testing.assert_array_equal(ca.get_dataset_bounding_boxes([full, empty]),
                                  jca.get_dataset_bounding_boxes([full, empty]))
    with pytest.raises(ValueError, match="no bounding boxes"):
        ca.best_anchor([empty])


# -------------------------------------------------------------------- wandb
@pytest.fixture
def fake_wandb(monkeypatch):
    mod = types.ModuleType("wandb")

    class _Table:
        def __init__(self, data=None, columns=None):
            self.data = data
            self.columns = columns

    mod.Table = _Table
    mod.plot_table = lambda vspec, table, fields, strings: (vspec, table, fields, strings)
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


@pytest.mark.parametrize("fpr,tpr,thr", [
    ([np.linspace(0, 1, 5)] * 2, [np.linspace(0, 1, 5) ** 0.5, np.linspace(0, 1, 5) ** 2],
     np.linspace(0, 1, 5)),
    ([[0.0, 0.5, 1.0], [0.0, 0.2, 0.6, 1.0]], [[0.0, 0.7, 1.0], [0.0, 0.4, 0.8, 1.0]],
     [[0.9, 0.5, 0.1], [0.95, 0.6, 0.3, 0.05]]),
    ([0.0, 0.5, 1.0], [[0.0, 0.7, 1.0], [0.0, 0.4, 0.8]], [0.9, 0.5, 0.1]),
])
def test_wandb_roc_table_equals_jax_s(fake_wandb, fpr, tpr, thr):
    got = wh.get_wandb_roc(fpr, tpr, thr, ["a", "b"])
    want = jwh.get_wandb_roc(fpr, tpr, thr, ["a", "b"])
    assert got.columns == want.columns == ["fpr", "tpr", "threshold", "class"]
    assert got.data == want.data and len(got.data) == sum(len(t) for t in tpr)


def test_wandb_confusion_plot_equals_jax_s_and_a_free_port(fake_wandb):
    conf = np.array([[5, 1, 0], [2, 7, 1], [0, 0, 3]])
    vspec, table, fields, strings = wh.get_wandb_confusion(conf, ["a", "b", "c"], "test confusion")
    jspec, jtable, jfields, jstrings = jwh.get_wandb_confusion(conf, ["a", "b", "c"], "test confusion")
    assert (vspec, fields, strings) == (jspec, jfields, jstrings)
    assert vspec == "wandb/confusion_matrix/v1" and strings == {"title": "test confusion"}
    assert table.data == jtable.data and ("0 - a", "1 - b", 1) in table.data
    with pytest.raises(AssertionError, match="nc1 != nc2"):
        wh.get_wandb_confusion(conf, ["a", "b"])
    port = wh.get_free_port()
    assert 0 < port < 65536
    assert not hasattr(wh, "choose_device")


# -------------------------------------------------------------- ultralytics
def test_ultralytics_converter_writes_the_jax_package_s_tree(tmp_path):
    pairs = [make_pair_dirs(tmp_path, "u0"), make_pair_dirs(tmp_path, "u1")]
    test_pairs = [make_pair_dirs(tmp_path, "ut")]
    defn = write_defn(tmp_path / "d.yml", dataset_pairs=pairs, test_pairs=test_pairs,
                      split={"train": 0.8, "val": 0.2})
    specs = {}
    for name, convert in (("port", convert_dataset_definition_to_ultralytics_format),
                          ("jax", jax_convert)):
        target = tmp_path / name
        convert(defn, target)
        convert(defn, target)  # a second run over existing links is a no-op
        spec = yaml.safe_load((target / "dataset_defn.yaml").read_text())
        links = sorted(p.relative_to(target) for p in target.rglob("*") if p.is_symlink())
        specs[name] = (spec, links, {str(p): (target / p).resolve() for p in links})
        assert spec["path"] == str(target.resolve())
    (port, port_links, port_dst), (jax, jax_links, jax_dst) = specs["port"], specs["jax"]
    assert port["names"] == jax["names"] == dict(enumerate(CLASSES))
    assert len(port["train"]) == 2 and len(port["val"]) == 1
    for key in ("train", "val"):
        assert [p.replace(str(tmp_path / "port"), "") for p in port[key]] == \
            [p.replace(str(tmp_path / "jax"), "") for p in jax[key]]
    assert port_links == jax_links and port_dst == jax_dst
    assert all(dst.is_dir() for dst in port_dst.values())
