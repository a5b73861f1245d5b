"""The port's architecture registry and grid arithmetic equal the JAX
package's (exact) on the JAX package's 12 architectures, the port imports
no JAX, and its entry points refuse to run without CUDA unless asked for
the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yogo_tpu.models import defns as jdefns
from yogo_tpu.ops import grid as jgrid
from yogo_tpu_torch.models import defns as tdefns
from yogo_tpu_torch.ops import grid as tgrid

REPO = Path(__file__).resolve().parent.parent
ARCHS = sorted(jdefns.MODELS)
SIZES = [(96, 128), (772, 1032)]


def test_registry_names_equal():
    """The port has the JAX package's 12 architectures and swin_small,
    which only the port has."""
    assert sorted(tdefns.MODELS) == sorted(ARCHS + ["swin_small"])
    assert len(ARCHS) == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_defns_equal(arch):
    for rgb in (False, True):
        j = jdefns.get_model_defn(arch)(4, rgb)
        t = tdefns.get_model_defn(arch)(4, rgb)
        assert (t.name, t.family) == (j.name, j.family)
        assert [vars(b) for b in t.blocks] == [vars(b) for b in j.blocks]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_grid_and_offsets_equal(arch, hw):
    blocks = tdefns.get_model_defn(arch)(2).blocks
    sx, sy = tgrid.grid_size(blocks, *hw)
    assert (sx, sy) == jgrid.grid_size(jdefns.get_model_defn(arch)(2).blocks, *hw)
    for got, want in zip(tgrid.cell_offsets(sx, sy), jgrid.cell_offsets(sx, sy)):
        np.testing.assert_array_equal(got, want)


def test_base_model_fullres_grid():
    blocks = tdefns.get_model_defn("base_model")(2).blocks
    assert tgrid.grid_size(blocks, 772, 1032) == (129, 97)
    assert tgrid.WH_CLAMP == jgrid.WH_CLAMP


def test_temporary_model_scoped():
    def scratch_arch(num_classes, rgb_input=False):
        return tdefns.base_model(num_classes, rgb_input)

    with tdefns.temporary_model(scratch_arch):
        assert tdefns.get_model_defn("scratch_arch") is scratch_arch
    assert "scratch_arch" not in tdefns.MODELS
    assert tdefns.get_model_defn("nope") is tdefns.base_model


def test_port_imports_no_jax():
    """Every module of yogo_tpu_torch imports without pulling in jax, flax,
    optax, msgpack or yogo_tpu, and without PIL or yaml, which the machine
    it runs on may lack: those two are imported where they are used."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "yogo_tpu_torch").rglob("*.py")
        if "_build" not in p.parts  # kernel build outputs, not modules
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'msgpack', 'yogo_tpu', 'PIL', 'yaml'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr
    assert any(m.endswith("__main__") for m in mods) and len(mods) > 15
    for new in ("data.loader", "data.packed_cache", "data.prefetch", "metrics.device_metrics",
                "native", "utils.argparsers", "utils.logging", "utils.test_model",
                "utils.export_model", "utils.onnx_proto", "utils.onnx_interp", "utils.cluster_anchors",
                "utils.wandb_helpers", "ops.window_nms", "parallel.spatial"):
        assert f"yogo_tpu_torch.{new}" in mods


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "yogo_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "flax", "optax", "msgpack", "yogo_tpu", "PIL", "yaml"}, roots


def test_entry_points_require_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from yogo_tpu_torch.infer import Predictor, predict
    from yogo_tpu_torch.models.yogo import YOGO

    ckpt = REPO / "tests" / "goldens" / "trained_half_filters.ckpt"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict(ckpt, path_to_images=tmp_path, count_predictions=True, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor.from_checkpoint(ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOGO.create((96, 128), 0.1, 0.1, 2).module()
    assert YOGO.create((96, 128), 0.1, 0.1, 2).module("cpu").conv0.weight.device.type == "cpu"
