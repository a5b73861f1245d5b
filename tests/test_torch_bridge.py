"""Reference `.pth` checkpoints between the packages
(yogo_tpu_torch/utils/torch_bridge.py against yogo_tpu/utils/torch_bridge.py):
a `.pth` written by either package loads in the other with every tensor
EQUAL (bit for bit) to the JAX package's load_checkpoint of the `.ckpt` it
came from, the model configuration and metadata equal; `load_any` reads a
`.pth` into the same Predictor head as the `.ckpt` (exact: same weights,
same CPU ops); ConvNeXt's timm keys too (tests/test_torch_convnext.py
holds them against the JAX package's map)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from yogo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from yogo_tpu.utils.torch_bridge import load_pth as jax_load_pth
from yogo_tpu.utils.torch_bridge import save_pth as jax_save_pth
from yogo_tpu_torch.infer import Predictor
from yogo_tpu_torch.utils.checkpoint import load_any, load_checkpoint
from yogo_tpu_torch.utils.torch_bridge import load_pth, save_pth

GOLDENS = Path(__file__).parent / "goldens"
CKPTS = sorted(p.name for p in GOLDENS.glob("*.ckpt"))
FIELDS = ("img_size", "anchor_w", "anchor_h", "num_classes", "is_rgb", "normalize_images",
          "clip_value", "model_version", "height_multiplier", "width_multiplier")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same_variables(variables, jvariables):
    got, want = _flatten(variables), _flatten(jvariables)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        assert got[key].tobytes() == w.tobytes(), key


def _assert_same_config(model, jmodel):
    # the .pth holds anchors and multipliers as float32 buffers, so both
    # readers give the same float32-rounded values, not the .ckpt's
    for f in FIELDS:
        assert tuple(np.atleast_1d(getattr(model, f))) == tuple(np.atleast_1d(getattr(jmodel, f))), f


@pytest.mark.parametrize("name", CKPTS)
def test_jax_written_pth_loads_in_the_port(tmp_path, name):
    jmodel, jvariables, _ = jax_load_checkpoint(GOLDENS / name)
    pth = tmp_path / "jax.pth"
    jax_save_pth(pth, jmodel, jvariables, classes=["cell", "parasite"], model_name="m", step=7)
    model, variables, meta = load_pth(pth)
    _assert_same_variables(variables, jvariables)
    _assert_same_config(model, jax_load_pth(pth)[0])
    assert meta == {"step": 7, "class_names": ["cell", "parasite"], "normalize_images": False,
                    "epoch": 0, "model_name": "m"}


@pytest.mark.parametrize("name", CKPTS)
def test_port_written_pth_loads_in_jax(tmp_path, name):
    model, variables, _ = load_checkpoint(GOLDENS / name)
    pth = tmp_path / "port.pth"
    save_pth(pth, model, variables, classes=["cell", "parasite"], epoch=3)
    jmodel, jvariables, jmeta = jax_load_pth(pth)
    _assert_same_variables(variables, jvariables)
    _assert_same_config(load_pth(pth)[0], jmodel)
    assert jmeta["class_names"] == ["cell", "parasite"] and jmeta["epoch"] == 3
    # the config buffers of the reference model ride along, equal to JAX's
    ours = torch.load(pth, weights_only=True)["model_state_dict"]
    jax_pth = tmp_path / "jax.pth"
    jax_save_pth(jax_pth, jmodel, jvariables)
    theirs = torch.load(jax_pth, weights_only=True)["model_state_dict"]
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k


def test_load_any_pth_gives_the_ckpt_s_head(tmp_path):
    ckpt = GOLDENS / "trained_half_filters.ckpt"
    model, variables, _ = load_checkpoint(ckpt)
    save_pth(tmp_path / "m.pth", model, variables, classes=["cell", "parasite"])
    (tmp_path / "sniffed.bin").write_bytes((tmp_path / "m.pth").read_bytes())
    x = np.random.default_rng(0).integers(0, 256, (2, 1, 96, 128), np.uint8)
    want = Predictor.from_checkpoint(ckpt, device="cpu").forward_raw(x)
    for path in (tmp_path / "m.pth", tmp_path / "sniffed.bin"):
        m, _, meta = load_any(path)
        assert meta["class_names"] == ["cell", "parasite"] and m.model_version == "half_filters"
        pred = Predictor.from_checkpoint(path, device="cpu")
        assert torch.equal(pred.forward_raw(x), want)


def test_convnext_pth_raises_naming_its_roadmap_item(tmp_path):
    """Named when ConvNeXt .pth interop raised naming ROADMAP item 12; the
    item is done. Now: a convnext .pth written by the port is read by the
    JAX package with every tensor equal, and one missing a block's tensor
    raises naming the key."""
    from yogo_tpu_torch.models.yogo import YOGO
    from yogo_tpu_torch.utils.weights import flax_from_state_dict

    model = YOGO.create((96, 128), 0.1, 0.1, 2, model_version="convnext_small")
    net = model.init(torch.Generator().manual_seed(0), device="cpu")
    variables = {"params": flax_from_state_dict(net.state_dict())["params"]}
    save_pth(tmp_path / "c.pth", model, variables, classes=["a", "b"])
    jm, jv, meta = jax_load_pth(tmp_path / "c.pth")
    assert jm.model_version == "convnext_small" and meta["class_names"] == ["a", "b"]
    _assert_same_variables(variables, jv)
    _, tv, _ = load_any(tmp_path / "c.pth")
    _assert_same_variables(variables, tv)
    payload = torch.load(tmp_path / "c.pth", weights_only=True)
    del payload["model_state_dict"]["model.1.2.blocks.26.mlp.fc1.weight"]
    torch.save(payload, tmp_path / "cut.pth")
    with pytest.raises(KeyError, match="blocks.26.mlp.fc1.weight"):
        load_any(tmp_path / "cut.pth")
