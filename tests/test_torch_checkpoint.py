"""The port's checkpoint reader (msgpack_lite + load_checkpoint) returns
exactly what the JAX package's flax-based reader returns on every committed
checkpoint, and its weights load into the torch ConvStack strictly."""

from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

from yogo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from yogo_tpu_torch.utils import msgpack_lite
from yogo_tpu_torch.utils.checkpoint import load_checkpoint
from yogo_tpu_torch.utils.weights import state_dict_from_flax

GOLDENS = Path(__file__).parent / "goldens"
CKPTS = sorted(p.name for p in GOLDENS.glob("*.ckpt"))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_all_three_goldens_found():
    assert len(CKPTS) == 3


@pytest.mark.parametrize("name", CKPTS)
def test_load_checkpoint_bit_equal_to_jax(name):
    model, variables, meta = load_checkpoint(GOLDENS / name)
    jmodel, jvariables, jmeta = jax_load_checkpoint(GOLDENS / name)

    got, want = _flatten(variables), _flatten(jvariables)
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        assert got[key].tobytes() == w.tobytes(), key
    assert meta == jmeta
    for field in (
        "img_size", "anchor_w", "anchor_h", "num_classes", "is_rgb",
        "normalize_images", "clip_value", "model_version",
        "height_multiplier", "width_multiplier",
    ):
        assert getattr(model, field) == getattr(jmodel, field), field
    assert model.grid == jmodel.grid


@pytest.mark.parametrize("name", CKPTS)
def test_state_dict_loads_strict(name):
    model, variables, _ = load_checkpoint(GOLDENS / name)
    stack = model.module("cpu")
    sd = state_dict_from_flax(variables)
    stack.load_state_dict(sd, strict=True)
    k = np.asarray(variables["params"]["conv1"]["kernel"])  # HWIO
    np.testing.assert_array_equal(stack.conv1.weight.detach().numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        stack.bn0.running_var.numpy(), np.asarray(variables["batch_stats"]["bn0"]["var"])
    )
    assert stack.conv0.bias is None and stack.conv4.bias is None


def test_msgpack_lite_matches_msgpack_on_mixed_payload():
    rng = np.random.default_rng(0)
    payload = {
        "s": "x" * 40, "short": "abc", "n": None, "t": True, "f": False,
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40, -1, -32,
                 -33, -128, -129, -32768, -32769, -2**31 - 1, -2**40],
        "floats": [0.5, -1e300, float(np.float32(1.25))],
        "bin": bytes(rng.integers(0, 256, 300, dtype=np.uint8)),
        "nested": {str(i): list(range(i)) for i in range(20)},
        "big_list": list(range(70000)),
    }
    raw = msgpack.packb(payload, use_bin_type=True)
    assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw, raw=False, strict_map_key=False)
    single = msgpack.packb(np.float32(2.5).item(), use_single_float=True)
    assert msgpack_lite.unpackb(single) == 2.5


def test_msgpack_lite_ndarray_ext_and_rejects_others():
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    inner = msgpack.packb([list(arr.shape), "float32", arr.tobytes()], use_bin_type=True)
    got = msgpack_lite.unpackb(msgpack.packb({"a": msgpack.ExtType(1, inner)}))
    np.testing.assert_array_equal(got["a"], arr)
    for code in (2, 3, 7):
        with pytest.raises(msgpack_lite.MsgpackError, match="ext type"):
            msgpack_lite.unpackb(msgpack.packb(msgpack.ExtType(code, inner)))
    with pytest.raises(msgpack_lite.MsgpackError, match="trailing"):
        msgpack_lite.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(msgpack_lite.MsgpackError, match="truncated"):
        msgpack_lite.unpackb(msgpack.packb("abcdef")[:-2])


def test_weights_reach_the_torch_conv():
    """A conv in the carried layout computes what the flax HWIO kernel
    computes (one block, f32, checked against a direct numpy conv)."""
    model, variables, _ = load_checkpoint(GOLDENS / "trained_half_filters.ckpt")
    stack = model.module("cpu")
    stack.load_state_dict(state_dict_from_flax(variables), strict=True)
    k = np.asarray(variables["params"]["conv1"]["kernel"], np.float64)  # (3,3,I,O)
    x = np.random.default_rng(1).standard_normal((1, k.shape[2], 6, 7))
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = np.zeros((1, k.shape[3], 6, 7))
    for dy in range(3):
        for dx in range(3):
            want += np.einsum("bchw,co->bohw", xp[:, :, dy : dy + 6, dx : dx + 7], k[dy, dx])
    got = torch.nn.functional.conv2d(
        torch.from_numpy(x).float(), stack.conv1.weight, None, 1, 1
    ).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
