"""The port's YOGO forward against the JAX package's YOGO.apply on the CPU,
with the same weights (YOGO.init, carried by state_dict_from_flax) and the
same seeded inputs, at 64x96:
  - float32: raw NHWC head and decoded output at rtol = atol = 1e-4
    (same math, different conv summation order; weights damped 0.7x);
  - bf16 with the fused stem (the port's plain version vs the Pallas kernel
    in interpret mode): the damped weights and tolerances of
    tests/test_pallas_stem.py (bf16 rounding noise through 7 blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yogo_tpu.models.yogo import YOGO as JYOGO
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.ops import stem
from yogo_tpu_torch.utils.weights import state_dict_from_flax

HW = (64, 96)
ARCHS = ["base_model", "half_filters"]


def _variables(arch: str, scale: float = 1.0):
    """flax variables from YOGO.init, with seeded non-trivial BN statistics."""
    jm = JYOGO.create(HW, 0.08, 0.1, 3, model_version=arch)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    rng = np.random.default_rng(1)
    for name, stats in v["batch_stats"].items():
        n = stats["mean"].shape[0]
        stats["mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        v["params"][name]["scale"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
    return jax.tree.map(lambda a: (scale * a).astype(np.float32), v)


def _port(arch: str, v, dtype=torch.float32, channels_last=True):
    m = YOGO.create(HW, 0.08, 0.1, 3, model_version=arch, compute_dtype=dtype)
    stack = m.module("cpu", channels_last=channels_last)
    stack.load_state_dict(state_dict_from_flax(v), strict=True)
    return m, stack


def _images(seed: int, n: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, 1, *HW), np.uint8)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_raw_and_decoded_match_jax(arch, channels_last):
    # damped so the untrained head stays O(1-10): undamped, its logits
    # reach ~200 and f32 summation-order noise alone nears 1e-4 relative
    v = _variables(arch, scale=0.7)
    x = _images(2)
    jm = JYOGO.create(HW, 0.08, 0.1, 3, model_version=arch)
    want_raw = np.asarray(jm.apply(v, jnp.asarray(x), decode=False))
    want_dec = np.asarray(jm.apply(v, jnp.asarray(x), inference=True))

    m, stack = _port(arch, v, channels_last=channels_last)
    got_raw = m.apply(stack, torch.from_numpy(x), decode=False)
    got_dec = m.apply(stack, torch.from_numpy(x), inference=True)
    assert got_raw.shape == (2, m.Sy, m.Sx, 8) == want_raw.shape
    assert got_dec.shape == (2, 8, m.Sy, m.Sx) == want_dec.shape
    np.testing.assert_allclose(got_raw.numpy(), want_raw, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_dec.numpy(), want_dec, rtol=1e-4, atol=1e-4)
    logits = m.apply(stack, torch.from_numpy(x), inference=False)
    want_logits = np.asarray(jm.apply(v, jnp.asarray(x), inference=False))
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_with_stem_matches_jax_pallas_interpret(arch, monkeypatch):
    v = _variables(arch, scale=0.3)
    x = _images(0)
    jm = JYOGO.create(HW, 0.08, 0.1, 3, model_version=arch, compute_dtype=jnp.bfloat16)
    monkeypatch.setenv("YOGO_PALLAS_STEM", "interpret")
    assert jm._stem_pallas_mode(jnp.asarray(x), False, False) == "interpret"
    ref = np.asarray(jm.apply(v, jnp.asarray(x), inference=True))

    m, stack = _port(arch, v, dtype=torch.bfloat16)
    assert m.stem_kernel_eligible(stack, torch.from_numpy(x))
    got = m.apply(stack, torch.from_numpy(x), inference=True).numpy()
    raw = m.apply(stack, torch.from_numpy(x), decode=False)
    assert raw.dtype == torch.bfloat16

    assert got.shape == ref.shape
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0.05, atol=0.02)
    np.testing.assert_allclose(np.log(got[:, 2:4]), np.log(ref[:, 2:4]), rtol=0.05, atol=0.1)
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=0.05, atol=0.02)


def test_stem_path_is_block0_of_the_stack():
    """With the gate open, apply() = plain stem + blocks 1..7; the same
    weights through the plain bf16 conv block 0 agree to bf16 noise."""
    v = _variables("base_model", scale=0.3)
    m, stack = _port("base_model", v, dtype=torch.bfloat16)
    x = torch.from_numpy(_images(3))
    w9, b9 = stack.folded_stem()
    with torch.inference_mode():
        h_stem = stem.fused_stem_reference(x[:, 0], w9, b9, layout="nhwc")
        h_conv = stack(x.float().to(torch.bfloat16))  # full stack, no stem
        via_stem = stack(h_stem, start_block=1)
    np.testing.assert_allclose(
        via_stem.float().numpy(), h_conv.float().numpy(), rtol=0.05, atol=0.05
    )
    got = m.apply(stack, x, decode=False)
    np.testing.assert_array_equal(
        got.float().numpy(), via_stem.permute(0, 2, 3, 1).float().numpy()
    )


ELIG_CASES = [
    # (arch, rgb, dtype is bf16, uint8 input, train mode, img size)
    ("base_model", False, True, True, False, HW),
    ("half_filters", False, True, True, False, HW),
    ("depth_ver_3", False, True, True, False, HW),
    ("base_model", False, False, True, False, HW),
    ("base_model", False, True, False, False, HW),
    ("base_model", False, True, True, True, HW),
    ("base_model", True, True, True, False, HW),
    ("silu_model", False, True, True, False, HW),
    ("convnext_small", False, True, True, False, HW),
    ("base_model", False, True, True, False, (64, 98)),
    ("base_model", False, True, True, False, (66, 97)),
]


@pytest.mark.parametrize("arch,rgb,bf16,u8,train,hw", ELIG_CASES)
def test_stem_gate_matches_jax(arch, rgb, bf16, u8, train, hw, monkeypatch):
    monkeypatch.setenv("YOGO_PALLAS_STEM", "interpret")
    jm = JYOGO.create(hw, 0.08, 0.1, 3, model_version=arch, is_rgb=rgb,
                      compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    ch = 3 if rgb else 1
    jx = jnp.zeros((1, ch, *hw), jnp.uint8 if u8 else jnp.float32)
    want = jm._stem_pallas_mode(jx, train=train, mutable=train) is not None

    m = YOGO.create(hw, 0.08, 0.1, 3, model_version=arch, is_rgb=rgb,
                    compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    stack = torch.nn.Module().train(train)
    tx = torch.zeros((1, ch, *hw), dtype=torch.uint8 if u8 else torch.float32)
    assert m.stem_kernel_eligible(stack, tx) == want


def test_resize_and_compute_dtype_match_jax():
    jm = JYOGO.create((772, 1032), 0.04, 0.05, 2).resize(193)
    m = YOGO.create((772, 1032), 0.04, 0.05, 2).resize(193)
    assert m.img_size == jm.img_size and m.grid == jm.grid
    assert (m.height_multiplier, m.width_multiplier) == (jm.height_multiplier, jm.width_multiplier)
    assert m.with_compute_dtype(torch.bfloat16).compute_dtype == torch.bfloat16
    assert m.resize(772).height_multiplier == 1.0
