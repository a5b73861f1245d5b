"""The port's int8 conv (yogo_tpu_torch/ops/int8_conv.py) against the JAX
package's XLA s8 x s8 -> s32 conv (yogo_tpu/ops/quant.py `_conv`) and an
exact integer oracle on the CPU, and the CUDA kernel against its plain
version where a GPU is present.

JAX is imported inside the tests that compare with it, so the CUDA test
runs on a GPU machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int8_conv.py -m cuda
Tolerances: integer accumulators and int8 codes exactly equal; f32 outputs
bit-equal for the identity and LeakyReLU epilogues (the same two roundings
as the JAX program's ops); SiLU within rtol 1e-6 and 2 ulp of the largest product (torch's
x / (1 + exp(-x)) against JAX's x * sigmoid(x)), and its requant codes
within 1.
"""

import numpy as np
import pytest
import torch

from yogo_tpu_torch.ops import int8_conv as ic

# (B, H, W, cin, cout, kernel, stride): odd H and W, C_in not a multiple of
# 32 (half_filters' 8 / 24), wide (256), C_out 7 (a quantized head) and 40;
# ConvNeXt's 2x2 stride-2 VALID downsample (an odd H / W drops its last
# row / column), padding (kernel - 1) // 2 throughout
CASES = [
    (2, 9, 11, 8, 16, 3, 1),
    (2, 9, 11, 24, 7, 3, 2),
    (1, 7, 5, 40, 40, 3, 2),
    (2, 6, 9, 256, 8, 1, 1),
    (1, 5, 6, 128, 130, 3, 1),
    (3, 3, 5, 24, 7, 3, 2),
    (2, 9, 11, 64, 48, 2, 2),
    (1, 8, 12, 192, 384, 2, 2),
]


def _case(seed, b, h, w, cin, cout, k):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    w8 = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    deq = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    return x, w8, deq, bias


def _codes(x: np.ndarray) -> torch.Tensor:
    """int8 NHWC -> the kernel's codes, channels padded with zero codes."""
    cp = ic.padded_channels(x.shape[-1])
    return torch.from_numpy(np.pad(x, ((0, 0), (0, 0), (0, 0), (0, cp - x.shape[-1]))))


def _oracle(x, w8, stride, pad):
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    k = w8.shape[0]
    ho, wo = ic.out_hw(x.shape[1], x.shape[2], k, stride, pad)
    out = np.zeros((x.shape[0], ho, wo, w8.shape[-1]), np.int64)
    for i in range(ho):
        for j in range(wo):
            patch = xp[:, stride * i : stride * i + k, stride * j : stride * j + k, :]
            out[:, i, j] = np.tensordot(patch, w8.astype(np.int64), 3)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_accumulators_equal_jax_and_integer_oracle(case):
    import jax.numpy as jnp

    from yogo_tpu.models.defns import ConvSpec
    from yogo_tpu.ops import quant

    b, h, w, cin, cout, k, s = case
    pad = (k - 1) // 2
    x, w8, _, _ = _case(0, b, h, w, cin, cout, k)
    got = ic.conv_acc_reference(_codes(x), ic.pack_weights(w8), cin, s, pad)
    got = got.permute(0, 2, 3, 1).numpy()
    spec = ConvSpec(cout, kernel=k, stride=s, padding=pad)
    want = np.asarray(quant._conv(jnp.asarray(x), jnp.asarray(w8), spec, jnp.int32))
    assert want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(x, w8, s, pad))


@pytest.mark.parametrize("act", [None, "leaky_relu", "silu"])
@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "x".join(map(str, c)))
def test_plain_epilogue_and_requant_equal_the_jax_program(case, act):
    """f32 out: act(float(acc) * deq + b), as quantized_forward's lines
    612-614 compute it op by op (under jit XLA may contract the multiply-add
    into one FMA, a rounding fewer: within 1 ulp); int8 out: the next
    block's codes clip(round(h / s)) (:609-611) with zero codes in the
    padded channels."""
    import jax
    import jax.numpy as jnp

    from yogo_tpu.models.defns import ConvSpec
    from yogo_tpu.ops import quant

    b, h, w, cin, cout, k, s = case
    pad = (k - 1) // 2
    x, w8, deq, bias = _case(1, b, h, w, cin, cout, k)
    spec = ConvSpec(cout, kernel=k, stride=s, padding=pad, act=act)
    acc = quant._conv(jnp.asarray(x), jnp.asarray(w8), spec, jnp.int32)
    def epilogue(a):
        return quant._act_fn(act)(a.astype(jnp.float32) * deq + bias)

    want_h = np.asarray(epilogue(acc))
    scale = np.float32(np.abs(want_h).max() / 100.0)
    want_q = np.asarray(jnp.clip(jnp.round(want_h / scale), -127, 127).astype(jnp.int8))

    args = (_codes(x), ic.pack_weights(w8), torch.from_numpy(deq), torch.from_numpy(bias))
    kw = dict(cin=cin, stride=s, padding=pad, act=act)
    got_h = ic.int8_conv(*args, **kw).numpy()
    got_q = ic.int8_conv(*args, **kw, out_scale=torch.tensor([scale])).numpy()
    assert got_h.shape == want_h.shape and got_h.dtype == np.float32
    # one rounding of the largest |float(acc) * deq| bounds what an FMA or
    # another SiLU formula moves (relative ulps blow up where h cancels to ~0)
    ulp = float(np.spacing(np.float32(np.abs(np.asarray(acc, np.float32) * deq).max())))
    if act == "silu":
        np.testing.assert_allclose(got_h, want_h, rtol=1e-6, atol=2 * ulp)
        assert np.abs(got_q[..., :cout].astype(int) - want_q).max() <= 1
    else:
        np.testing.assert_array_equal(got_h, want_h)
        np.testing.assert_array_equal(got_q[..., :cout], want_q)
        np.testing.assert_allclose(got_h, np.asarray(jax.jit(epilogue)(acc)), rtol=0, atol=ulp)
    assert got_q.shape[-1] == ic.padded_channels(cout) and not got_q[..., cout:].any()


def test_pack_weights_layout():
    w8 = np.arange(3 * 3 * 5 * 2, dtype=np.int64).reshape(3, 3, 5, 2).astype(np.int8)
    p = ic.pack_weights(w8)
    assert p.shape == (2, 3, 3, 32) and p.dtype == torch.int8 and p.is_contiguous()
    np.testing.assert_array_equal(p[..., :5].numpy(), w8.transpose(3, 0, 1, 2))
    assert not p[..., 5:].any()
    with pytest.raises(ValueError, match="int8"):
        ic.pack_weights(w8.astype(np.float32))


def test_cpu_wrapper_takes_plain_version_without_launching():
    x, w8, deq, bias = _case(2, *CASES[0][:5], 3)
    args = (_codes(x), ic.pack_weights(w8), torch.from_numpy(deq), torch.from_numpy(bias))
    before = dict(ic.LAUNCHES)
    got = ic.int8_conv(*args, cin=8, stride=1, padding=1, act="leaky_relu")
    want = ic.int8_conv_reference(*args, cin=8, stride=1, padding=1, act="leaky_relu")
    assert torch.equal(got, want) and dict(ic.LAUNCHES) == before


@pytest.mark.parametrize(
    "change,err,match",
    [
        (dict(act="gelu"), NotImplementedError, "activation"),
        (dict(stride=3), ValueError, "built for"),
        (dict(padding=0), ValueError, "built for"),
        (dict(cin=40), ValueError, "channels"),
        (dict(q=torch.zeros((1, 4, 4, 8), dtype=torch.int8)), ValueError, "multiple of 32"),
        (dict(q=torch.zeros((1, 4, 4, 32))), ValueError, "int8"),
        (dict(deq=torch.zeros(3)), ValueError, "deq"),
        (dict(bias=torch.zeros(16, dtype=torch.float64)), ValueError, "bias"),
        (dict(out_scale=torch.ones(2)), ValueError, "out_scale"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(change, err, match):
    kw = dict(q=torch.zeros((1, 4, 4, 32), dtype=torch.int8),
              w_packed=torch.zeros((16, 3, 3, 32), dtype=torch.int8),
              deq=torch.ones(16), bias=torch.zeros(16), cin=8, stride=2, padding=1,
              act="leaky_relu", out_scale=None)
    kw.update(change)
    with pytest.raises(err, match=match):
        ic.int8_conv(**kw)


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA GPU (decided when the test
    runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


# the base_model blocks 4-6 at a reduced size, ragged M tiles, odd shapes;
# ConvNeXt-Small's site shapes at a reduced size (C_in and C_out up to
# 3,072, a ragged N tile at C_out 96, the 2x2 stride-2 downsample)
CUDA_CASES = CASES + [
    (4, 97, 129, 128, 128, 3, 1),
    (4, 193, 258, 128, 128, 3, 2),
    (1, 3, 5, 8, 8, 3, 2),
    (2, 17, 33, 384, 384, 3, 1),
    (2, 24, 32, 384, 1536, 1, 1),
    (2, 12, 16, 3072, 768, 1, 1),
    (2, 6, 8, 768, 3072, 1, 1),
    (2, 24, 32, 384, 96, 1, 1),
    (2, 48, 65, 384, 768, 2, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "leaky_relu", "silu"])
@pytest.mark.parametrize("case", CUDA_CASES, ids=lambda c: "x".join(map(str, c)))
def test_cuda_kernel_equals_plain_version(cuda, case, act):
    b, h, w, cin, cout, k, s = case
    pad = (k - 1) // 2
    x, w8, deq, bias = _case(3, b, h, w, cin, cout, k)
    args = tuple(t.cuda() for t in (_codes(x), ic.pack_weights(w8), torch.from_numpy(deq),
                                     torch.from_numpy(bias)))
    kw = dict(cin=cin, stride=s, padding=pad, act=act)
    scale = torch.tensor([0.05], device="cuda")
    for out_scale in (None, scale):
        n = ic.LAUNCHES["int8_conv"]
        got = ic.int8_conv(*args, **kw, out_scale=out_scale)
        torch.cuda.synchronize()
        assert ic.LAUNCHES["int8_conv"] == n + 1
        want = ic.int8_conv_reference(*args, **kw, out_scale=out_scale)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want), f"{case} {act} {out_scale is not None}"
