"""The port's YOGO forward against the JAX package's YOGO.apply on the CPU,
with the same weights (YOGO.init, carried by state_dict_from_flax) and the
same seeded inputs, at 64x96:
  - float32: raw NHWC head and decoded output at rtol = atol = 1e-4
    (same math, different conv summation order; weights damped 0.7x);
  - bf16 with the fused stem (the port's plain version vs the Pallas kernel
    in interpret mode): the damped weights and tolerances of
    tests/test_pallas_stem.py (bf16 rounding noise through 7 blocks);
  - training semantics (second half of the file): BN batch statistics with
    flax's biased running variance, BN-freeze, channel dropout, init and
    the norms, each with its tolerance stated in the test.
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
# every conv-stack architecture of the registry, for the f32 forward
F32_ARCHS = ["base_model", "silu_model", "double_filters", "triple_filters", "half_filters",
             "quarter_filters", "depth_ver_0", "depth_ver_1", "depth_ver_2", "depth_ver_3",
             "depth_ver_4"]


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
@pytest.mark.parametrize("arch", F32_ARCHS)
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


# ------------------------------------------------------- training semantics
import flax.linen as fnn  # noqa: E402

from yogo_tpu_torch.models.defns import ConvSpec  # noqa: E402
from yogo_tpu_torch.models.yogo import ConvStack, _batch_norm  # noqa: E402
from yogo_tpu_torch.utils.weights import flax_from_state_dict  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_layer_folds_the_biased_variance_like_flax_not_torchs_unbiased(dtype):
    """One BN layer, three batches, flax nn.BatchNorm(momentum=0.9) against
    the port's _batch_norm: outputs at rtol/atol 1e-5 in float32 (1 bf16
    ulp in bf16), running mean and var at rtol 1e-5 in BOTH dtypes - the
    statistics are computed in float32 from bf16 activations. torch's own
    BatchNorm2d folds in the unbiased variance and lands n/(n-1) off."""
    rng = np.random.default_rng(0)
    c, shape = 8, (2, 6, 8)  # n = 96 values a channel: biased/unbiased differ by 1%
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                        dtype=jdt, param_dtype=jnp.float32)
    fvars = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
             "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    bn = torch.nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)
    theirs = torch.nn.BatchNorm2d(c, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        for m in (bn, theirs):
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
    for _ in range(3):
        x = (2.0 * rng.standard_normal((shape[0], c, *shape[1:])) + 1.0).astype(np.float32)
        xt = torch.from_numpy(x).to(tdt)
        x = xt.float().numpy()  # what both see after the cast
        want, upd = fbn.apply(fvars, jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt),
                              mutable=["batch_stats"])
        fvars = {"params": fvars["params"], "batch_stats": upd["batch_stats"]}
        got = _batch_norm(bn, xt, batch_stats=True, update_stats=True)
        theirs(xt.float())
        assert got.dtype == tdt and want.dtype == jdt
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=8e-3, atol=1e-2)
        np.testing.assert_allclose(got.detach().float().numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want.astype(jnp.float32)), **tol)
    assert bn.running_var.dtype == torch.float32
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(fvars["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(fvars["batch_stats"]["var"]), rtol=1e-5)
    rel = np.abs(theirs.running_var.numpy() / bn.running_var.numpy() - 1)
    assert rel.min() > 1e-3  # torch's unbiased update would not pass the line above
    # a recomputation (update_stats=False) normalises the same and leaves the statistics
    before = (bn.running_mean.clone(), bn.running_var.clone())
    again = _batch_norm(bn, xt, batch_stats=True, update_stats=False)
    assert torch.equal(again, got)
    assert torch.equal(bn.running_mean, before[0]) and torch.equal(bn.running_var, before[1])
    assert int(bn.num_batches_tracked) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_and_running_statistics_after_three_steps_match_jax(arch):
    """apply(train=True) on three batches through both packages. The two
    frameworks' dropout masks cannot be made equal, so what is compared
    against flax is what no dropout precedes: block 0's running statistics,
    at rtol 1e-5. (A dropout-free stack is compared whole, statistics and
    parameters, in tests/test_torch_train.py.)"""
    v = _variables(arch, scale=0.7)
    jm = JYOGO.create(HW, 0.08, 0.1, 3, model_version=arch)
    m, stack = _port(arch, v)
    jv = v
    g = torch.Generator().manual_seed(0)
    for seed in range(3):
        x = _images(10 + seed, n=4)
        out, upd = jm.apply(jv, jnp.asarray(x), train=True, mutable=True,
                            rngs={"dropout": jax.random.key(seed)})
        jv = {"params": jv["params"], "batch_stats": upd["batch_stats"]}
        got = m.apply(stack, torch.from_numpy(x), train=True, generator=g)
        assert got.requires_grad and got.shape == tuple(out.shape)
    got_stats = flax_from_state_dict(stack.state_dict())["batch_stats"]
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(got_stats["bn0"][leaf], np.asarray(jv["batch_stats"]["bn0"][leaf]),
                                   rtol=1e-5, atol=1e-6)
    # blocks 4 and 5 sit behind dropout: same statistics up to the masks' noise
    for name in ("bn4", "bn5"):
        assert not np.array_equal(got_stats[name]["var"], np.asarray(v["batch_stats"][name]["var"]))


def test_tuning_freezes_bn_statistics_bit_equal_and_still_builds_a_graph():
    v = _variables("base_model", scale=0.7)
    m, stack = _port("base_model", v)
    before = {k: b.clone() for k, b in stack.named_buffers()}
    x = torch.from_numpy(_images(4))
    g = torch.Generator().manual_seed(0)
    tuned = m.apply(stack, x, train=True, tuning=True, generator=g)
    assert tuned.requires_grad
    for k, b in stack.named_buffers():
        assert torch.equal(b, before[k]), k
    tuned.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in stack.parameters())
    live = m.apply(stack, x, train=True, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(stack.bn0.running_mean, before["bn0.running_mean"])
    assert not np.allclose(live.detach().numpy(), tuned.detach().numpy(), rtol=1e-3)
    # eval: no graph, no update, identity dropout
    after = {k: b.clone() for k, b in stack.named_buffers()}
    ev = m.apply(stack, x)
    assert not ev.requires_grad
    assert all(torch.equal(b, after[k]) for k, b in stack.named_buffers())
    assert torch.equal(ev, m.apply(stack, x, tuning=True))


def test_channel_dropout_drops_whole_channels_and_scales_the_rest():
    """A 1x1 identity conv with dropout 0.4: in training each (sample,
    channel) plane is either all zero or the eval output times 1/(1-p);
    about p of them are dropped; eval is the identity; the same generator
    seed gives the same mask and another seed another."""
    p, c, b = 0.4, 16, 64
    stack = ConvStack((ConvSpec(c, kernel=1, padding=0, bias=False, act=None, dropout=p),),
                      in_channels=c).eval()
    with torch.no_grad():
        stack.conv0.weight.copy_(torch.eye(c).view(c, c, 1, 1))
    x = torch.from_numpy(np.random.default_rng(0).uniform(1, 2, (b, c, 5, 7)).astype(np.float32))
    ev = stack(x).detach()
    np.testing.assert_array_equal(ev.numpy(), x.numpy())
    tr = stack(x, train=True, generator=torch.Generator().manual_seed(3)).detach()
    planes = tr.numpy().reshape(b, c, -1)
    dropped = (planes == 0).all(axis=2)
    kept = ~(planes == 0).any(axis=2)
    assert (dropped | kept).all()  # whole planes, never part of one
    np.testing.assert_allclose(planes[kept], ev.numpy().reshape(b, c, -1)[kept] / (1 - p), rtol=1e-6)
    # 1024 planes, Bernoulli(0.4): within 4 sigma (0.061)
    assert abs(dropped.mean() - p) < 0.061
    assert dropped.any(axis=0).all() and (~dropped).any(axis=0).all()  # per sample, not per batch
    same = stack(x, train=True, generator=torch.Generator().manual_seed(3)).detach()
    other = stack(x, train=True, generator=torch.Generator().manual_seed(4)).detach()
    assert torch.equal(same, tr) and not torch.equal(other, tr)
    # base_model: blocks 1-3 at 0.05 / 0.10 / 0.15 and nowhere else
    rates = [s.dropout for s in YOGO.create(HW, 0.08, 0.1, 3).defn.blocks]
    assert rates == [0, 0.05, 0.10, 0.15, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="remat"):
        stack(x, train=True, remat="some")


def test_init_is_kaiming_fan_out_like_jax_and_seeded():
    m = YOGO.create(HW, 0.08, 0.1, 3)
    stack = m.init(torch.Generator().manual_seed(0), device="cpu")
    jv = jax.tree.map(np.asarray, JYOGO.create(HW, 0.08, 0.1, 3).init(jax.random.key(0)))
    gain = np.sqrt(2.0 / (1.0 + 0.01**2))
    for i, spec in enumerate(m.defn.blocks):
        w = getattr(stack, f"conv{i}").weight.detach().numpy()
        want_std = gain / np.sqrt(spec.out * spec.kernel**2)
        # the sample std of n normal draws is within 4 / sqrt(2n) of 1, relatively
        slack = 4 / np.sqrt(2 * w.size)
        assert abs(w.std() / want_std - 1) < slack, i
        assert abs(jv["params"][f"conv{i}"]["kernel"].std() / want_std - 1) < slack, i
        assert abs(w.mean()) < 4 * want_std / np.sqrt(w.size)
        bias = getattr(stack, f"conv{i}").bias
        assert (bias is None) == (not spec.bias) and (bias is None or not bias.any())
        if spec.bn:
            bn = getattr(stack, f"bn{i}")
            assert (bn.weight == 1).all() and not bn.bias.any()
            assert not bn.running_mean.any() and (bn.running_var == 1).all()
    assert not stack.training
    assert YOGO.num_params(stack) == JYOGO.create(HW, 0.08, 0.1, 3).num_params(jv)
    again = m.init(torch.Generator().manual_seed(0), device="cpu")
    other = m.init(torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(again.conv3.weight, stack.conv3.weight)
    assert not torch.equal(other.conv3.weight, stack.conv3.weight)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.init(torch.Generator().manual_seed(0))


def test_param_and_grad_norm_match_jax():
    v = _variables("half_filters")
    m, stack = _port("half_filters", v)
    np.testing.assert_allclose(YOGO.param_norm(stack.parameters()),
                               JYOGO.param_norm(v["params"]), rtol=1e-6)
    out = m.apply(stack, torch.from_numpy(_images(5)), train=True, tuning=True,
                  generator=torch.Generator().manual_seed(0))
    out.square().mean().backward()
    want = np.sqrt(sum(float(p.grad.double().pow(2).sum()) for p in stack.parameters()))
    np.testing.assert_allclose(YOGO.grad_norm(stack), want, rtol=1e-6)


def test_no_tf32_holds_the_flag_off_while_any_thread_is_inside():
    """The flag is global: a server's dispatch and a reload's calibration
    hold it from two threads at once, and the first to leave must not turn
    TF32 back on under the other (found on the card: `serve --quantize`
    answers changed across a recalibrating reload)."""
    import threading

    from yogo_tpu_torch.models.yogo import no_tf32

    cuda = torch.device("cuda")  # a device object only: nothing runs on it
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    entered, release, seen = threading.Event(), threading.Event(), []

    def other():
        with no_tf32(cuda):
            entered.set()
            release.wait(10)
            seen.append(torch.backends.cudnn.allow_tf32)

    try:
        t = threading.Thread(target=other)
        with no_tf32(cuda):
            t.start()
            assert entered.wait(10)
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False  # the other thread is still inside
        release.set()
        t.join(10)
        assert seen == [False] and torch.backends.cudnn.allow_tf32 is True
        with no_tf32(torch.device("cpu")):
            assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
