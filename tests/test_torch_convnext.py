"""The port's ConvNeXt-Small (yogo_tpu_torch/models/yogo.py ConvNeXtSmall)
against the JAX package's on the CPU, 64x96, with the JAX package's init
carried across by utils/weights.py and then perturbed: every `gamma` drawn
from N(0.5, 0.2) (at its init value of 1e-6 every block is the identity to
within 1e-6 and a wrong block would pass), biases from N(0, 0.1) and norm
scales from U(0.8, 1.2), so that each mapped tensor moves the output.

  - module level, depths (1, 1, 2, 1): float32 raw head at rtol = atol =
    1e-4; bf16 (convs and Dense layers in bf16, LayerNorm and the residual
    stream in f32) at atol 0.03 on a head of magnitude ~1; one train step:
    the gradient of the YOGO loss w.r.t. every parameter and the AdamW
    update (tolerances in the test);
  - the whole model at full depth, B=2: raw head and decoded output at
    rtol = atol = 1e-4;
  - weights: `.ckpt` bytes equal to the JAX package's, timm `.pth` keys
    both ways, the flax-default init.
The entry points (`train` / `test` / `infer --count --quantize` through the
CLI, and `serve`) are in tests/test_torch_quant_convnext.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.data_fixtures import CLASSES
from yogo_tpu.losses import yogo_loss as jax_yogo_loss
from yogo_tpu.models.yogo import ConvNeXtSmall as JConvNeXtSmall
from yogo_tpu.models.yogo import YOGO as JYOGO
from yogo_tpu.train import make_optimizer as jax_make_optimizer
from yogo_tpu.utils import checkpoint as jckpt
from yogo_tpu.utils import torch_bridge as jbridge
from yogo_tpu_torch.infer import Predictor
from yogo_tpu_torch.models.yogo import ConvNeXtSmall, YOGO
from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step
from yogo_tpu_torch.utils import checkpoint as tckpt
from yogo_tpu_torch.utils import torch_bridge as tbridge
from yogo_tpu_torch.utils.weights import (
    flax_from_state_dict,
    named_from_flax_params,
    optax_state_from_torch,
    state_dict_from_flax,
)

HW = (64, 96)
NUM_CLASSES = 4  # 9 outputs: 49,458,306 parameters at full width
SMALL = (1, 1, 2, 1)
KW = dict(no_obj_weight=0.5, iou_weight=5.0, classify_weight=1.0, label_smoothing=0.01)
OPT = dict(learning_rate=1e-3, weight_decay=5e-2, decay_factor=10.0, total_steps=50)


def perturb(tree, rng):
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = perturb(x, rng)
        elif k == "gamma":
            out[k] = rng.normal(0.5, 0.2, x.shape).astype(np.float32)
        elif k == "bias":
            out[k] = rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        else:
            out[k] = np.asarray(x, np.float32)
    return out


@pytest.fixture(scope="module")
def jmodel():
    return JYOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="convnext_small")


@pytest.fixture(scope="module")
def variables(jmodel):
    """JAX's init of the whole model, perturbed (see the module docstring)."""
    v = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    assert list(v) == ["params"]  # no BN: no batch_stats
    return {"params": perturb(v["params"], np.random.default_rng(0))}


@pytest.fixture(scope="module")
def small(variables):
    """The depths (1, 1, 2, 1) trunk: the subset of the whole model's tree
    that JAX's ConvNeXtSmall(depths=SMALL) declares."""
    jm = JConvNeXtSmall(5 + NUM_CLASSES, depths=SMALL)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *HW, 1))))["params"]
    v = {"params": {k: variables["params"][k] for k in shapes}}
    net = ConvNeXtSmall(5 + NUM_CLASSES, 1, depths=SMALL)
    net.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, net


def images(seed, n=2):
    return np.random.default_rng(seed).integers(0, 255, (n, 1, *HW)).astype(np.uint8)


def port(model=None, v=None, dtype=torch.float32):
    m = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="convnext_small", compute_dtype=dtype)
    net = m.module("cpu")
    if v is not None:
        net.load_state_dict(state_dict_from_flax(v), strict=True)
    return m, net


# ---------------------------------------------------------------- the module
def test_module_f32_forward_matches_jax(small):
    jm, v, net = small
    x = images(1).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8, 12, 9) and np.abs(want).max() > 0.3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_module_bf16_forward_matches_jax_and_keeps_the_residual_stream_f32(small):
    """flax's LayerNorm returns f32 from bf16 input: a bf16 block returns
    f32 in both packages, only the head comes back bf16."""
    jm, v, net = small
    x = images(2).astype(np.float32)
    jb = JConvNeXtSmall(5 + NUM_CLASSES, compute_dtype=jnp.bfloat16, depths=SMALL)
    want = jb.apply(v, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).to(torch.bfloat16))
        h = torch.randn(2, 4, 6, 96).float()
        block_out = net.stage0_block0(h, torch.bfloat16)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert block_out.dtype == torch.float32
    jblock = jax.eval_shape(
        lambda: jb.apply(v, jnp.zeros((1, *HW, 1)), capture_intermediates=True,
                         mutable=["intermediates"])[1]["intermediates"]["stage0_block0"])
    assert jblock["__call__"][0].dtype == jnp.float32
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0, atol=0.03)


def test_module_train_step_gradients_and_update_match_jax(small, jmodel):
    """One port train step (make_train_step, no flips) on the module
    against JAX's value_and_grad of the same YOGO loss and the optax
    update of train.make_optimizer: the loss at rtol 1e-5, every gradient
    at rtol 1e-3 / atol 1e-3 of its largest entry, the updated weights at
    rtol 2e-3 / atol 2e-5, or within 2 lr where the gradient is below 1e-3
    of its tensor's largest (Adam turns float32 noise in a small gradient
    into a step of lr = 1e-3 either way)."""
    import copy

    import optax

    jm, v, net = small
    net = copy.deepcopy(net)
    x = images(3)
    sx, sy = jmodel.grid
    labels = np.zeros((2, 6, sy, sx), np.float32)
    labels[:, :, 3, 5] = [1, 0.3, 0.3, 0.5, 0.5, 1]
    labels[1, :, 6, 2] = [1, 0.1, 0.6, 0.3, 0.9, 3]
    mask = np.ones(2, np.float32)

    @jax.jit
    def jloss(params):
        raw = jm.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1), jnp.float32))
        out = jmodel._decode_raw(raw, False)
        return jax_yogo_loss(out, jnp.asarray(labels), image_mask=jnp.asarray(mask), **KW)[0]

    jl, jg = jax.value_and_grad(jloss)(v["params"])
    tx, _ = jax_make_optimizer(**OPT)
    updates, _ = tx.update(jg, tx.init(v["params"]), v["params"])
    jparams = named_from_flax_params(jax.tree.map(np.asarray, optax.apply_updates(v["params"], updates)))

    m, _ = port()
    optimizer, scheduler, _ = make_optimizer(net.parameters(), **OPT)
    state, loss, _ = make_train_step(m, KW, augment=False)(
        TrainState(net, optimizer, scheduler), *(torch.from_numpy(a) for a in (x, labels, mask)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = named_from_flax_params(jax.tree.map(np.asarray, jg))
    got = dict(net.named_parameters())
    assert sorted(got) == sorted(want) == sorted(jparams) and state.step == 1
    lr = OPT["learning_rate"]
    for k, g in want.items():
        # the optimizer clamps the gradient in place to +-clip_value (1.0)
        # before AdamW sees it, as optax.clip does to its input
        g = g.clamp(-1.0, 1.0).numpy()
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(got[k].grad.numpy(), g, rtol=1e-3, atol=1e-3 * scale + 1e-9, err_msg=k)
        # Adam's first step moves a weight by ~lr * g / |g|: where g is
        # float32 noise (below 1e-3 of the tensor's largest) its sign, and so
        # the update, is free, by up to 2 lr
        w, jw = got[k].detach().numpy(), jparams[k].numpy()
        tol = np.where(np.abs(g) < 1e-3 * scale, 2 * lr, 2e-5 + 2e-3 * np.abs(jw))
        assert (np.abs(w - jw) <= tol).all(), (k, float(np.abs(w - jw).max()))


def test_remat_changes_memory_not_values(small):
    """remat="blocks" checkpoints each ConvNeXtBlock, "full" the trunk:
    the same loss and gradients, bit for bit on the CPU."""
    _, _, net = small
    x = torch.from_numpy(images(4).astype(np.float32))
    grads = {}
    for remat in ("none", "blocks", "full"):
        net.zero_grad()
        net(x, remat=remat).square().mean().backward()
        grads[remat] = [p.grad.clone() for p in net.parameters()]
    for remat in ("blocks", "full"):
        assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[remat])), remat
    with pytest.raises(ValueError, match="remat"):
        net(x, remat="everything")
    with pytest.raises(ValueError, match="fused stem"):
        net(x, start_block=1)


# --------------------------------------------------------- the whole model
def test_whole_model_head_and_decoded_output_match_yogo_apply(jmodel, variables):
    x = images(5)
    want_raw = np.asarray(jmodel.apply(variables, jnp.asarray(x), decode=False))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), inference=True))
    m, net = port(v=variables)
    assert m.grid == jmodel.grid == (12, 8)
    assert not m.stem_kernel_eligible(net, torch.from_numpy(x))
    got_raw = m.apply(net, torch.from_numpy(x), decode=False).numpy()
    got = m.apply(net, torch.from_numpy(x), inference=True).numpy()
    assert got_raw.shape == want_raw.shape == (2, 8, 12, 9) and got.shape == (2, 9, 8, 12)
    assert np.abs(want_raw).max() > 1.0
    np.testing.assert_allclose(got_raw, want_raw, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_init_is_flax_s_default_and_seeded(jmodel, variables):
    """lecun_normal kernels (truncated normal, fan-in), zero biases,
    LayerNorm 1 / 0, gamma 1e-6; the parameter count of the JAX model."""
    m = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="convnext_small")
    net = m.init(torch.Generator().manual_seed(0), device="cpu")
    jv = jax.tree.map(np.asarray, jmodel.init(jax.random.key(1)))
    assert YOGO.num_params(net) == jmodel.num_params(jv) == 49_458_306
    jnamed = named_from_flax_params(jv["params"])
    got = net.state_dict()
    assert sorted(got) == sorted(jnamed)
    for k, w in got.items():
        want = jnamed[k]
        if k.endswith("gamma"):
            assert torch.all(w == 1e-6) and torch.equal(w, want), k
        elif k.endswith("bias"):
            assert not w.any() and not want.any(), k
        elif k.endswith("norm.weight"):
            assert torch.all(w == 1) and torch.equal(w, want), k
        else:
            fan_in = w.numel() // (w.shape[1] if k == "format_up.weight" else w.shape[0])
            std = np.sqrt(1.0 / fan_in)
            # the sample std of n draws is within 4 / sqrt(2n) of the truth, relatively
            slack = 4 / np.sqrt(2 * w.numel()) + 0.02
            assert abs(float(w.std()) / std - 1) < slack, k
            assert abs(float(want.std()) / std - 1) < slack, k
            assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6, k
    again = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.stage2_block5.pwconv1.weight, net.stage2_block5.pwconv1.weight)


# ---------------------------------------------------------------- weights
def test_ckpt_bytes_equal_the_jax_package_s_and_load_in_both(tmp_path, jmodel, variables):
    """The same variables and optimizer state (AdamW before its first step)
    written by both packages: the same bytes; each reads the other's."""
    m, net = port(v=variables)
    optimizer, scheduler, _ = make_optimizer(net.parameters(), **OPT)
    tx, _ = jax_make_optimizer(**OPT)
    jvars = {"params": variables["params"], "batch_stats": {}}
    jckpt.save_checkpoint(tmp_path / "j.ckpt", jmodel, jvars, opt_state=tx.init(variables["params"]),
                          epoch=1, step=0, classes=CLASSES, model_name="c")
    tckpt.save_checkpoint(tmp_path / "t.ckpt", m, flax_from_state_dict(net.state_dict()),
                          opt_state=optax_state_from_torch(net, optimizer, scheduler),
                          epoch=1, step=0, classes=CLASSES, model_name="c")
    assert (tmp_path / "t.ckpt").read_bytes() == (tmp_path / "j.ckpt").read_bytes()
    x = images(7)
    want = m.apply(net, torch.from_numpy(x), decode=False)
    pred = Predictor.from_checkpoint(tmp_path / "j.ckpt", device="cpu")
    assert pred.model.model_version == "convnext_small" and isinstance(pred.stack, ConvNeXtSmall)
    assert torch.equal(pred.forward_raw(x), want)
    _, jv2, _ = jckpt.load_checkpoint(tmp_path / "t.ckpt")
    for a, b in zip(jax.tree.leaves(jv2["params"]), jax.tree.leaves(variables["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_pth_keys_both_ways(tmp_path, jmodel, variables):
    """A timm-keyed state_dict gives the same params in both packages; a
    .pth from either package loads in the other with the same head."""
    sd = jbridge.variables_to_state_dict(variables, jmodel)
    assert "model.1.2.blocks.26.mlp.fc2.weight" in sd and "model.format time!.1.weight" in sd
    mine = tbridge.state_dict_to_variables(sd, YOGO.create(HW, 0.08, 0.1, NUM_CLASSES,
                                                           model_version="convnext_small").defn)
    theirs = jbridge.state_dict_to_variables(sd, jmodel.defn)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, b)
    m, net = port(v=variables)
    tsd = tbridge.variables_to_state_dict(variables, m)
    assert sorted(tsd) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(tsd[k], t), k

    x = images(8)
    want = m.apply(net, torch.from_numpy(x), decode=False)
    tbridge.save_pth(tmp_path / "t.pth", m, variables, classes=CLASSES)
    jbridge.save_pth(tmp_path / "j.pth", jmodel, variables, classes=CLASSES)
    _, jv, meta = jbridge.load_pth(tmp_path / "t.pth")
    assert meta["class_names"] == CLASSES
    for a, b in zip(jax.tree.leaves(jv), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for path in (tmp_path / "t.pth", tmp_path / "j.pth"):
        model, _, _ = YOGO.from_pth(path)
        assert model.model_version == "convnext_small"
        assert torch.equal(Predictor.from_checkpoint(path, device="cpu").forward_raw(x), want)
