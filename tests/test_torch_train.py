"""The port's training step against the JAX package's on the CPU, float32,
96x128: the optimizer recipe on given gradients, a 5-step trajectory from
carried weights, gradient accumulation, activation recomputation, the
BN-freeze path and the eval step. Tolerances are stated at each test."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yogo_tpu.models import defns as jdefns
from yogo_tpu.models.yogo import YOGO as JYOGO
from yogo_tpu.train import TrainState as JTrainState
from yogo_tpu.train import make_eval_step as jax_make_eval_step
from yogo_tpu.train import make_optimizer as jax_make_optimizer
from yogo_tpu.train import make_train_step as jax_make_train_step
from yogo_tpu_torch.models import defns
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.train import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from yogo_tpu_torch.utils.weights import flax_from_state_dict, state_dict_from_flax

HW = (96, 128)
NUM_CLASSES = 3
KW = dict(no_obj_weight=0.5, iou_weight=5.0, classify_weight=1.0, label_smoothing=0.01)
OPT = dict(learning_rate=1e-3, weight_decay=5e-2, decay_factor=10.0, total_steps=50)


@contextlib.contextmanager
def nodrop_models():
    """A dropout-free 4-block architecture (BN on blocks 0 and 2),
    registered in both packages for the duration: dropout masks cannot be
    made equal across the two frameworks' generators."""

    def blocks(spec, num_classes):
        return (
            spec(8, stride=2, bias=False, bn=True),
            spec(16, stride=2),
            spec(16, stride=2, bias=False, bn=True),
            spec(5 + num_classes, kernel=1, padding=0, act=None),
        )

    def test_nodrop(num_classes, rgb_input=False):
        return jdefns.ModelDefn(name="test_nodrop", blocks=blocks(jdefns.ConvSpec, num_classes))

    jax_defn = test_nodrop

    def test_nodrop(num_classes, rgb_input=False):  # noqa: F811 - same name, the port's registry
        return defns.ModelDefn(name="test_nodrop", blocks=blocks(defns.ConvSpec, num_classes))

    with jdefns.temporary_model(jax_defn), defns.temporary_model(test_nodrop):
        yield (
            JYOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="test_nodrop"),
            YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="test_nodrop"),
        )


def fake_batch(grid, b=4, n_obj=3, seed=0):
    """uint8 images, a label grid with n_obj boxes an image, a full mask."""
    rng = np.random.default_rng(seed)
    sx, sy = grid
    imgs = rng.integers(0, 255, (b, 1, *HW)).astype(np.uint8)
    labels = np.zeros((b, 6, sy, sx), np.float32)
    for i in range(b):
        for _ in range(n_obj):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            bw, bh = rng.uniform(0.1, 0.2, 2)
            ii, jj = int((2 * cx) * sx // 2), int((2 * cy) * sy // 2)
            labels[i, :, jj, ii] = [1, cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2,
                                    rng.integers(0, NUM_CLASSES)]
    return imgs, labels, np.ones(b, np.float32)


def jax_state(jmodel, tx, seed=0):
    v = jmodel.init(jax.random.key(seed))
    return JTrainState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                       opt_state=tx.init(v["params"]), step=jnp.asarray(0, jnp.int32))


def port_state(model, jstate, **opt):
    """The port's TrainState holding the JAX state's weights."""
    variables = jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    stack = model.module("cpu")
    stack.load_state_dict(state_dict_from_flax(variables), strict=True)
    optimizer, scheduler, _ = make_optimizer(stack.parameters(), **{**OPT, **opt})
    return TrainState(stack, optimizer, scheduler)


def fresh_port_state(model, seed=0, **opt):
    stack = model.init(torch.Generator().manual_seed(seed), device="cpu")
    optimizer, scheduler, _ = make_optimizer(stack.parameters(), **{**OPT, **opt})
    return TrainState(stack, optimizer, scheduler)


def tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def assert_variables_close(stack, jstate, rtol, atol):
    got = flax_from_state_dict(stack.state_dict())
    want = jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for path, w in flat_want.items():
        np.testing.assert_allclose(flat_got[path], w, rtol=rtol, atol=atol, err_msg=str(path))


# ------------------------------------------------------------------ optimizer
def test_optimizer_matches_optax_chain_on_given_gradients():
    """Clamp -> AdamW -> per-step cosine on the same 12 gradients, some
    beyond the clamp: parameters agree at rtol 2e-5 / atol 2e-7 (the pairing
    tests/test_optimizer_parity.py states for the JAX side)."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(0, 0.5, (4, 7)).astype(np.float32)
    grads = [rng.normal(0, 1.5, w0.shape).astype(np.float32) for _ in range(12)]
    opt = dict(learning_rate=3e-4, weight_decay=5e-2, decay_factor=10.0, total_steps=20)

    tx, _ = jax_make_optimizer(**opt)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)

    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    optimizer, scheduler, _ = make_optimizer([w], **opt)
    for g in grads:
        w.grad = torch.from_numpy(g.copy())
        optimizer.step()
        scheduler.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=2e-5, atol=2e-7)

    # without the clamp the result differs: the clamp is in front of AdamW
    w2 = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    unclamped, sched2, _ = make_optimizer([w2], **opt, clip_value=1e9)
    for g in grads:
        w2.grad = torch.from_numpy(g.copy())
        unclamped.step()
        sched2.step()
    assert not np.allclose(w2.detach().numpy(), w.detach().numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("total", [0, 1, 20])
def test_schedule_closed_form_equals_jax_and_the_scheduler_and_stays_flat(total):
    lr, decay = 3e-4, 10.0
    _, jax_host = jax_make_optimizer(lr, 5e-2, decay, total)
    w = torch.nn.Parameter(torch.zeros(1))
    optimizer, scheduler, host = make_optimizer([w], lr, 5e-2, decay, total)
    for step in range(total + 6):
        assert host(step) == jax_host(step)
        # relative 1e-12: LambdaLR multiplies the base rate by host/lr
        np.testing.assert_allclose(optimizer.param_groups[0]["lr"], host(step), rtol=1e-12)
        np.testing.assert_allclose(scheduler.get_last_lr()[0], host(step), rtol=1e-12)
        w.grad = torch.ones(1)
        optimizer.step()
        scheduler.step()
    assert host(0) == lr
    np.testing.assert_allclose(host(max(total, 1)), lr / decay, rtol=1e-12)
    assert host(max(total, 1) + 100) == host(max(total, 1))


def test_weight_decay_reaches_every_parameter_bn_scales_and_biases_too():
    """With zero gradients only the decoupled decay acts: every parameter,
    whatever its kind, shrinks by (1 - lr * wd) a step, as under optax.adamw
    with no mask."""
    with nodrop_models() as (jmodel, model):
        state = fresh_port_state(model, learning_rate=1e-2, weight_decay=0.1)
        with torch.no_grad():
            for p in state.stack.parameters():
                p.add_(0.5)  # no zeros: biases start at 0
        before = {k: p.detach().clone() for k, p in state.stack.named_parameters()}
        assert any("bn" in k for k in before) and any(k.endswith("bias") for k in before)
        for p in state.stack.parameters():
            p.grad = torch.zeros_like(p)
        state.optimizer.step()
        for k, p in state.stack.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), (before[k] * (1 - 1e-2 * 0.1)).numpy(), rtol=1e-6, err_msg=k
            )

        tx, _ = jax_make_optimizer(1e-2, 0.1, 10.0, 50)
        jparams = flax_from_state_dict({k: v for k, v in before.items()})["params"]
        updates, _ = tx.update(jax.tree.map(jnp.zeros_like, jparams), tx.init(jparams), jparams)
        want = optax.apply_updates(jparams, updates)
        got = flax_from_state_dict(state.stack.state_dict())["params"]
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)


# ----------------------------------------------------------------- train step
def test_five_step_f32_trajectory_matches_jax():
    """Five steps from the same weights on the same batch, no dropout, no
    flips: each loss and its components at rtol 1e-4; after the fifth step
    parameters at rtol 2e-3 / atol 2e-5 (Adam turns float32 noise in a
    small gradient into a visible fraction of lr = 1e-3 a step) and BN
    running statistics at rtol 1e-4 / atol 1e-6."""
    with nodrop_models() as (jmodel, model):
        tx, _ = jax_make_optimizer(**OPT)
        jstate = jax_state(jmodel, tx)
        state = port_state(model, jstate)
        imgs, labels, mask = fake_batch(model.grid)
        jstep = jax.jit(jax_make_train_step(jmodel, tx, KW, augment=False))
        step = make_train_step(model, KW, augment=False)
        losses = []
        for i in range(5):
            jstate, jloss, jcomps = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labels),
                                          jnp.asarray(mask), jax.random.key(0))
            state, loss, comps = step(state, *tensors(imgs, labels, mask))
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, err_msg=f"step {i}")
            for k in jcomps:
                np.testing.assert_allclose(float(comps[k]), float(jcomps[k]), rtol=1e-4,
                                           err_msg=f"step {i} {k}")
            losses.append(float(loss))
        assert state.step == int(jstate.step) == 5
        assert losses[-1] < losses[0]
        got = flax_from_state_dict(state.stack.state_dict())
        for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-3, atol=2e-5)
        for a, b in zip(jax.tree.leaves(got["batch_stats"]), jax.tree.leaves(jstate.batch_stats)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def test_tuning_step_matches_jax_and_leaves_bn_statistics_bit_equal():
    """BN-freeze: three steps train everything but the running statistics,
    which stay bit-equal; loss against JAX at rtol 1e-4."""
    with nodrop_models() as (jmodel, model):
        tx, _ = jax_make_optimizer(**OPT)
        jstate = jax_state(jmodel, tx)
        rng = np.random.default_rng(1)
        jstate = jstate.replace(batch_stats=jax.tree.map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
            jstate.batch_stats))
        state = port_state(model, jstate)
        stats0 = {k: b.clone() for k, b in state.stack.named_buffers()}
        params0 = {k: p.detach().clone() for k, p in state.stack.named_parameters()}
        imgs, labels, mask = fake_batch(model.grid, seed=1)
        jstep = jax.jit(jax_make_train_step(jmodel, tx, KW, augment=False, tuning=True))
        step = make_train_step(model, KW, augment=False, tuning=True)
        for i in range(3):
            jstate, jloss, _ = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labels),
                                     jnp.asarray(mask), jax.random.key(0))
            state, loss, _ = step(state, *tensors(imgs, labels, mask))
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4, err_msg=f"step {i}")
        for k, b in state.stack.named_buffers():
            assert torch.equal(b, stats0[k]), k
        for k, p in state.stack.named_parameters():
            assert not torch.equal(p.detach(), params0[k]), k


def test_accumulate_two_equals_the_big_batch_under_frozen_bn():
    """accumulate=2 over stacked micro-batches gives the big batch's loss,
    components and update for a ragged mask too (rtol 1e-5 on the loss and
    parameters): count-weighted sums divided by the total real count."""
    with nodrop_models() as (_, model):
        imgs, labels, _ = fake_batch(model.grid, b=8, seed=3)
        mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
        big = fresh_port_state(model)
        acc = fresh_port_state(model)
        _, loss_big, comps_big = make_train_step(model, KW, augment=False, tuning=True)(
            big, *tensors(imgs, labels, mask))
        stacked = [a.reshape(2, 4, *a.shape[1:]) for a in (imgs, labels, mask)]
        _, loss_acc, comps_acc = make_train_step(
            model, KW, augment=False, tuning=True, accumulate=2)(acc, *tensors(*stacked))
        np.testing.assert_allclose(float(loss_acc), float(loss_big), rtol=1e-5)
        for k in comps_big:
            np.testing.assert_allclose(float(comps_acc[k]), float(comps_big[k]), rtol=1e-5, atol=1e-8)
        for (k, a), (_, b) in zip(acc.stack.named_parameters(), big.stack.named_parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert acc.step == big.step == 1
        assert acc.scheduler.last_epoch == 1  # one optimizer step, one tick


def test_accumulate_live_bn_matches_jax_scan():
    """With live BN each micro-batch normalises with its own statistics and
    folds them in turn; one step against the JAX package's lax.scan over
    micro-batches: loss at rtol 1e-4, running statistics at rtol 1e-4."""
    with nodrop_models() as (jmodel, model):
        tx, _ = jax_make_optimizer(**OPT)
        jstate = jax_state(jmodel, tx)
        state = port_state(model, jstate)
        imgs, labels, mask = fake_batch(model.grid, b=8, seed=4)
        mask[6:] = 0
        stacked = [a.reshape(2, 4, *a.shape[1:]) for a in (imgs, labels, mask)]
        jstep = jax.jit(jax_make_train_step(jmodel, tx, KW, augment=False, accumulate=2))
        jstate, jloss, _ = jstep(jstate, *map(jnp.asarray, stacked), jax.random.key(0))
        state, loss, _ = make_train_step(model, KW, augment=False, accumulate=2)(
            state, *tensors(*stacked))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        got = flax_from_state_dict(state.stack.state_dict())
        for a, b in zip(jax.tree.leaves(got["batch_stats"]), jax.tree.leaves(jstate.batch_stats)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def test_an_all_padding_micro_batch_leaves_bn_statistics_alone():
    """The second micro-batch is all padding: zero loss weight, and the
    running statistics are exactly those after the first micro-batch."""
    with nodrop_models() as (_, model):
        imgs, labels, mask = fake_batch(model.grid, b=8, seed=5)
        mask[4:] = 0
        two = fresh_port_state(model)
        one = fresh_port_state(model)
        stacked = [a.reshape(2, 4, *a.shape[1:]) for a in (imgs, labels, mask)]
        _, loss_two, _ = make_train_step(model, KW, augment=False, accumulate=2)(
            two, *tensors(*stacked))
        _, loss_one, _ = make_train_step(model, KW, augment=False)(
            one, *tensors(imgs[:4], labels[:4], mask[:4]))
        np.testing.assert_allclose(float(loss_two), float(loss_one), rtol=1e-6)
        moved = False
        for (k, a), (_, b) in zip(two.stack.named_buffers(), one.stack.named_buffers()):
            assert torch.equal(a, b), k
            moved |= "running_mean" in k and bool(a.abs().sum() > 0)
        assert moved
        for a, b in zip(two.stack.parameters(), one.stack.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("remat", ["blocks", "full"])
def test_remat_equals_none_with_dropout_and_flips_on(remat):
    """Recomputation changes when activations are computed, never the
    math: with the same generator seed (dropout on quarter_filters' blocks
    1-3, flips on) two steps give the same loss, parameters and BN
    statistics (rtol 1e-6) - the masks are replayed and the statistics are
    folded in once."""
    model = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="quarter_filters")
    imgs, labels, mask = fake_batch(model.grid, seed=6)
    results = []
    for mode in ("none", remat):
        state = fresh_port_state(model)
        step = make_train_step(model, KW, remat=mode)
        g = torch.Generator().manual_seed(7)
        losses = [float(step(state, *tensors(imgs, labels, mask), g)[1]) for _ in range(2)]
        results.append((losses, state.stack.state_dict()))
    (l0, sd0), (l1, sd1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for k in sd0:
        np.testing.assert_allclose(sd1[k].numpy(), sd0[k].numpy(), rtol=1e-6, atol=1e-8, err_msg=k)
    assert float(sd0["bn0.running_mean"].abs().sum()) > 0


def test_dropout_and_flips_draw_from_the_generator():
    model = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="quarter_filters")
    imgs, labels, mask = fake_batch(model.grid, seed=7)
    step = make_train_step(model, KW)

    def first_loss(seed):
        return float(step(fresh_port_state(model), *tensors(imgs, labels, mask),
                          torch.Generator().manual_seed(seed))[1])

    assert first_loss(0) == first_loss(0)
    assert len({first_loss(s) for s in range(4)}) > 1


def test_bf16_step_keeps_float32_parameters_and_descends():
    model = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="quarter_filters",
                        compute_dtype=torch.bfloat16)
    state = fresh_port_state(model)
    imgs, labels, mask = fake_batch(model.grid, seed=8)
    step = make_train_step(model, KW, augment=False)
    g = torch.Generator().manual_seed(0)
    losses = [float(step(state, *tensors(imgs, labels, mask), g)[1]) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in state.stack.parameters())
    assert all(b.dtype == torch.float32 for k, b in state.stack.named_buffers() if "running" in k)


def test_argument_checks():
    model = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="quarter_filters")
    with pytest.raises(ValueError, match="remat"):
        make_train_step(model, KW, remat="everything")
    with pytest.raises(ValueError, match="accumulate"):
        make_train_step(model, KW, accumulate=0)
    # ConvNeXt's int8 program is the eval step's too
    from yogo_tpu_torch.ops.quant_convnext import quantize_convnext

    cn = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="convnext_small")
    net = cn.init(torch.Generator().manual_seed(0), device="cpu")
    cimgs, clabels, cmask = fake_batch(cn.grid, b=2)
    qp = quantize_convnext(cn, net, [cimgs], device="cpu")
    loss, preds = make_eval_step(cn, KW, quant_params=qp)(None, *tensors(cimgs, clabels, cmask))
    assert np.isfinite(float(loss)) and preds.shape == (2, 5 + NUM_CLASSES, cn.Sy, cn.Sx)
    imgs, labels, mask = fake_batch(model.grid)
    with pytest.raises(ValueError, match="stacked micro-batches"):
        make_train_step(model, KW, accumulate=2)(fresh_port_state(model), *tensors(imgs, labels, mask))


# ------------------------------------------------------------------ eval step
def test_int8_eval_step_matches_jax():
    """make_eval_step(quant_params=) with JAX's int8 program carried over
    (quant_params_from_jax): the loss of the inference=False decode at rtol
    2e-3 and the softmaxed predictions but w / h at atol 1e-2 (int8 codes flip where
    f32 summation-order noise straddles a rounding boundary; base_model at
    96x128, blocks 4-6 int8, damped head)."""
    from yogo_tpu.ops import quant as jq
    from yogo_tpu_torch.utils.weights import quant_params_from_jax

    jmodel = JYOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="base_model")
    model = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="base_model")
    v = jax.tree.map(np.asarray, jmodel.init(jax.random.key(3)))
    v["params"]["conv7"] = jax.tree.map(lambda a: 0.05 * a, v["params"]["conv7"])
    imgs, labels, mask = fake_batch(model.grid, seed=9)
    qj = jq.quantize_conv_stack(jmodel, v, [imgs], skip_blocks=jq.default_skip_blocks(jmodel.defn, 1))
    qp = quant_params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                                            else np.asarray(a), qj))
    jloss, jpreds = jax_make_eval_step(jmodel, KW, quant_params=qj)(
        None, None, jnp.asarray(imgs), jnp.asarray(labels), jnp.asarray(mask))
    loss, preds = make_eval_step(model, KW, quant_params=qp)(None, *tensors(imgs, labels, mask))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)
    # centres, objectness and classes; w / h of an untrained head pass an
    # exp() that amplifies int8 noise without bound
    keep = [0, 1, 4, *range(5, 5 + NUM_CLASSES)]
    np.testing.assert_allclose(preds.numpy()[:, keep], np.asarray(jpreds)[:, keep], rtol=0, atol=1e-2)


def test_eval_step_matches_jax_with_and_without_padding():
    """Loss at rtol 1e-4, softmaxed predictions at rtol/atol 1e-4; the
    stack is left as it was (no statistics update, no graph)."""
    with nodrop_models() as (jmodel, model):
        tx, _ = jax_make_optimizer(**OPT)
        jstate = jax_state(jmodel, tx)
        state = port_state(model, jstate)
        sd0 = {k: v.clone() for k, v in state.stack.state_dict().items()}
        imgs, labels, mask = fake_batch(model.grid, seed=9)
        jeval = jax_make_eval_step(jmodel, KW)
        evaluate = make_eval_step(model, KW)
        for m in (mask, np.array([1, 0, 1, 0], np.float32)):
            jloss, jpreds = jeval(jstate.params, jstate.batch_stats, jnp.asarray(imgs),
                                  jnp.asarray(labels), jnp.asarray(m))
            loss, preds = evaluate(state.stack, *tensors(imgs, labels, m))
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
            np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(preds[:, 5:].sum(dim=1).numpy(), 1.0, rtol=1e-5)
            assert not loss.requires_grad and not preds.requires_grad
        for k, v in state.stack.state_dict().items():
            assert torch.equal(v, sd0[k]), k
