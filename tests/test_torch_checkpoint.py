"""The port's checkpoint reader (msgpack_lite + load_checkpoint) returns
exactly what the JAX package's flax-based reader returns on every committed
checkpoint, and its weights load into the torch ConvStack strictly. The way
back: the writer's files are byte-equal to the JAX package's, weights and
optimizer state carry both ways, and a run saved by either package resumes
in the other with the same next step."""

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


# ------------------------------------------------ the way back: writer, carry
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from tests.test_torch_train import (  # noqa: E402
    KW, OPT, fake_batch, jax_state, nodrop_models, port_state, tensors,
)
from yogo_tpu.train import make_optimizer as jax_make_optimizer  # noqa: E402
from yogo_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from yogo_tpu.utils.checkpoint import restore_opt_state as jax_restore_opt_state  # noqa: E402
from yogo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step  # noqa: E402
from yogo_tpu_torch.utils.checkpoint import restore_opt_state, save_checkpoint  # noqa: E402
from yogo_tpu_torch.utils.weights import (  # noqa: E402
    flax_from_state_dict, load_optax_state, optax_state_from_torch,
)


def test_packb_is_byte_equal_to_msgpack_and_flax():
    rng = np.random.default_rng(0)
    plain = {
        "s": "x" * 40, "short": "abc", "long": "y" * 70000, "n": None, "t": True, "f": False,
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40, -1, -32,
                 -33, -128, -129, -32768, -32769, -2**31 - 1, -2**40],
        "floats": [0.5, -1e300],
        "bin": bytes(rng.integers(0, 256, 300, dtype=np.uint8)), "bin0": b"",
        "nested": {str(i): list(range(i)) for i in range(20)},
        "big_list": list(range(70000)), "tuple": (1, "a"),
    }
    assert msgpack_lite.packb(plain) == msgpack.packb(plain, use_bin_type=True)
    arrays = {
        "a": rng.standard_normal((3, 4, 5)).astype(np.float32), "count": np.asarray(7, np.int32),
        "empty": np.zeros((0,), np.float32), "u8": np.arange(5, dtype=np.uint8),
        "four": np.zeros(1, np.float32),  # small payloads take the fixext / ext8 forms
        "big": np.zeros(70000, np.float32),
    }
    arrays = dict(sorted(arrays.items()))  # flax writes dict keys sorted
    raw = msgpack_lite.packb(arrays)
    assert raw == serialization.msgpack_serialize(arrays)
    back = msgpack_lite.unpackb(raw)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape
        np.testing.assert_array_equal(back[k], a)
    scalar = msgpack_lite.unpackb(msgpack_lite.packb({"s": np.float32(2.5)}))["s"]
    assert scalar.shape == () and scalar == 2.5
    for bad in (object(), {1, 2}, np.array([object()]), 2**64, -2**63 - 1):
        with pytest.raises(msgpack_lite.MsgpackError):
            msgpack_lite.packb(bad)


@pytest.mark.parametrize("name", CKPTS)
def test_flax_from_state_dict_inverts_state_dict_from_flax(name):
    model, variables, _ = load_checkpoint(GOLDENS / name)
    stack = model.module("cpu")
    stack.load_state_dict(state_dict_from_flax(variables), strict=True)
    back = flax_from_state_dict(stack.state_dict())
    got, want = _flatten(back), _flatten(variables)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == np.float32 and got[key].flags.c_contiguous, key
        assert got[key].tobytes() == np.asarray(w).tobytes(), key


def test_port_checkpoint_is_read_by_the_jax_package_and_resumes_there(tmp_path):
    """The port trains two steps and saves; the file is byte-equal to what
    the JAX package's save_checkpoint writes for the same trees; the JAX
    package loads it, restores the optimizer state and takes the third
    step: same loss (rtol 1e-4) and parameters (rtol 1e-3 / atol 1e-5) as
    the port's own third step."""
    with nodrop_models() as (jmodel, model):
        tx, _ = jax_make_optimizer(**OPT)
        jstate = jax_state(jmodel, tx)
        state = port_state(model, jstate)
        imgs, labels, mask = fake_batch(model.grid)
        step = make_train_step(model, KW, augment=False)
        for _ in range(2):
            step(state, *tensors(imgs, labels, mask))
        variables = flax_from_state_dict(state.stack.state_dict())
        opt_tree = optax_state_from_torch(state.stack, state.optimizer, state.scheduler)
        path = tmp_path / "run" / "port.ckpt"
        save_checkpoint(path, model, variables, opt_state=opt_tree, epoch=1, step=state.step,
                        classes=["a", "b", "c"], model_name="port-run", note="extra")
        assert [p.name for p in path.parent.iterdir()] == ["port.ckpt"]  # no tmp left

        jm2, jv2, meta = jax_load_checkpoint(path)
        assert meta["format"] == "yogo_tpu.ckpt.v1" and meta["step"] == 2 and meta["epoch"] == 1
        assert meta["classes"] == ["a", "b", "c"] and meta["model_name"] == "port-run"
        assert meta["note"] == "extra" and meta["model_version"] == "test_nodrop"
        assert jm2 == jmodel
        for key, w in _flatten(variables).items():
            assert np.asarray(_flatten(jv2)[key]).tobytes() == w.tobytes(), key
        opt_state = jax_restore_opt_state(meta, tx.init(jv2["params"]))
        assert int(opt_state[1][0].count) == 2 and int(opt_state[1][2].count) == 2

        jax_path = tmp_path / "jax.ckpt"
        jax_save_checkpoint(jax_path, jmodel, jv2, opt_state=opt_state, epoch=1, step=2,
                            classes=["a", "b", "c"], model_name="port-run", note="extra")
        assert jax_path.read_bytes() == path.read_bytes()

        from yogo_tpu.train import TrainState as JTrainState

        resumed = JTrainState(params=jv2["params"], batch_stats=jv2["batch_stats"],
                              opt_state=opt_state, step=jnp.asarray(2, jnp.int32))
        jstep = jax.jit(jax_make_train_step(jmodel, tx, KW, augment=False))
        resumed, jloss, _ = jstep(resumed, jnp.asarray(imgs), jnp.asarray(labels),
                                  jnp.asarray(mask), jax.random.key(0))
        _, loss, _ = step(state, *tensors(imgs, labels, mask))
        np.testing.assert_allclose(float(jloss), float(loss), rtol=1e-4)
        got = flax_from_state_dict(state.stack.state_dict())["params"]
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(resumed.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-5)


def test_jax_checkpoint_with_optimizer_state_resumes_in_the_port(tmp_path):
    """The JAX package trains two steps and saves with its optax state; the
    port loads the file, restores AdamW's moments, both step counts and
    the learning rate, and takes the same third step (loss rtol 1e-4,
    parameters rtol 1e-3 / atol 1e-5). Without the optimizer state the
    third step is visibly another."""
    with nodrop_models() as (jmodel, model):
        tx, jax_host = jax_make_optimizer(**OPT)
        jstate = jax_state(jmodel, tx)
        imgs, labels, mask = fake_batch(model.grid, seed=2)
        jstep = jax.jit(jax_make_train_step(jmodel, tx, KW, augment=False))
        jargs = (jnp.asarray(imgs), jnp.asarray(labels), jnp.asarray(mask), jax.random.key(0))
        for _ in range(2):
            jstate, _, _ = jstep(jstate, *jargs)
        path = tmp_path / "jax.ckpt"
        jax_save_checkpoint(path, jmodel, {"params": jstate.params, "batch_stats": jstate.batch_stats},
                            opt_state=jstate.opt_state, epoch=0, step=2)
        jstate, jloss, _ = jstep(jstate, *jargs)

        def resume(with_opt_state):
            m, variables, meta = load_checkpoint(path)
            assert m == model and meta["step"] == 2
            stack = m.module("cpu")
            stack.load_state_dict(state_dict_from_flax(variables), strict=True)
            optimizer, scheduler, host = make_optimizer(stack.parameters(), **OPT)
            if with_opt_state:
                assert restore_opt_state(meta, stack, optimizer, scheduler)
                assert scheduler.last_epoch == 2
                assert optimizer.param_groups[0]["lr"] == pytest.approx(jax_host(2), rel=1e-12)
                assert all(float(s["step"]) == 2 for s in optimizer.state.values())
            state = TrainState(stack, optimizer, scheduler, step=meta["step"])
            _, loss, _ = make_train_step(m, KW, augment=False)(state, *tensors(imgs, labels, mask))
            return state, float(loss)

        state, loss = resume(True)
        assert state.step == 3 and state.scheduler.last_epoch == 3
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
        got = flax_from_state_dict(state.stack.state_dict())["params"]
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-5)
        cold, _ = resume(False)
        cold_params = flax_from_state_dict(cold.stack.state_dict())["params"]
        assert not all(
            np.allclose(a, np.asarray(b), rtol=1e-3, atol=1e-5)
            for a, b in zip(jax.tree.leaves(cold_params), jax.tree.leaves(jstate.params))
        )
        meta_without = {"step": 2}
        assert not restore_opt_state(meta_without, state.stack, state.optimizer, state.scheduler)


def test_optimizer_state_tree_round_trip_and_mismatch():
    with nodrop_models() as (jmodel, model):
        tx, _ = jax_make_optimizer(**OPT)
        state = port_state(model, jax_state(jmodel, tx))
        fresh = optax_state_from_torch(state.stack, state.optimizer, state.scheduler)
        want = serialization.to_state_dict(tx.init(flax_from_state_dict(state.stack.state_dict())["params"]))
        assert sorted(_flatten(fresh)) == sorted(_flatten(jax.tree.map(np.asarray, want)))
        assert int(fresh["1"]["0"]["count"]) == 0 and fresh["1"]["0"]["count"].dtype == np.int32
        imgs, labels, mask = fake_batch(model.grid)
        step = make_train_step(model, KW, augment=False)
        for _ in range(3):
            step(state, *tensors(imgs, labels, mask))
        tree = optax_state_from_torch(state.stack, state.optimizer, state.scheduler)
        assert int(tree["1"]["0"]["count"]) == 3 and int(tree["1"]["2"]["count"]) == 3
        assert tree["1"]["0"]["mu"]["conv1"]["kernel"].shape == (3, 3, 8, 16)  # HWIO

        other = port_state(model, jax_state(jmodel, tx, seed=1))
        load_optax_state(tree, other.stack, other.optimizer, other.scheduler)
        again = optax_state_from_torch(other.stack, other.optimizer, other.scheduler)
        for key, w in _flatten(tree).items():
            assert _flatten(again)[key].tobytes() == w.tobytes(), key
        assert other.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]

        del tree["1"]["0"]["mu"]["conv1"]
        with pytest.raises(ValueError, match="optimizer state has parameters"):
            load_optax_state(tree, other.stack, other.optimizer, other.scheduler)
