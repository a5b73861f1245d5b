"""Data-parallel training in the port at world 2 (two gloo ranks on the
CPU, tests/torch_parallel_worker.py), against one process of the port on
the global batch and against the JAX package's step jitted over a 2-device
mesh: the train step (a masked pad row on one rank; accumulate 1 and 2;
flips and dropout on; --fsdp), the fast-eval DeviceMetrics, and the
Trainer (rank-0 writes, a SIGTERM to one rank, --resume, --fsdp, a
checkpoint the JAX package reads).

Tolerances: losses rtol 1e-4 (JAX's own gate between a multi-process run
and one process, tests/test_multihost.py:164), 2e-4 under --fsdp
(:288); parameters after two steps rtol 1e-4, atol 1e-5. The bias of a
conv that feeds a BatchNorm has an exactly zero gradient; AdamW turns its
float noise into +-lr steps whose sign is the noise's, so it (and the
running mean of its BN) is compared to atol 4 * lr there: two steps of up
to lr each, of either sign."""

from __future__ import annotations

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.data_fixtures import make_pair_dirs, write_defn
from tests.test_device_metrics import CLASSES as MCLASSES
from tests.test_device_metrics import make_scene
from tests.test_torch_metrics import assert_results_equal
from tests.torch_parallel_worker import (
    HW,
    LOSS_KW,
    NUM_CLASSES,
    load_rank,
    nodrop_blocks,
    port_nodrop,
    run_steps,
    run_workers,
    step_batches,
)
from yogo_tpu.metrics import DeviceMetrics as JDeviceMetrics
from yogo_tpu.models import defns as jdefns
from yogo_tpu.models.yogo import YOGO as JYOGO
from yogo_tpu.parallel.mesh import data_sharded, get_mesh, replicated, shard_batch
from yogo_tpu.train import TrainState as JTrainState
from yogo_tpu.train import make_optimizer as jax_make_optimizer
from yogo_tpu.train import make_train_step as jax_make_train_step
from yogo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from yogo_tpu_torch.metrics import DeviceMetrics
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.utils.checkpoint import load_checkpoint
from yogo_tpu_torch.utils.msgpack_lite import unpackb
from yogo_tpu_torch.utils.weights import flax_from_state_dict

CASES = {
    "acc1": dict(model="test_nodrop", augment=False, accumulate=1),
    "acc2": dict(model="test_nodrop", augment=False, accumulate=2),
    "augment": dict(model="quarter_filters", augment=True, accumulate=1),
    "fsdp": dict(model="quarter_filters", augment=True, accumulate=1, fsdp=True),
}
LR = 1e-3
# a conv bias feeding a BatchNorm (quarter_filters' block 5) and that BN's
# running mean: zero-gradient parameters, see the module docstring
ZERO_GRAD = ("conv5.bias", "bn5.running_mean")


@contextlib.contextmanager
def both_nodrop():
    def test_nodrop(num_classes, rgb_input=False):
        return jdefns.ModelDefn(name="test_nodrop", blocks=nodrop_blocks(jdefns.ConvSpec, num_classes))

    with jdefns.temporary_model(test_nodrop), port_nodrop():
        yield


def init_states():
    """Seeded weights of both architectures, keyed '<model>/<name>'."""
    out = {}
    with port_nodrop():
        for name in ("test_nodrop", "quarter_filters"):
            m = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version=name)
            stack = m.init(torch.Generator().manual_seed(0), device="cpu")
            out.update({f"{name}/{k}": v.numpy() for k, v in stack.state_dict().items()})
    return out


def fresh_stack(case, init):
    model = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version=case["model"])
    stack = model.module("cpu")
    prefix = case["model"] + "/"
    stack.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in init.items()
                           if k.startswith(prefix)})
    return model, stack


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("step")
    init = init_states()
    np.savez(d / "init.npz", **init)
    (d / "cases.json").write_text(json.dumps(CASES))
    run_workers("step", d, d / "out", timeout=180)
    ranks = [load_rank(d / "out", "step", r) for r in range(2)]
    world1 = {}
    with port_nodrop():
        for name, case in CASES.items():
            if case.get("fsdp"):
                continue
            model, stack = fresh_stack(case, init)
            batches = step_batches(accumulate=case["accumulate"], grid=model.grid)
            losses, comps, sd, _ = run_steps(model, stack, batches, augment=case["augment"],
                                            accumulate=case["accumulate"])
            world1[name] = {"losses": losses, "comps": comps, "state": sd}
    return init, ranks, world1


def assert_states_close(got, want, rtol, atol, zero_grad_atol=None):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w.dtype.kind != "f":
            continue
        tol = zero_grad_atol if (zero_grad_atol and k in ZERO_GRAD) else atol
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", ["acc1", "acc2", "augment"])
def test_step_at_world_two_equals_world_one(step_run, name):
    _, ranks, world1 = step_run
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], world1[name]["losses"], rtol=1e-4)
        for got, want in zip(r[name]["comps"], world1[name]["comps"]):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
        assert_states_close(r[name]["state"], world1[name]["state"], 1e-4, 1e-5, 4 * LR)
    # replicated state is bit-equal on the ranks
    for k, v in ranks[0][name]["state"].items():
        np.testing.assert_array_equal(v, ranks[1][name]["state"][k], err_msg=k)


def test_fsdp_step_equals_the_replicated_step(step_run):
    _, ranks, _ = step_run
    for r in ranks:
        np.testing.assert_allclose(r["fsdp"]["losses"], ranks[0]["augment"]["losses"], rtol=2e-4)
        assert_states_close(r["fsdp"]["state"], ranks[0]["augment"]["state"], 2e-4, 1e-5, 4 * LR)


@pytest.mark.parametrize("name", ["acc1", "acc2"])
def test_step_at_world_two_equals_jax_on_a_two_device_mesh(step_run, name):
    init, ranks, _ = step_run
    case = CASES[name]
    acc = case["accumulate"]
    with both_nodrop():
        jmodel = JYOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version=case["model"])
        model, stack = fresh_stack(case, init)
        variables = flax_from_state_dict(stack.state_dict())
        tx, _ = jax_make_optimizer(LR, 5e-2, 10.0, 50)
        state = JTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]), step=jnp.asarray(0, jnp.int32))
        mesh = get_mesh(jax.devices()[:2])
        rep = replicated(mesh)
        ax = 1 if acc > 1 else 0
        shd = [data_sharded(mesh, nd, batch_axis=ax) for nd in (4 + ax, 4 + ax, 1 + ax)]
        jstep = jax.jit(jax_make_train_step(jmodel, tx, LOSS_KW, augment=False, accumulate=acc),
                        in_shardings=(rep, *shd, rep), out_shardings=(rep, rep, rep))
        losses = []
        for imgs, labels, mask in step_batches(accumulate=acc, grid=model.grid):
            args = shard_batch(mesh, imgs, labels, mask, batch_axis=ax)
            state, loss, _ = jstep(state, *args, jax.random.key(0))
            losses.append(float(loss))
    np.testing.assert_allclose(ranks[0][name]["losses"], losses, rtol=1e-4)
    got = flax_from_state_dict({k: torch.from_numpy(v) for k, v in ranks[0][name]["state"].items()})
    want = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for path, w in flat_want.items():
        np.testing.assert_allclose(flat_got[path], w, rtol=1e-4, atol=1e-5, err_msg=str(path))


# ------------------------------------------------------------------ metrics
@pytest.fixture(scope="module")
def metrics_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("metrics")
    rng = np.random.default_rng(3)
    scores = iter(rng.permutation(np.arange(2100, 4090)))
    preds, labels = [], []
    for _ in range(2):
        scenes = [make_scene(rng, score_iter=scores) for _ in range(4)]
        preds.append(np.stack([p for p, _ in scenes]))
        labels.append(np.stack([lab for _, lab in scenes]))
    mask = np.ones((2, 4), np.float32)
    mask[1, 3] = 0.0  # rank 1's last row of the second batch is padding
    inputs = dict(preds=np.stack(preds), labels=np.stack(labels), mask=mask)
    np.savez(d / "metrics.npz", **inputs)
    run_workers("metrics", d, d / "out", timeout=120)
    return inputs, [load_rank(d / "out", "metrics", r) for r in range(2)]


def test_fast_eval_metrics_at_world_two_equal_world_one_and_jax(metrics_run):
    """Every rank scores its rows; compute() sums the state over the ranks,
    so each rank reports the global batch's metrics, as the JAX package's
    SPMD update over a sharded batch does, and a second compute() does not
    count twice."""
    inputs, ranks = metrics_run
    one = DeviceMetrics(classes=MCLASSES, include_background=False, device="cpu")
    jax_m = JDeviceMetrics(classes=MCLASSES, include_background=False)
    for preds, labels, mask in zip(inputs["preds"], inputs["labels"], inputs["mask"]):
        one.update(preds, labels, image_mask=mask)
        jax_m.update(preds, labels, image_mask=mask)
    want = one.compute()
    assert int(want[9][0]) > 0
    for r in ranks:
        assert_results_equal(r["first"], want)
        assert_results_equal(r["again"], want)
    assert_results_equal(want, jax_m.compute())


# ------------------------------------------------------------------ Trainer
@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The JAX package's multihost_train_worker case in the port: phase
    "interrupt" SIGTERMs rank 1 alone after its epoch-1 latest.ckpt gather,
    phase "resume" continues from that file (epochs 2-3), phase "fsdp"
    trains epochs 0-3 with --fsdp from scratch, phase "fsdp_resume" is
    "resume" with --fsdp (the whole AdamW moments of the file sharded)."""
    d = tmp_path_factory.mktemp("trainer")
    pairs = [make_pair_dirs(d, str(i), n_images=6, seed=i) for i in range(2)]
    defn = write_defn(d / "defn.yml", dataset_pairs=pairs,
                      split={"train": 0.5, "val": 0.25, "test": 0.25})
    out = {}
    for phase, extra in (("interrupt", {}),
                         ("resume", {"pretrained": str(d / "run_interrupt" / "latest.ckpt")}),
                         ("fsdp", {"fsdp": True}),
                         ("fsdp_resume", {"fsdp": True,
                                          "pretrained": str(d / "run_interrupt" / "latest.ckpt")})):
        spec = {"phase": phase.replace("fsdp_", ""), "defn": str(defn),
                "run_dir": str(d / f"run_{phase}"), **extra}
        (d / "trainer.json").write_text(json.dumps(spec))
        run_workers("trainer", d, d / "out", timeout=240)
        out[phase] = [load_rank(d / "out", f"trainer_{spec['phase']}", r) for r in range(2)]
    return d, out


def _records(run_dir):
    return [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_a_sigterm_to_one_rank_stops_both_at_the_same_epoch_and_resume_completes(trainer_runs):
    d, out = trainer_runs
    for r in out["interrupt"]:
        assert r["result"] is None and r["epoch"] == 1
    assert out["interrupt"][0]["norm"] == out["interrupt"][1]["norm"]
    _, _, meta = load_checkpoint(d / "run_interrupt" / "latest.ckpt")
    assert meta["next_epoch"] == 2 and meta["min_val_loss"] is not None
    for r in out["resume"]:
        assert r["result"] is not None and r["start_epoch"] == 2
        assert np.isfinite(r["result"][0])
    assert out["resume"][0]["norm"] == out["resume"][1]["norm"]
    # both ranks' test passes score the global test batch alike (fast eval)
    np.testing.assert_array_equal(out["resume"][0]["result"][2], out["resume"][1]["result"][2])
    _, _, meta = load_checkpoint(d / "run_resume" / "latest.ckpt")
    assert meta["next_epoch"] == 4


def test_rank_zero_alone_writes_the_run_directory(trainer_runs):
    d, _ = trainer_runs
    run = d / "run_interrupt"
    recs = [r for r in _records(run) if "train loss" in r]
    # 6 train images over 2 ranks at batch 2: 2 steps an epoch, 2 epochs,
    # each step logged once (a second writer would double them)
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert (run / "config.json").exists()
    assert not list(run.glob("*.tmp.*"))


def test_the_jax_package_reads_the_best_checkpoint(trainer_runs):
    d, _ = trainer_runs
    # written by the epoch-0 validation of each run from scratch
    for phase in ("interrupt", "fsdp"):
        jmodel, variables, meta = jax_load_checkpoint(d / f"run_{phase}" / "best.ckpt")
        init = jmodel.init(jax.random.key(0))
        assert (jax.tree.structure(variables["params"]) == jax.tree.structure(init["params"]))
        x = jnp.asarray(np.full((1, 1, 40, 56), 128, np.uint8))
        assert np.isfinite(np.asarray(jmodel.apply(variables, x, inference=True))).all()


def test_fsdp_trainer_equals_the_replicated_one_and_writes_the_same_layout(trainer_runs):
    d, out = trainer_runs
    assert out["fsdp"][0]["fsdp_sharded"], "no parameter was sharded"
    for r in out["fsdp"]:
        assert r["result"] is not None
    # the replicated run is the interrupted one and its exact resume
    got = [r["train loss"] for r in _records(d / "run_fsdp") if "train loss" in r]
    want = [r["train loss"] for phase in ("interrupt", "resume")
            for r in _records(d / f"run_{phase}") if "train loss" in r]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=2e-4)
    _, v_f, m_f = load_checkpoint(d / "run_fsdp" / "latest.ckpt")
    _, v_r, m_r = load_checkpoint(d / "run_resume" / "latest.ckpt")
    flat_f = dict(jax.tree_util.tree_leaves_with_path(v_f))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(v_r))
    assert sorted(map(str, flat_f)) == sorted(map(str, flat_r))
    for path, w in flat_r.items():
        assert np.asarray(flat_f[path]).shape == np.asarray(w).shape, path
    opt_f, opt_r = unpackb(m_f["_opt_state_bytes"]), unpackb(m_r["_opt_state_bytes"])
    shapes = [jax.tree.map(lambda a: np.asarray(a).shape, o) for o in (opt_f, opt_r)]
    assert shapes[0] == shapes[1]
    assert m_f["step"] == m_r["step"] == 8
    for path, w in flat_r.items():
        key = str(path)
        atol = 8 * LR if ("conv5" in key and "bias" in key) or "bn5" in key else 1e-4
        np.testing.assert_allclose(flat_f[path], w, rtol=2e-4, atol=atol, err_msg=key)


def test_an_fsdp_resume_shards_the_saved_moments_and_equals_the_replicated_resume(trainer_runs):
    d, out = trainer_runs
    for r in out["fsdp_resume"]:
        assert r["result"] is not None and r["start_epoch"] == 2 and r["fsdp_sharded"]
    got = [r["train loss"] for r in _records(d / "run_fsdp_resume") if "train loss" in r]
    want = [r["train loss"] for r in _records(d / "run_resume") if "train loss" in r]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=2e-4)
