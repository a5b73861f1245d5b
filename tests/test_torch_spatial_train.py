"""Row-split training (`train --spatial-parallel N`, yogo_tpu_torch/
parallel/spatial.py through make_train_step(rows=) and Trainer) on the CPU,
N handles to "cpu", quarter_filters at 48x64 as tests/test_parallel.py:274.

  - the split step at N = 2 and 4 against the unsplit port step, flips and
    dropout on, one generator: losses rtol 1e-5, parameters after 4 steps
    rtol 1e-4 / atol 1e-6, BN statistics rtol 1e-5;
  - the split step against the JAX package's step jitted on its (data,
    space) mesh get_mesh_2d(4), dropout-free: losses rtol 2e-4 (the JAX
    package's own tolerance between its meshes);
  - remat "blocks" and "full" under the split equal "none", the BN
    statistics folded once; accumulate=2 split equal to unsplit;
  - the input gradient of one split 3x3 s2 layer, halo rows included,
    against the unsplit layer's (rtol 1e-6, of the largest element where a
    halo row sums two shards' parts);
  - two gloo ranks x N = 2 (tests/torch_parallel_worker.py) against one
    unsplit process at rtol 1e-4 (tests/test_torch_ddp.py's), --fsdp at 2e-4;
  - `python -m yogo_tpu_torch train --spatial-parallel 2 --device cpu`,
    its best.ckpt read by the JAX package; the height refusals.

The bias of a conv that feeds a BatchNorm (quarter_filters' conv5) has an
exactly zero gradient, which the split's statistics (flax's fast variance)
and the unsplit's (F.batch_norm) turn into different float noise; AdamW
makes that noise +-lr steps of its sign, so that bias and its BN's running
mean are held to atol 2 * lr a step (tests/test_torch_ddp.py's rule).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.data_fixtures import CLASSES, make_pair_dirs, write_defn
from tests.torch_parallel_worker import load_rank, run_steps, run_workers, step_batches
from yogo_tpu_torch.models import defns
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.parallel import spatial
from yogo_tpu_torch.train import Trainer, TrainState, make_optimizer, make_train_step, step_seed

REPO = Path(__file__).resolve().parent.parent
HW = (48, 64)
LOSS_KW = dict(no_obj_weight=0.5, iou_weight=5.0, classify_weight=1.0, label_smoothing=0.01)
LR = 1e-3
STEPS = 4
ZERO_GRAD = ("conv5.bias", "bn5.running_mean")
CPU = torch.device("cpu")


def batch(b=8, seed=1, model=None):
    """tests/test_parallel.py:274's batch: random frames, one box a frame."""
    sx, sy = model.grid
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (b, 1, *HW)).astype(np.uint8)
    labels = np.zeros((b, 6, sy, sx), np.float32)
    labels[:, :, 2, 3] = [1, 0.4, 0.4, 0.6, 0.6, 1]
    return torch.from_numpy(imgs), torch.from_numpy(labels), torch.ones(b)


def train(model, base, n, *, steps=STEPS, remat="none", augment=True, accumulate=1, data=None):
    """`steps` steps of make_train_step from a copy of `base`, rows split
    over n handles to the CPU (unsplit at n = 1); returns (losses, state
    dict, the stack)."""
    stack = copy.deepcopy(base)
    opt, sched, _ = make_optimizer(stack.parameters(), LR, 5e-2, 10.0, 20)
    state = TrainState(stack, opt, sched)
    rows = spatial.RowSplit(model, [CPU] * n) if n > 1 else None
    step = make_train_step(model, LOSS_KW, augment=augment, remat=remat, accumulate=accumulate, rows=rows)
    data = data or batch(model=model)
    losses = []
    for k in range(steps):
        state, loss, _ = step(state, *data, torch.Generator().manual_seed(step_seed(0, k)))
        losses.append(float(loss))
    return losses, {k: v.detach().clone() for k, v in stack.state_dict().items()}, stack


def assert_states_close(got, want, rtol=1e-4, atol=1e-6, steps=STEPS):
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        if k in ZERO_GRAD:
            torch.testing.assert_close(got[k], w, rtol=0, atol=2 * LR * steps, msg=k)
        elif k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-6, msg=k)
        else:
            torch.testing.assert_close(got[k], w, rtol=rtol, atol=atol, msg=k)


@pytest.fixture(scope="module")
def quarter():
    model = YOGO.create(HW, 0.1, 0.12, len(CLASSES), model_version="quarter_filters")
    base = model.init(torch.Generator().manual_seed(0), device="cpu")
    return model, base, train(model, base, 1)


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("n", [2, 4])
def test_split_step_equals_the_unsplit_step(quarter, n):
    model, base, (losses1, state1, _) = quarter
    assert any(s.dropout > 0 for s in model.defn.blocks)
    losses, state, stack = train(model, base, n)
    np.testing.assert_allclose(losses, losses1, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert_states_close(state, state1)
    # the BN statistics were folded, once a step
    assert not torch.equal(state["bn0.running_var"], base.state_dict()["bn0.running_var"])


@pytest.mark.parametrize("remat", ["blocks", "full"])
def test_remat_under_the_split_equals_none_and_folds_the_statistics_once(quarter, remat):
    model, base, _ = quarter
    _, want, _ = train(model, base, 4, steps=2)
    calls = []
    orig = spatial.RowSplit.stack_layer

    def spy(self, stack, i, parts, batch_stats, update_stats, mask):
        calls.append((i, update_stats))
        return orig(self, stack, i, parts, batch_stats, update_stats, mask)

    spatial.RowSplit.stack_layer = spy
    try:
        _, got, _ = train(model, base, 4, steps=2, remat=remat)
    finally:
        spatial.RowSplit.stack_layer = orig
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-6, atol=1e-7, msg=k)
    # every layer runs twice a step (forward, recomputation), folding once
    n_layers = len(model.defn.blocks)
    assert sorted(calls) == sorted([(i, True) for i in range(n_layers)] * 2
                                   + [(i, False) for i in range(n_layers)] * 2)


def test_accumulate_two_split_equals_unsplit(quarter):
    model, base, _ = quarter
    imgs, labels, mask = batch(b=8, seed=4, model=model)
    mask[6:] = 0.0  # the second micro-batch is half padding
    data = (imgs.view(2, 4, *imgs.shape[1:]), labels.view(2, 4, *labels.shape[1:]), mask.view(2, 4))
    want = train(model, base, 1, steps=2, accumulate=2, data=data)
    got = train(model, base, 2, steps=2, accumulate=2, data=data)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    # the step's accumulated (and clamped) gradient and BN statistics; after
    # the update a parameter whose gradient is zero in exact arithmetic (a
    # channel dropped in every real image of a micro-batch) carries AdamW's
    # amplified float noise, as conv5.bias does
    want = train(model, base, 1, steps=1, accumulate=2, data=data)
    got = train(model, base, 2, steps=1, accumulate=2, data=data)
    for (name, p), q in zip(want[2].named_parameters(), got[2].parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-4, atol=1e-5, msg=name)
    for k, w in want[1].items():
        if k.endswith(("running_mean", "running_var")) and k not in ZERO_GRAD:
            torch.testing.assert_close(got[1][k], w, rtol=1e-5, atol=1e-6, msg=k)


def test_split_layer_input_gradient_equals_unsplit_halo_rows_included(quarter):
    model, base, _ = quarter
    spec = model.defn.blocks[0]
    assert (spec.kernel, spec.stride, spec.padding) == (3, 2, 1)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 1, *HW, generator=g)
    gy = torch.randn(2, spec.out, HW[0] // 2, HW[1] // 2, generator=g)
    x1 = x.clone().requires_grad_(True)
    (base._block(0, x1, False, False, None) * gy).sum().backward()
    for n in (2, 4):
        rows = spatial.RowSplit(model, [CPU] * n)
        xn = x.clone().requires_grad_(True)
        out = rows.gather(rows.stack_layer(base, 0, rows.scatter(xn), False, False, None), 2)
        (out * gy).sum().backward()
        # a halo row's gradient is the sum of two shards' parts: float sums
        # round relative to their terms, so rtol 1e-6 of the largest element
        scale = float(x1.grad.abs().max())
        torch.testing.assert_close(xn.grad, x1.grad, rtol=1e-6, atol=1e-6 * scale)
        # the rows each shard sends to its neighbour (the halo) carry gradient
        for a, _, t in spatial.plan_rows(model.defn.blocks, HW[0], n)[0].windows[1:]:
            assert t == 1 and xn.grad[:, :, a].abs().sum() > 0


def test_split_step_equals_jax_on_the_data_space_mesh():
    """tests/test_parallel.py:274's comparison, dropout-free (the two
    frameworks' dropout masks cannot be equal): the port's split step
    (N = 4) against the JAX step jitted on get_mesh_2d(4), 4 steps."""
    import jax
    import jax.numpy as jnp

    from yogo_tpu.models import defns as jdefns
    from yogo_tpu.models.yogo import YOGO as JYOGO
    from yogo_tpu.parallel.mesh import data_sharded, get_mesh_2d, replicated, shard_batch, space_sharded
    from yogo_tpu.train import TrainState as JTrainState
    from yogo_tpu.train import make_optimizer as jmake_optimizer
    from yogo_tpu.train import make_train_step as jmake_train_step
    from yogo_tpu_torch.utils.weights import state_dict_from_flax

    @contextmanager
    def quarter_nodrop():
        def register(reg):
            def quarter_nodrop(num_classes, rgb_input=False):
                blocks = reg.get_model_defn("quarter_filters")(num_classes, rgb_input).blocks
                return reg.ModelDefn(name="quarter_nodrop",
                                     blocks=tuple(dataclasses.replace(b, dropout=0.0) for b in blocks))
            return reg.temporary_model(quarter_nodrop)

        with register(jdefns), register(defns):
            yield

    with quarter_nodrop():
        jmodel = JYOGO.create(HW, 0.1, 0.12, len(CLASSES), model_version="quarter_nodrop")
        tx, _ = jmake_optimizer(LR, 5e-2, 10.0, 20)
        jstep_fn = jmake_train_step(jmodel, tx, LOSS_KW, augment=False)
        v = jmodel.init(jax.random.key(0))
        mesh = get_mesh_2d(4)
        rep = replicated(mesh)
        jstep = jax.jit(jstep_fn, in_shardings=(rep, space_sharded(mesh), data_sharded(mesh),
                                                data_sharded(mesh, 1), rep),
                        out_shardings=(rep, rep, rep))
        state = JTrainState(params=v["params"], batch_stats=v["batch_stats"],
                            opt_state=tx.init(v["params"]), step=jnp.asarray(0, jnp.int32))
        model = YOGO.create(HW, 0.1, 0.12, len(CLASSES), model_version="quarter_nodrop")
        imgs, labels, mask = batch(model=model)
        theirs = []
        for _ in range(STEPS):
            di, dl, dm = shard_batch(mesh, imgs.numpy(), labels.numpy(), mask.numpy(), spatial_first=True)
            state, loss, _ = jstep(state, di, dl, dm, jax.random.key(7))
            theirs.append(float(loss))
        base = model.module("cpu")
        base.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, v)))
        mine, _, _ = train(model, base, 4, augment=False, data=(imgs, labels, mask))
    assert theirs[-1] < theirs[0]
    np.testing.assert_allclose(mine, theirs, rtol=2e-4)


# ------------------------------------------------------ two ranks x N = 2
CASES = {
    "split2": dict(model="quarter_filters", augment=True, accumulate=1, spatial=2),
    "split2_fsdp": dict(model="quarter_filters", augment=True, accumulate=1, spatial=2, fsdp=True),
}


def test_two_ranks_by_two_row_shards_equal_one_unsplit_process(tmp_path):
    from tests.torch_parallel_worker import HW as WHW
    from tests.torch_parallel_worker import NUM_CLASSES

    model = YOGO.create(WHW, 0.08, 0.1, NUM_CLASSES, model_version="quarter_filters")
    base = model.init(torch.Generator().manual_seed(0), device="cpu")
    np.savez(tmp_path / "init.npz", **{f"quarter_filters/{k}": v.numpy() for k, v in base.state_dict().items()})
    (tmp_path / "cases.json").write_text(json.dumps(CASES))
    run_workers("step", tmp_path, tmp_path / "out", timeout=180)
    ranks = [load_rank(tmp_path / "out", "step", r) for r in range(2)]
    batches = step_batches(grid=model.grid)
    losses, _, sd, _ = run_steps(model, copy.deepcopy(base), batches, augment=True, accumulate=1)
    want = {k: torch.from_numpy(v) for k, v in sd.items()}
    for name, rtol in (("split2", 1e-4), ("split2_fsdp", 2e-4)):
        for r in ranks:
            np.testing.assert_allclose(r[name]["losses"], losses, rtol=rtol)
            got = {k: torch.from_numpy(v) for k, v in r[name]["state"].items()}
            for k, w in want.items():
                if not w.is_floating_point():
                    continue
                atol = 2 * LR * len(batches) if k in ZERO_GRAD else 1e-5
                torch.testing.assert_close(got[k], w, rtol=rtol, atol=atol, msg=f"{name} {k}")


# ----------------------------------------------------------- the CLI
def test_cli_train_spatial_parallel_runs_and_jax_reads_its_checkpoint(tmp_path):
    from yogo_tpu.utils.checkpoint import load_checkpoint as jload

    pairs = [make_pair_dirs(tmp_path, "a", n_images=12, seed=0)]
    defn = write_defn(tmp_path / "d.yml", dataset_pairs=pairs,
                      split={"train": 0.5, "val": 0.25, "test": 0.25})
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "yogo_tpu_torch", "train", str(defn), "--device", "cpu",
         "--spatial-parallel", "2", "--image-hw", "48", "64", "--model", "quarter_filters",
         "--epochs", "1", "--batch-size", "4", "--no-wandb", "--name", "sp"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = tmp_path / "trained_models" / "sp"
    assert json.loads((run / "config.json").read_text())["spatial_parallel"] == 2
    model, variables, meta = jload(run / "best.ckpt")
    assert model.model_version == "quarter_filters" and tuple(model.img_size) == HW
    assert np.isfinite(np.asarray(variables["params"]["conv0"]["kernel"])).all()


def test_heights_that_do_not_split_are_refused(tmp_path):
    pairs = [make_pair_dirs(tmp_path, "a", n_images=4, seed=0)]
    cfg = {"dataset_descriptor_file": str(write_defn(tmp_path / "d.yml", dataset_pairs=pairs)),
           "image_hw": (50, 64), "spatial_parallel": 4}
    with pytest.raises(ValueError, match="not divisible by the spatial axis size 4"):
        Trainer(cfg, device="cpu")
    model = YOGO.create((16, 64), 0.1, 0.12, 3, model_version="quarter_filters")
    with pytest.raises(ValueError, match="fewer than the 4 row shards"):
        spatial.RowSplit(model, [CPU] * 4)
    with pytest.raises(ValueError, match="needs 4 devices, got 2"):
        Trainer(dict(cfg, image_hw=(48, 64)), devices=["cpu", "cpu"])
