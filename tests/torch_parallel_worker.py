"""Worker processes of the port's multi-process tests (the counterpart of
tests/multihost_*_worker.py): N processes on the CPU, gloo over a
localhost rendezvous, each one rank of yogo_tpu_torch's data-parallel
paths. Imports nothing of JAX, so a worker starts in seconds; the tests
compare what the workers write with one process of the port and with the
JAX package.

    python tests/torch_parallel_worker.py <mode> <in_dir> <out_dir>

with RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT in the environment
(`run_workers` sets them). Each rank writes <out_dir>/<mode>.<rank>.pkl
(or .npz) and prints "WORKER <mode> <rank> ok" last.

Modes: bn (global BatchNorm), step (make_train_step, replicated and
FSDP, unsplit or with each rank's rows split over N row shards), metrics (DeviceMetrics), trainer (Trainer.train, phases interrupt /
resume / fsdp / replicated), infer (predict(data_parallel=True), float and
int8), raises (what multi-process runs refuse).
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
HW = (96, 128)
NUM_CLASSES = 3
LOSS_KW = dict(no_obj_weight=0.5, iou_weight=5.0, classify_weight=1.0, label_smoothing=0.01)
GROUP_TIMEOUT_S = 60.0


# ------------------------------------------------------------ the parent side
def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(mode: str, in_dir: Path, out_dir: Path, world: int = 2, timeout: float = 240.0,
                extra_env=None):
    """Start `world` ranks of `mode`, wait for all of them, and fail (after
    killing every rank) if one fails or the time runs out. Returns each
    rank's stdout."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(
            os.environ,
            PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
            WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
            OMP_NUM_THREADS="2",
            **(extra_env or {}),
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), mode, str(in_dir), str(out_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{mode} workers timed out after {timeout} s")
            if p.returncode != 0:
                raise AssertionError(f"{mode} rank {rank} failed ({p.returncode}):\n{err[-4000:]}")
            if f"WORKER {mode} {rank} ok" not in out:
                raise AssertionError(f"{mode} rank {rank} did not finish:\n{out[-2000:]}\n{err[-2000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def load_rank(out_dir: Path, mode: str, rank: int):
    with open(Path(out_dir) / f"{mode}.{rank}.pkl", "rb") as f:
        return pickle.load(f)


def nodrop_blocks(spec, num_classes):
    """The dropout-free 4-block architecture of tests/test_torch_train.py
    (BN on blocks 0 and 2)."""
    return (
        spec(8, stride=2, bias=False, bn=True),
        spec(16, stride=2),
        spec(16, stride=2, bias=False, bn=True),
        spec(5 + num_classes, kernel=1, padding=0, act=None),
    )


@contextlib.contextmanager
def port_nodrop():
    """The port's registry holds test_nodrop for the duration."""
    from yogo_tpu_torch.models import defns

    def test_nodrop(num_classes, rgb_input=False):
        return defns.ModelDefn(name="test_nodrop", blocks=nodrop_blocks(defns.ConvSpec, num_classes))

    with defns.temporary_model(test_nodrop):
        yield


def step_batches(seed=7, batch=8, n_steps=2, accumulate=1, grid=None):
    """Global batches of a step test: (imgs, labels, mask) per step, the
    last image of each masked out (one rank holds a pad row); with
    accumulate > 1, (A, B, ...) stacks whose last micro-batch is half
    padding."""
    sx, sy = grid
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        shape = (accumulate, batch) if accumulate > 1 else (batch,)
        imgs = rng.integers(0, 255, (*shape, 1, *HW)).astype(np.uint8)
        labels = np.zeros((*shape, 6, sy, sx), np.float32)
        for c in range(3):
            y, x = rng.integers(0, sy), rng.integers(0, sx)
            cx, cy = (x + 0.5) / sx, (y + 0.5) / sy
            labels[..., :, y, x] = np.array([1, cx - 0.05, cy - 0.05, cx + 0.05, cy + 0.05, c % 3])
        mask = np.ones(shape, np.float32)
        mask[..., -1] = 0.0
        if accumulate > 1:
            mask[-1, batch // 2:] = 0.0
        out.append((imgs, labels, mask))
    return out


def rank_rows(arr, rank, world, accumulate=1):
    """Rank `rank`'s rows of a global batch (axis 1 of an accumulation stack)."""
    axis = 1 if accumulate > 1 else 0
    b = arr.shape[axis] // world
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(rank * b, (rank + 1) * b)
    return arr[tuple(idx)]


def run_steps(model, stack, batches, *, augment, accumulate, fsdp=False, seed=0, spatial=1):
    """Two (or len(batches)) steps of make_train_step on this rank's rows,
    each image's rows over `spatial` row shards on the stack's device when
    spatial > 1; returns (losses, components, full state dict as numpy)."""
    from yogo_tpu_torch.parallel.distributed import process_shard
    from yogo_tpu_torch.parallel.mesh import full_state_dict, fully_shard_stack
    from yogo_tpu_torch.parallel.spatial import RowSplit
    from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step, step_seed

    rank, world = process_shard()
    if fsdp:
        fully_shard_stack(stack)
    opt, sched, _ = make_optimizer(stack.parameters(), 1e-3, 5e-2, 10.0, 50)
    state = TrainState(stack, opt, sched)
    rows = RowSplit(model, [next(stack.parameters()).device] * spatial) if spatial > 1 else None
    step = make_train_step(model, LOSS_KW, augment=augment, accumulate=accumulate, rows=rows)
    losses, comps = [], []
    for k, (imgs, labels, mask) in enumerate(batches):
        args = [torch.from_numpy(np.ascontiguousarray(rank_rows(a, rank, world, accumulate)))
                for a in (imgs, labels, mask)]
        gen = torch.Generator().manual_seed(step_seed(seed, k))
        state, loss, c = step(state, *args, gen)
        losses.append(float(loss))
        comps.append({key: float(v) for key, v in c.items()})
    if fsdp:  # a card's default multi-tensor AdamW cannot mix DTensor and Tensor
        assert opt.defaults["foreach"] is False
    sd = {k: v.cpu().numpy().copy() for k, v in full_state_dict(stack).items()}
    return losses, comps, sd, state


# ------------------------------------------------------------ the worker side
def _dump(out_dir, mode, rank, obj):
    with open(Path(out_dir) / f"{mode}.{rank}.pkl", "wb") as f:
        pickle.dump(obj, f)


def mode_bn(in_dir, out_dir, rank, world):
    from yogo_tpu_torch.models.yogo import _batch_norm
    from yogo_tpu_torch.parallel.mesh import gather_rows, local_rows

    d = np.load(Path(in_dir) / "bn.npz")
    b = d["x"].shape[0] // world
    bn = torch.nn.BatchNorm2d(d["x"].shape[1], eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(d["weight"]))
        bn.bias.copy_(torch.from_numpy(d["bias"]))
        bn.running_mean.copy_(torch.from_numpy(d["running_mean"]))
        bn.running_var.copy_(torch.from_numpy(d["running_var"]))
    x = torch.from_numpy(local_rows(d["x"], b).copy()).requires_grad_(True)
    y = _batch_norm(bn, x, True, True)
    (y * torch.from_numpy(local_rows(d["gy"], b))).sum().backward()
    _dump(out_dir, "bn", rank, {
        "y": y.detach().numpy(), "gx": x.grad.numpy(),
        "gweight": bn.weight.grad.numpy(), "gbias": bn.bias.grad.numpy(),
        "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy(),
        "rows": local_rows(np.arange(d["x"].shape[0]), b),
        "y_gathered": gather_rows(y.detach()).numpy(),
    })


def mode_step(in_dir, out_dir, rank, world):
    from yogo_tpu_torch.models.yogo import YOGO

    cases = json.loads((Path(in_dir) / "cases.json").read_text())
    init = dict(np.load(Path(in_dir) / "init.npz"))
    results = {}
    with port_nodrop():
        for name, case in cases.items():
            model = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version=case["model"])
            stack = model.module("cpu")
            prefix = case["model"] + "/"
            stack.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in init.items()
                                   if k.startswith(prefix)})
            batches = step_batches(accumulate=case["accumulate"], grid=model.grid)
            losses, comps, sd, _ = run_steps(model, stack, batches, augment=case["augment"],
                                            accumulate=case["accumulate"], fsdp=case.get("fsdp", False),
                                            spatial=case.get("spatial", 1))
            results[name] = {"losses": losses, "comps": comps, "state": sd}
    _dump(out_dir, "step", rank, results)


def mode_metrics(in_dir, out_dir, rank, world):
    from yogo_tpu_torch.metrics import DeviceMetrics
    from yogo_tpu_torch.parallel.mesh import local_rows

    d = np.load(Path(in_dir) / "metrics.npz")
    m = DeviceMetrics(classes=["healthy", "ring", "misc"], include_background=False, device="cpu")
    for preds, labels, mask in zip(d["preds"], d["labels"], d["mask"]):
        b = preds.shape[0] // world
        m.update(local_rows(preds, b), local_rows(labels, b), image_mask=local_rows(mask, b))
    _dump(out_dir, "metrics", rank, {"first": m.compute(), "again": m.compute()})


def mode_trainer(in_dir, out_dir, rank, world):
    from yogo_tpu_torch.parallel.mesh import full_state_dict
    from yogo_tpu_torch.train import Trainer

    spec = json.loads((Path(in_dir) / "trainer.json").read_text())
    phase = spec["phase"]
    cfg = {
        "learning_rate": 1e-3, "decay_factor": 10.0, "weight_decay": 5e-2,
        "label_smoothing": 0.01, "iou_weight": 5.0, "no_obj_weight": 0.5,
        "classify_weight": 1.0, "epochs": spec.get("epochs", 4), "batch_size": 2,
        "anchor_w": 0.1, "anchor_h": 0.15, "model": "quarter_filters",
        "half": False, "rgb": False, "image_hw": (40, 56),
        "pretrained_path": spec.get("pretrained"), "normalize_images": False,
        "dataset_split_override": None, "dataset_descriptor_file": spec["defn"],
        "name": f"t_{phase}", "note": None, "tags": None,
        "wandb_entity": None, "wandb_project": None, "use_wandb": False,
        "model_save_dir": spec["run_dir"], "resume": phase == "resume",
        "fsdp": spec.get("fsdp", False), "fast_eval": True,
    }
    t = Trainer(cfg, device="cpu")
    t.init()
    if phase == "interrupt" and rank == 1:
        # a real SIGTERM to this rank only, after it joined the epoch-1
        # latest.ckpt gather (rank 0 writes the file, and never sees a signal)
        orig = t.checkpoint

        def hook(path, model_name, **kw):
            orig(path, model_name, **kw)
            if Path(path).name == "latest.ckpt" and t.epoch == 1:
                os.kill(os.getpid(), signal.SIGTERM)

        t.checkpoint = hook
    result = t.train()
    sd = {k: v.cpu().numpy() for k, v in full_state_dict(t.state.stack).items()}
    norm = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                             for k, v in sd.items() if v.dtype.kind == "f")))
    _dump(out_dir, f"trainer_{phase}", rank, {
        "result": None if result is None else result[:11], "epoch": t.epoch,
        "start_epoch": t._start_epoch, "norm": norm, "state": sd,
        "fsdp_sharded": sorted(k for k, p in t.state.stack.named_parameters()
                               if type(p).__name__ == "DTensor"),
    })


def mode_infer(in_dir, out_dir, rank, world):
    import yogo_tpu_torch.infer as infer

    spec = json.loads((Path(in_dir) / "infer.json").read_text())
    common = dict(path_to_images=spec["img_dir"], count_predictions=True, data_parallel=True,
                  batch_size=2, obj_thresh=0.5, device="cpu")
    print("COUNT", flush=True)
    infer.predict(spec["ckpt"], **common)
    print("HOST", flush=True)
    infer.predict(spec["ckpt"], output_dir=spec["out_dir"], save_preds=True, save_npy=True,
                  **common)
    # int8: rank 0 calibrates, the payload is broadcast; the spy records
    # the program each rank runs
    programs = []
    orig = infer.quant_program_of_rank0

    def spy(*a, **k):
        qp = orig(*a, **k)
        programs.append(qp["scales"].cpu().numpy().copy())
        return qp

    infer.quant_program_of_rank0 = spy
    print("INT8", flush=True)
    infer.predict(spec["ckpt_q"], quantize=True, **common)
    infer.quant_program_of_rank0 = orig
    # each rank splits its images' rows over its own 2 devices
    print("SPATIAL", flush=True)
    infer.predict(spec["ckpt"], spatial_parallel=2, **common)
    _dump(out_dir, "infer", rank, {"scales": programs})


def mode_raises(in_dir, out_dir, rank, world):
    import yogo_tpu_torch.infer as infer
    from yogo_tpu_torch.serve import build_server

    spec = json.loads((Path(in_dir) / "infer.json").read_text())
    caught = {}
    for name, fn in (
        ("spatial_only", lambda: infer.predict(spec["ckpt"], path_to_images=spec["img_dir"],
                                               spatial_parallel=2, device="cpu")),
        ("full_predictions", lambda: infer.predict(spec["ckpt"], path_to_images=spec["img_dir"],
                                                   data_parallel=True, return_full_predictions=True,
                                                   device="cpu")),
        ("serve", lambda: build_server(spec["ckpt"], port=0, data_parallel=True, device="cpu")),
    ):
        try:
            fn()
            caught[name] = None
        except (ValueError, NotImplementedError) as e:
            caught[name] = f"{type(e).__name__}: {e}"
    _dump(out_dir, "raises", rank, caught)


MODES = {"bn": mode_bn, "step": mode_step, "metrics": mode_metrics, "trainer": mode_trainer,
         "infer": mode_infer, "raises": mode_raises}


def main() -> None:
    mode, in_dir, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
    torch.set_num_threads(2)
    from yogo_tpu_torch.parallel.distributed import initialize_multihost, process_shard

    assert initialize_multihost(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    import torch.distributed as dist

    rank, world = process_shard()
    try:
        MODES[mode](in_dir, out_dir, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"WORKER {mode} {rank} ok", flush=True)


if __name__ == "__main__":
    main()
