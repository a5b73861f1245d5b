"""Training orchestration (port of yogo_tpu/train.py): train state,
optimizer recipe, train step and eval step, the `Trainer` (epoch loop,
validation, best / latest checkpoints, SIGTERM stop and exact resume,
post-train test) and `do_training`, the entry of the `train` subcommand.
One process drives one device. Under torchrun (a process group of N > 1
ranks, parallel/distributed.py) each rank trains on its loader shard and
the step is the global batch's: BatchNorm statistics over every rank's
rows, the loss divided by the global real-image count, the gradients
summed over the ranks before the clamp; rank 0 writes the run directory.
`--fsdp` shards the large parameters and their AdamW moments over the
ranks (FSDP2, parallel/mesh.py). `--spatial-parallel N` splits each
image's rows over N devices of the rank (parallel/spatial.py) in the
training steps and validation; the final test pass runs unsplit, as in
the JAX package.

Recipe (reference: yogo/train.py:206-223,295-342): AdamW(lr 3e-4, wd 5e-2)
with decoupled weight decay on every parameter, a cosine schedule stepped
per optimizer step from lr to lr/decay_factor, and an elementwise gradient
clamp to +-clip_value before the optimizer sees the gradients.

Where the JAX step is a pure function of an immutable state, this one
mutates: the module holds parameters and BN statistics, the AdamW its
moments, and `step` returns the same TrainState it was given. Randomness
comes from an explicit torch.Generator that advances with every draw; the
Trainer reseeds it from (seed, step) before every step, as JAX folds the
step number into a key, so a resumed run draws what the uninterrupted run
drew.
"""

from __future__ import annotations

import math
import signal
import sys
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from yogo_tpu_torch.data.definition import DatasetDefinition
from yogo_tpu_torch.data.loader import DataLoader, get_dataloader
from yogo_tpu_torch.data.prefetch import prefetch_to_device
from yogo_tpu_torch.data.transforms import random_flips
from yogo_tpu_torch.losses import yogo_loss
from yogo_tpu_torch.metrics import DeviceMetrics, Metrics
from yogo_tpu_torch.models.yogo import REMAT_MODES, YOGO, no_tf32, resolve_device
from yogo_tpu_torch.ops.quant import (
    family_quant_forward,
    family_quant_plan,
    quant_program_of_rank0,
)
from yogo_tpu_torch.parallel.distributed import (
    all_reduce_grads,
    all_reduce_max,
    all_reduce_sum,
    barrier,
    local_device,
    process_shard,
)
from yogo_tpu_torch.parallel.mesh import (
    device_grid,
    full_state_dict,
    fully_shard_stack,
    validate_spatial_height,
)
from yogo_tpu_torch.parallel.spatial import RowSplit
from yogo_tpu_torch.utils.checkpoint import load_any, restore_opt_state, save_checkpoint
from yogo_tpu_torch.utils.default_hyperparams import DefaultHyperparams as df
from yogo_tpu_torch.utils.logging import RunLogger
from yogo_tpu_torch.utils.tracing import span
from yogo_tpu_torch.utils.weights import (
    flax_from_state_dict,
    optax_state_from_torch,
    state_dict_from_flax,
)

COMPONENTS = ("iou_loss", "objectness_loss", "classification_loss")


@dataclass
class TrainState:
    stack: torch.nn.Module  # the architecture's module (YOGO.module)
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


class ClampedAdamW(torch.optim.AdamW):
    """AdamW that first clamps every gradient elementwise to +-clip_value
    (the reference clamps in per-parameter backward hooks,
    yogo/model.py:75-77; here, as in optax.chain(clip, adamw), the clamp
    sees the whole step's gradient, after any accumulation)."""

    def __init__(self, params, clip_value: float, **kwargs):
        params = list(params)
        if len({isinstance(p, DTensor) for p in params}) > 1:
            # --fsdp: sharded (DTensor) and replicated parameters cannot
            # share one multi-tensor kernel, the default on a card
            kwargs.setdefault("foreach", False)
        super().__init__(params, **kwargs)
        self.clip_value = float(clip_value)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.clamp_(-self.clip_value, self.clip_value)
        return super().step(closure)


def make_optimizer(
    params,
    learning_rate: float,
    weight_decay: float,
    decay_factor: float,
    total_steps: int,
    clip_value: float = 1.0,
) -> Tuple[ClampedAdamW, torch.optim.lr_scheduler.LambdaLR, Callable[[int], float]]:
    """(optimizer, scheduler, host_schedule) over `params` (e.g.
    stack.parameters()). Weight decay is decoupled and applies to every
    parameter, BN scales and biases included, as optax.adamw without a
    mask. Call scheduler.step() once per optimizer step; host_schedule(step)
    is the closed form of the learning rate it sets: cosine from
    learning_rate to learning_rate/decay_factor over max(total_steps, 1)
    steps, flat after."""
    decay_steps = max(total_steps, 1)
    alpha = 1.0 / decay_factor

    def host_schedule(step: int) -> float:
        t = min(max(float(step), 0.0), float(decay_steps))
        frac = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return learning_rate * ((1.0 - alpha) * frac + alpha)

    optimizer = ClampedAdamW(
        params, clip_value, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay,
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: host_schedule(step) / learning_rate
    )
    return optimizer, scheduler, host_schedule


def _bn_buffers(stack: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The BN running statistics of a module (none for a model without BN)."""
    return {k: b for k, b in stack.named_buffers() if k.endswith(("running_mean", "running_var"))}


def make_train_step(
    model: YOGO,
    loss_kwargs: Dict[str, float],
    augment: bool = True,
    tuning: bool = False,
    remat: str = "none",
    accumulate: int = 1,
    rows: Optional[RowSplit] = None,
) -> Callable:
    """Build the train step: (state, imgs, labels, img_mask, generator) ->
    (state, loss, components); loss and components are detached scalars on
    the device. imgs (B, C, H, W) uint8 or float, labels (B, 6, Sy, Sx),
    img_mask (B,) 0/1 for padded batches. Paired flips (augment) run on the
    device inside the step; `generator` (a CPU or device generator, or None
    for the global ones) decides the flips and the dropout masks.

    tuning=True is the fine-tune BN-freeze path: BatchNorm normalises with
    the loaded running statistics and never updates them (reference:
    yogo/model.py:67-70,134).

    remat selects activation recomputation in the backward pass:
      "none"   - store all activations (default),
      "blocks" - store only each block's input; conv/BN/activation
                 intermediates are recomputed,
      "full"   - store only the stack's input and recompute the forward.

    accumulate > 1 takes micro-batch stacks (A, b, ...) and runs them one
    after another before ONE optimizer update. Gradients, loss and
    components are weighted by each micro-batch's real-image count, so the
    result is exactly the big batch's for any padding pattern (under frozen
    BN; with live BN each micro-batch normalises with its own statistics).
    A micro-batch that is all padding leaves the BN statistics alone. The
    cosine schedule ticks once per optimizer step.

    In a process group of N > 1 ranks each rank passes its own rows (the
    same count on every rank) and the step is the global batch's, as the
    JAX step jitted over a batch-sharded mesh: one all_reduce gives each
    micro-batch's global real-image count, which divides every rank's loss;
    BatchNorm normalises with the global statistics (models/yogo.py); the
    gradients are summed over the ranks in one bucket before the clamp;
    the dropout masks are rows of the global batch's draw (flips are one
    coin a batch, equal on every rank); the loss returned is the global
    batch's on every rank. At world 1 nothing of this runs.

    rows (a parallel/spatial.RowSplit over `model`, its first device the
    stack's) splits each image's rows over the split's devices: the batch
    arrives on the first, flips run on the whole batch before the scatter,
    the stack's own weights serve every shard (the gradients sum on it),
    BN takes its statistics over every shard's rows (and every rank's),
    the dropout masks are drawn once and applied on every shard, and the
    head's rows are gathered for the loss. "blocks" checkpoints one layer
    over its shards, "full" the whole split forward.

    Under a profiler (utils/tracing.py) a call is the span "step", and its
    phases the spans "step/forward" (flips, forward, loss) and
    "step/backward", once a micro-batch, and "step/optimizer" (the clamp,
    AdamW and the schedule), each with its device's stream time."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be none|blocks|full, got {remat!r}")
    if accumulate < 1:
        raise ValueError(f"accumulate must be >= 1, got {accumulate}")

    def forward(stack, imgs, labels, img_mask, generator, n_images, batch_rows):
        with span("step/forward", imgs.device):
            x = imgs.to(model.compute_dtype)
            if augment:
                x, labels = random_flips(generator, x, labels)
            out = model.apply(
                stack, x, train=True, tuning=tuning, generator=generator, remat=remat,
                batch_rows=batch_rows, split=rows,
            )
            return yogo_loss(out, labels, image_mask=img_mask, n_images=n_images, **loss_kwargs)

    def backward(loss, device):
        with span("step/backward", device):
            loss.backward()

    def step(state: TrainState, imgs, labels, img_mask, generator=None):
        with span("step"):
            return _step(state, imgs, labels, img_mask, generator)

    def _step(state: TrainState, imgs, labels, img_mask, generator):
        stack = state.stack
        state.optimizer.zero_grad(set_to_none=True)
        rank, world = process_shard()
        counts = rows = None
        if world > 1:
            # the global real-image count of each micro-batch, one collective
            counts = all_reduce_sum(img_mask.float().sum(-1))
            b = imgs.shape[-4]
            rows = (rank * b, world * b)
        # float32 means float32 in the backward convs too
        with no_tf32(imgs.device):
            if accumulate == 1:
                loss, comps = forward(stack, imgs, labels, img_mask, generator, counts, rows)
                backward(loss, imgs.device)
            else:
                if imgs.shape[0] != accumulate:
                    raise ValueError(
                        f"expected {accumulate} stacked micro-batches, got {imgs.shape[0]}"
                    )
                stats = {} if tuning else _bn_buffers(stack)
                lsum = wsum = 0.0
                csum = dict.fromkeys(COMPONENTS, 0.0)
                for j, (mi, ml, mm) in enumerate(zip(imgs, labels, img_mask)):
                    before = {k: b.clone() for k, b in stats.items()}
                    n_j = None if counts is None else counts[j]
                    loss, comps = forward(stack, mi, ml, mm, generator, n_j, rows)
                    # loss and gradient came back divided by max(count, 1):
                    # count * value recovers the sums (zero for all padding)
                    w = mm.float().sum() if n_j is None else n_j
                    backward(w * loss, imgs.device)
                    lsum = lsum + w * loss.detach()
                    csum = {k: csum[k] + w * comps[k].detach() for k in COMPONENTS}
                    wsum = wsum + w
                    for k, b in stats.items():
                        b.copy_(torch.where(w > 0, b, before[k]))
                denom = torch.clamp(wsum, min=1.0)
                for p in stack.parameters():
                    if p.grad is not None:
                        p.grad.div_(denom)
                loss = lsum / denom
                comps = {k: v / denom for k, v in csum.items()}
            if world > 1:
                all_reduce_grads(list(stack.parameters()))
                # every rank returns the global batch's loss, as every JAX process does
                total = all_reduce_sum(torch.stack([loss.detach(), *(comps[k].detach() for k in COMPONENTS)]))
                loss, comps = total[0], dict(zip(COMPONENTS, total[1:]))
        with span("step/optimizer", imgs.device):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        return state, loss.detach(), {k: comps[k].detach() for k in COMPONENTS}

    return step


def make_eval_step(
    model: YOGO, loss_kwargs: Dict[str, float], quant_params=None,
    rows: Optional[RowSplit] = None,
) -> Callable:
    """(stack, imgs, labels, img_mask) -> (loss, decoded inference preds):
    the loss of the eval-mode output with class logits, and the same
    output with softmaxed classes for the metrics. In a process group of
    N > 1 ranks the loss is the global batch's on every rank.

    quant_params (the family's int8 program, ops/quant.family_quant_plan) evaluates the
    int8 inference path instead of the float forward - `test --quantize`
    measures PTQ accuracy with the program `infer --quantize` runs (the
    stack argument is then unused). The batch is cast to f32 first, as the
    float path casts it to the compute dtype: block 0 then runs the plain
    f32 conv, not the stem kernel, with the same numbers as the JAX
    package's (uint8 and its f32 cast round alike to bf16).

    rows (a parallel/spatial.RowSplit) runs the float forward with each
    image's rows over its devices (BN with the running statistics is
    row-local), as the JAX package validates on its (data, space) mesh."""

    quant_forward = family_quant_forward(model) if quant_params is not None else None

    def step(stack: torch.nn.Module, imgs, labels, img_mask: Optional[torch.Tensor]):
        if quant_forward is not None:
            out_train = quant_forward(model, quant_params, imgs.float(), inference=False)
        else:
            out_train = model.apply(stack, imgs.to(model.compute_dtype), train=False, split=rows)
        with torch.no_grad():
            if process_shard()[1] > 1:
                # the global batch's loss: every rank's sum over the
                # global real-image count, one collective
                one = out_train.new_ones(())
                loss_sum, _ = yogo_loss(out_train, labels, image_mask=img_mask, n_images=one,
                                        **loss_kwargs)
                n = one * out_train.shape[0] if img_mask is None else img_mask.float().sum()
                total = all_reduce_sum(torch.stack([loss_sum, n.to(loss_sum.dtype)]))
                loss = total[0] / torch.clamp(total[1], min=1.0)
            else:
                loss, _ = yogo_loss(out_train, labels, image_mask=img_mask, **loss_kwargs)
            probs = torch.softmax(out_train[:, 5:], dim=1)
            preds_inf = torch.cat([out_train[:, :5], probs], dim=1)
        return loss, preds_inf

    return step


def step_seed(seed: int, step: int) -> int:
    """The generator seed of optimizer step `step` of a run seeded `seed`:
    flips and dropout masks depend on the step, not on how many draws came
    before it, so a resumed run replays the uninterrupted one."""
    return int(np.random.SeedSequence((int(seed), int(step))).generate_state(1, np.uint64)[0] >> 1)


def device_name(device: torch.device) -> str:
    """What config["device"] records: the card's name, or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


class Trainer:
    """The trainer of one rank. `config` mirrors the reference's wandb
    config dict keys (reference: yogo/train.py:612-643). `device` defaults
    to the rank's card (cuda:LOCAL_RANK) and raises without one; "cpu" runs
    on the CPU. Rank and world size come from the process group (world 1
    without one): the loader shards by them, `batch_size` is per rank as in
    the JAX package, the step is the global batch's (make_train_step), rank
    0 alone writes the run directory, a SIGTERM to any rank stops every
    rank at the same epoch boundary, and every rank runs the test pass.

    config["spatial_parallel"] N > 1 splits each image's rows over N
    devices (parallel/mesh.device_grid: N cards, each rank's own N under a
    process group, or N handles to `device` when it is not a card), or
    over the first N of `devices` when given (["cuda:0"] * N maps the
    shards onto one card). The training steps and validation run split;
    the module, its optimizer and its checkpoints live on the first
    device, and the final test pass runs there unsplit."""

    # LR-log clock offset vs global_step (set by _init_training_tools;
    # class-level default keeps partially-constructed Trainers working)
    _lr_step_offset = 0

    def __init__(self, config: Dict[str, Any], device=None, devices=None):
        self.config = config
        self.rank, self.world = process_shard()
        self._spatial = int(config.get("spatial_parallel", 1) or 1)
        if self._spatial > 1 and config.get("image_hw") is not None:
            validate_spatial_height(self._spatial, int(config["image_hw"][0]))
        if self._spatial > 1 or devices:
            self.devices = device_grid(self._spatial, devices=devices, device=device)[0]
            self.device = local_device(self.devices[0])
        else:
            self.device = local_device(device)
            self.devices = [self.device]
        self.rows: Optional[RowSplit] = None
        n_cards = len({d for d in self.devices if d.type == "cuda"})
        if self.world == 1 and self.device.type == "cuda" and torch.cuda.device_count() > n_cards:
            # the port runs one process a card, where the JAX package's
            # Trainer meshes every local device
            n = torch.cuda.device_count()
            on = f"{self.device} alone" if n_cards == 1 else f"{n_cards} of them ({self._spatial} row shards)"
            print(f"train: one process sees {n} cards and trains on {on}; "
                  f"for all of them launch one process a card: torchrun --nproc-per-node {n} "
                  "-m yogo_tpu_torch train ...")
        config["device"] = device_name(self.device)
        self.epoch = 0
        self.global_step = 0
        self.tuning = False
        self.min_val_loss = float("inf")
        self._start_epoch = 0
        self._stop_requested = False
        self.model_save_dir: Optional[Path] = None
        self._initialized = False

    # ----------------------------------------------------------------- init
    def init(self) -> None:
        self._init_dataset_definition()
        self._init_model()
        self._init_dataset()
        self._init_training_tools()
        self._init_logger()
        self._initialized = True

    def _init_dataset_definition(self) -> None:
        self.dataset_definition = DatasetDefinition.from_yaml(
            Path(self.config["dataset_descriptor_file"])
        )
        self.config["class_names"] = self.dataset_definition.classes

    def _init_model(self) -> None:
        cfg = self.config
        pretrained = cfg.get("pretrained_path")
        compute_dtype = torch.bfloat16 if cfg.get("half") else torch.float32
        # fine-tuning from a checkpoint freezes BatchNorm (reference loads
        # pretrained models with tuning=True: yogo/model.py:134)
        self.tuning = not (pretrained is None or pretrained == "none")
        self._pretrained_meta = None
        resume = bool(cfg.get("resume"))
        if resume and (pretrained is None or pretrained == "none"):
            raise ValueError(
                "--resume continues an interrupted run and needs its "
                "checkpoint: pass --from-pretrained <run_dir>/latest.ckpt"
            )
        if pretrained is None or pretrained == "none":
            self.model = YOGO.create(
                img_size=cfg["image_hw"],
                anchor_w=cfg["anchor_w"],
                anchor_h=cfg["anchor_h"],
                num_classes=len(cfg["class_names"]),
                is_rgb=cfg.get("rgb", False),
                normalize_images=cfg.get("normalize_images", False),
                model_version=cfg.get("model") or "base_model",
                compute_dtype=compute_dtype,
            )
            self.stack = self.model.init(
                torch.Generator().manual_seed(int(cfg.get("seed", 0))),
                device=self.device,
            )
            self.global_step = 0
        else:
            model, variables, meta = load_any(pretrained)
            self._pretrained_meta = meta
            if list(model.img_size) != list(cfg["image_hw"]):
                raise RuntimeError(
                    "mismatch in pretrained network image resize shape and "
                    f"current resize shape: pretrained network image_hw = "
                    f"{model.img_size}, requested image_hw = {cfg['image_hw']}"
                )
            self.model = model.with_compute_dtype(compute_dtype)
            self.stack = self.model.module(self.device)
            self.stack.load_state_dict(state_dict_from_flax(variables), strict=True)
            self.global_step = meta.get("step", 0)
            cfg["normalize_images"] = self.model.normalize_images
            cfg["model"] = self.model.model_version
            # the --rgb-images help text promises "overridden if loading a
            # checkpoint"; without this an RGB checkpoint gets 1-channel
            # batches and fails on input-channel mismatch
            cfg["rgb"] = self.model.is_rgb
            if resume:
                # exact continuation of the SAME run (preemption recovery),
                # not a fine-tune: BatchNorm keeps training, the epoch
                # counter / best-val-loss tracker pick up where the
                # checkpoint left them, and AdamW moments + schedule count
                # must come along (the generator is reseeded per step, so
                # the resumed run replays the uninterrupted one)
                self.tuning = False
                cfg["resume_optimizer"] = True
                self._start_epoch = int(
                    meta.get("next_epoch", meta.get("epoch", -1) + 1)
                )
                if meta.get("min_val_loss") is not None:
                    self.min_val_loss = float(meta["min_val_loss"])
                if not cfg.get("model_save_dir") and not cfg.get("name"):
                    # continue IN the interrupted run's directory rather
                    # than forking a fresh timestamped one: the restored
                    # min_val_loss watermark would suppress best.ckpt in a
                    # new dir (no post-resume val beats it), and the final
                    # test pass would then score last-epoch params while
                    # the real best sat unread in the old dir
                    cfg["model_save_dir"] = str(
                        Path(pretrained).resolve().parent
                    )
        self.Sx, self.Sy = self.model.grid
        if self._spatial > 1:
            self.rows = RowSplit(self.model, self.devices)

    def _init_dataset(self) -> None:
        loaders = get_dataloader(
            self.dataset_definition,
            self.config["batch_size"],
            Sx=self.Sx,
            Sy=self.Sy,
            image_hw=self.config["image_hw"],
            rgb=self.config.get("rgb", False),
            normalize_images=self.config.get("normalize_images", False),
            split_fraction_override=self.config.get("dataset_split_override"),
            shard=(self.rank, self.world),
            packed_cache=self.config.get("packed_cache"),
        )
        self.train_dataloader = loaders["train"]
        self.validate_dataloader = loaders.get("val")
        self.test_dataloader = loaders.get("test")
        if self.validate_dataloader is None:
            warnings.warn("no validation dataset found")
        if self.test_dataloader is None:
            warnings.warn("no test dataset found")

    def _init_training_tools(self) -> None:
        cfg = self.config
        # with gradient accumulation the optimizer steps once per A loader
        # batches, so the cosine schedule's horizon is the optimizer-step
        # count (ceil: a final short group still steps once)
        self._accumulate = max(int(cfg.get("accumulate_grad_batches", 1) or 1), 1)
        steps_per_epoch = -(-len(self.train_dataloader) // self._accumulate)
        total_steps = cfg["epochs"] * steps_per_epoch
        # --fsdp: the large parameters (and so their AdamW moments) sharded
        # over the ranks; the optimizer is built over the sharded ones
        self._fsdp = bool(cfg.get("fsdp")) and self.world > 1
        if self._fsdp:
            fully_shard_stack(self.stack)
        optimizer, scheduler, self.lr_schedule = make_optimizer(
            self.stack.parameters(),
            learning_rate=cfg["learning_rate"],
            weight_decay=cfg["weight_decay"],
            decay_factor=cfg["decay_factor"],
            total_steps=total_steps,
            clip_value=cfg.get("clip_value", 1.0),
        )
        self.loss_kwargs = dict(
            no_obj_weight=cfg["no_obj_weight"],
            iou_weight=cfg["iou_weight"],
            classify_weight=cfg.get("classify_weight", df.CLASSIFY_WEIGHT),
            label_smoothing=cfg["label_smoothing"],
        )
        # --resume-optimizer: exact resume restores AdamW moments from the
        # checkpoint (extension: the reference restores neither optimizer
        # nor schedule state, yogo/train.py:136-148 - off by default)
        restored_opt = False
        if cfg.get("resume_optimizer") and self._pretrained_meta is not None:
            restored_opt = restore_opt_state(
                self._pretrained_meta, self.stack, optimizer, scheduler
            )
            if not restored_opt:
                # a ckpt saved without opt_state carries no optimizer
                # state: say so instead of silently starting AdamW fresh
                # while the LR log pretends an exact resume
                warnings.warn(
                    "--resume-optimizer: the checkpoint has no saved "
                    "optimizer state (reference .pth files never do) - "
                    "AdamW starts fresh and the LR schedule/log run on "
                    "this run's clock"
                )
        # the scheduler counts steps from THIS run's optimizer unless
        # --resume-optimizer restored the saved count; the logged "LR" must
        # tick on the same clock, or fine-tune runs log mid-decay values
        # while actually at the cosine start
        self._lr_step_offset = 0 if restored_opt else self.global_step
        self.state = TrainState(
            stack=self.stack, optimizer=optimizer, scheduler=scheduler,
            step=int(self.global_step),
        )
        self._train_step = make_train_step(
            self.model, self.loss_kwargs, tuning=self.tuning,
            remat=cfg.get("remat", "none"),
            accumulate=self._accumulate,
            rows=self.rows,
        )
        self._eval_step = make_eval_step(self.model, self.loss_kwargs, rows=self.rows)
        self._seed = int(cfg.get("seed", 0))
        # a CPU generator: the same draws whatever device trains
        self._gen = torch.Generator()

    def _init_logger(self) -> None:
        cfg = self.config
        run_dir = cfg.get("model_save_dir")
        name = cfg.get("name") or f"run_{int(time.time())}"
        if run_dir is None:
            run_dir = Path("trained_models") / name
        self.model_save_dir = Path(run_dir)
        self.logger = RunLogger(
            log_dir=self.model_save_dir,
            config=cfg,
            use_wandb=cfg.get("use_wandb", True),
            wandb_entity=cfg.get("wandb_entity"),
            wandb_project=cfg.get("wandb_project"),
            name=cfg.get("name"),
            notes=cfg.get("note"),
            tags=cfg.get("tags"),
            enabled=self.rank == 0,
        )
        self.logger.update_config(
            {
                "Sx": self.Sx,
                "Sy": self.Sy,
                "training set size": f"{len(self.train_dataloader.dataset)} images",
                "validation set size": (
                    f"{len(self.validate_dataloader.dataset)} images"
                    if self.validate_dataloader
                    else "0 images"
                ),
                "testing set size": (
                    f"{len(self.test_dataloader.dataset)} images"
                    if self.test_dataloader
                    else "0 images"
                ),
            }
        )

    # ----------------------------------------------------------- checkpoint
    def checkpoint(self, filename: Path, model_name: str, **kwargs) -> None:
        # rank 0 alone writes: replicated state is equal everywhere, and two
        # writers of one file on a shared filesystem would race. Sharded
        # (--fsdp) state is first gathered whole by every rank together
        # (the JAX package's fetch_replicated)
        if self.rank != 0 and not getattr(self, "_fsdp", False):
            return
        st = self.state
        variables = flax_from_state_dict(full_state_dict(st.stack))
        opt_state = optax_state_from_torch(st.stack, st.optimizer, st.scheduler)
        if self.rank != 0:
            return
        # resume metadata: which epoch a --resume run should start at, and
        # the best-val-loss watermark so best.ckpt isn't overwritten by a
        # worse post-resume validation (getattr: tests build bare Trainers)
        kwargs.setdefault("next_epoch", getattr(self, "epoch", -1) + 1)
        mvl = getattr(self, "min_val_loss", float("inf"))
        kwargs.setdefault(
            "min_val_loss", float(mvl) if np.isfinite(mvl) else None
        )
        save_checkpoint(
            filename,
            self.model,
            variables,
            opt_state=opt_state,
            epoch=self.epoch,
            step=int(st.step),
            classes=self.config["class_names"],
            model_name=model_name,
            **kwargs,
        )

    # ----------------------------------------------------------------- train
    def train(self) -> Optional[Tuple]:
        if not self._initialized:
            raise RuntimeError("trainer not initialized")

        profile_steps = int(self.config.get("profile_steps", 0) or 0)
        # --from-pretrained starts global_step at the checkpoint's step, so
        # the profile gate must count steps of THIS run, not absolute steps
        profile_start = self.global_step + 1
        commit_interval = max(
            1, int(self.config.get("log_commit_interval", 100) or 100)
        )
        # graceful preemption (the reference has none): a SIGTERM - the
        # grace signal cluster preemption delivers - finishes the in-flight
        # step, checkpoints latest.ckpt, and exits cleanly so the follow-up
        # run continues with --resume. Registered only on the main thread
        # (signal.signal raises elsewhere). The previous disposition may
        # legitimately be None (installed from C), so "never installed"
        # needs its own sentinel for the restore.
        self._stop_requested = False  # a stale flag from a prior train()
        not_installed = object()
        prev_sigterm = not_installed
        try:
            prev_sigterm = signal.signal(
                signal.SIGTERM,
                lambda s, f: setattr(self, "_stop_requested", True),
            )
        except ValueError:
            pass
        try:
            return self._train_epochs(profile_steps, profile_start,
                                      commit_interval)
        finally:
            # restored in ALL exits - including exceptions out of the epoch
            # loop (otherwise the lambda leaks process-wide and SIGTERM is
            # silently swallowed for the life of the process) - and only
            # AFTER the interrupted-path grace-window checkpoint inside, so
            # a repeated SIGTERM during that save stays absorbed
            if prev_sigterm is not not_installed:
                # signal.signal REJECTS None as a handler even though it
                # RETURNS None for a C-installed one; the closest
                # restorable disposition is the default
                signal.signal(
                    signal.SIGTERM,
                    signal.SIG_DFL if prev_sigterm is None else prev_sigterm,
                )

    def _train_epochs(
        self, profile_steps: int, profile_start: int, commit_interval: int
    ) -> Optional[Tuple]:
        self._profiler = None
        self._profile_steps, self._profile_start = profile_steps, profile_start
        interrupted = mid_epoch_stop = False
        for epoch in range(self._start_epoch, self.config["epochs"]):
            self.epoch = epoch
            self.train_dataloader.set_epoch(epoch)
            with span("train_epoch"):
                interrupted = mid_epoch_stop = self._train_one_epoch(
                    epoch, commit_interval
                )
            if interrupted:
                break

            if epoch % 4 == 0:
                with span("validate"):
                    self._validate()

            # every-epoch latest.ckpt: the preemption-recovery anchor (the
            # reference writes latest only at non-best validations). State
            # is unchanged since _validate, so this supersedes rather than
            # duplicates a latest write there. checkpoint_interval
            # (extension, default 1) throttles the cadence: on big nets
            # with short epochs the state fetch + disk write per epoch can
            # dominate wall time; a preemption between writes just replays
            # at most interval-1 epochs on --resume.
            ckpt_interval = max(
                1, int(self.config.get("checkpoint_interval", 1) or 1)
            )
            is_last = epoch + 1 >= self.config["epochs"]
            if self.model_save_dir is not None and (
                (epoch + 1) % ckpt_interval == 0 or is_last
            ):
                with span("checkpoint"):
                    self.checkpoint(
                        self.model_save_dir / "latest.ckpt",
                        model_name=self.logger.run_name or "recent_run_latest",
                    )
            if self._stop_consensus():
                interrupted = True
                break

        if self._profiler is not None:
            # the profile window reached the end of training before the
            # in-loop stop step: finalize so the trace is actually flushed
            _stop_profile(self._profiler, self.model_save_dir)
            self._profiler = None

        if interrupted:
            # preemption exit: persist state for --resume and return
            # without the best-reload/test pass (the grace window is short)
            if self.model_save_dir is not None and mid_epoch_stop:
                # a mid-epoch stop leaves this epoch unfinished: a --resume
                # must replay it from the top
                self.checkpoint(
                    self.model_save_dir / "latest.ckpt",
                    model_name=self.logger.run_name or "recent_run_latest",
                    next_epoch=self.epoch,
                )
            elif self.model_save_dir is not None and (
                (self.epoch + 1)
                % max(1, int(self.config.get("checkpoint_interval", 1) or 1))
                != 0
            ):
                # boundary stop on an epoch the checkpoint_interval
                # throttle skipped: write now so --resume loses nothing
                self.checkpoint(
                    self.model_save_dir / "latest.ckpt",
                    model_name=self.logger.run_name or "recent_run_latest",
                )
            print(
                "training interrupted by SIGTERM: state saved to "
                f"{(self.model_save_dir or Path('.')) / 'latest.ckpt'} - "
                "continue with `train ... --from-pretrained "
                "<that file> --resume`",
                file=sys.stderr,
            )
            self.logger.finish()
            return None

        # reload best checkpoint and evaluate on the test split
        # (reference: yogo/train.py:344-361). Rank 0 may still be writing
        # best.ckpt: every rank waits for it before reading
        barrier()
        best = (self.model_save_dir or Path(".")) / "best.ckpt"
        tested: Any = self.state.stack
        if self._fsdp:
            # the test pass runs a whole model on every rank, as the JAX
            # package's fetch_replicated state on a fresh mesh
            tested = flax_from_state_dict(full_state_dict(self.state.stack))
        if best.exists():
            _, variables, _ = load_any(best)
            if self._fsdp:
                tested = variables
            else:
                self.state.stack.load_state_dict(
                    state_dict_from_flax(variables), strict=True
                )
        else:
            warnings.warn(f"no best model found at {best} for testing...")

        test_metrics = None
        if self.test_dataloader is not None:
            with span("test"):
                test_metrics = self.test(
                    self.test_dataloader,
                    self.config,
                    self.model,
                    tested,
                    fast_eval=self.config.get("fast_eval", True),
                    fast_eval_max_detections=self.config.get(
                        "fast_eval_max_detections", 256
                    ),
                    fast_eval_max_labels=self.config.get(
                        "fast_eval_max_labels", 256
                    ),
                    device=self.device,
                )
            if test_metrics is not None:
                self._log_test_metrics(*test_metrics)
        else:
            warnings.warn("no test metrics found - test_dataloader is empty")

        self.logger.finish()
        return test_metrics

    def _train_one_epoch(self, epoch: int, commit_interval: int) -> bool:
        """The optimizer steps of one epoch; returns whether a stop request
        cut it short.

        Per-step losses are buffered as device scalars and fetched once per
        commit interval: a float(loss) each step would make the host wait
        for the device every step (the reference likewise commits its wandb
        log every 100 steps, yogo/train.py:329-339)."""
        stopped = False
        pending: list = []
        window_start = time.perf_counter()
        window_imgs = 0
        for imgs, labels, mask in prefetch_to_device(
            self.train_dataloader, self.device, accumulate=self._accumulate
        ):
            if self._stop_requested and self.world == 1:
                # stop mid-epoch before dispatching the next step (the
                # caller's checkpoint records this epoch as unfinished, a
                # --resume replays it from the top). Checking BEFORE the
                # step - not after it - means a signal that lands during
                # the epoch's final step lets the loop exhaust naturally,
                # so a fully-completed epoch is recorded complete instead
                # of being replayed. Ranks of a group may see the signal at
                # different steps: they keep their collectives in lockstep
                # and agree at the epoch boundary instead (_stop_consensus).
                stopped = True
                break
            # optional torch.profiler trace of the first few hot-loop steps
            # (the reference has only a Timer)
            if self._profile_steps and self.global_step == self._profile_start and self.rank == 0:
                self._profiler = _start_profile()
            if (
                self._profiler is not None
                and self.global_step >= self._profile_start + self._profile_steps
            ):
                _stop_profile(self._profiler, self.model_save_dir)
                self._profiler = None
                self._profile_steps = 0

            # a stacked (A, b, ...) accumulation group carries A*b images
            batch_imgs = imgs.shape[0] * (imgs.shape[1] if imgs.ndim == 5 else 1)
            self._gen.manual_seed(step_seed(self._seed, self.global_step))
            self.state, loss, comps = self._train_step(
                self.state, imgs, labels, mask, self._gen
            )
            self.global_step += 1
            window_imgs += batch_imgs
            pending.append((self.global_step, loss, comps))
            if self.global_step % commit_interval == 0:
                window_start = self._flush_train_logs(
                    pending, epoch, window_imgs, window_start
                )
                window_imgs = 0
        if pending:
            self._flush_train_logs(pending, epoch, window_imgs, window_start)
        return stopped

    def _flush_train_logs(
        self, pending: list, epoch: int, window_imgs: int, window_start: float
    ) -> float:
        """Fetch the buffered per-step device scalars in one transfer and
        emit the per-step log records. Returns the new window start time.
        The fetch waits for the newest step, so it is also the fence that
        makes `images/sec` a rate of finished steps."""
        host_vals = torch.stack(
            [torch.stack([ls, *(c[k] for k in COMPONENTS)]) for _, ls, c in pending]
        ).cpu().tolist()
        now = time.perf_counter()
        rate = window_imgs / max(now - window_start, 1e-9)
        last_step = pending[-1][0]
        for (step, _, _), (loss, *comps) in zip(pending, host_vals):
            self.logger.log(
                {
                    "train loss": loss,
                    "epoch": epoch,
                    "LR": float(self.lr_schedule(step - self._lr_step_offset)),
                    "images/sec": rate,
                    **dict(zip(COMPONENTS, comps)),
                },
                step=step,
                commit=step == last_step,
            )
        pending.clear()
        return now

    # -------------------------------------------------------------- validate
    def _validate(self) -> None:
        if self.validate_dataloader is None:
            return
        losses = []  # device scalars: fetched ONCE after the loop
        last_batch = None
        for imgs, labels, mask in prefetch_to_device(self.validate_dataloader, self.device):
            loss, preds = self._eval_step(self.state.stack, imgs, labels, mask)
            losses.append(loss)
            last_batch = (imgs, preds)
        if not losses:
            return
        mean_val_loss = float(np.mean(torch.stack(losses).cpu().numpy()))

        log: Dict[str, Any] = {"val loss": mean_val_loss}
        try:  # rank 0: the last batch's first image with its boxes, best effort
            if self.rank == 0:
                from yogo_tpu_torch.utils.drawing import draw_yogo_prediction

                img = draw_yogo_prediction(
                    last_batch[0][0].cpu().numpy(),
                    last_batch[1][0].float().cpu().numpy(),
                    labels=self.config["class_names"],
                    images_are_normalized=self.config.get("normalize_images", False),
                )
                if self.model_save_dir is not None:
                    img.save(self.model_save_dir / "validation_bbs.png")
        except Exception as e:  # drawing must never stop training
            warnings.warn(f"could not draw validation image: {e}")

        if mean_val_loss < self.min_val_loss:
            self.min_val_loss = mean_val_loss
            log["best_val_loss"] = mean_val_loss
            self.checkpoint(
                self.model_save_dir / "best.ckpt",
                model_name=self.logger.run_name or "recent_run_best",
            )
        # (the reference writes latest.ckpt here when not best,
        # yogo/train.py _validate; this trainer writes latest at EVERY
        # epoch end instead - same state, strictly fresher cadence)
        self.logger.log(log, step=self.global_step)

    def _stop_consensus(self) -> bool:
        """Whether to stop at this epoch boundary: a SIGTERM seen by any
        rank stops every rank here, decided together (an all_reduce MAX of
        the flags; the flag itself at world 1)."""
        if self.world == 1:
            return self._stop_requested
        flag = torch.tensor([int(self._stop_requested)], device=self.device)
        return bool(all_reduce_max(flag).item())

    # ------------------------------------------------------------------ test
    @staticmethod
    def test(
        test_dataloader: DataLoader,
        config: Dict[str, Any],
        model: YOGO,
        variables: Any,
        include_mAP: bool = True,
        include_background: bool = False,
        quantize: bool = False,
        fast_eval: bool = False,
        fast_eval_max_detections: int = 256,
        fast_eval_max_labels: int = 256,
        device=None,
    ) -> Optional[Tuple]:
        """Full test pass: loss + Metrics over the test loader. Returns the
        reference's metric tuple (reference: yogo/train.py:446-528).

        variables: the flax-layout tree load_any returns (the module is
        then built on `device`, default CUDA), or a module, which is
        used where it lies.

        quantize=True (extension) evaluates the int8 PTQ inference path
        (the `infer --quantize` program), calibrated on the first test
        batch - so PTQ accuracy can be measured on a real dataset.

        fast_eval=True (extension) accumulates metrics ON DEVICE
        (metrics/device_metrics.py): the whole per-batch update runs there
        and predictions are never fetched to the host, instead of the
        per-image Hungarian loop. Greedy matching + 1/4096-binned mAP
        scores; the integer counters are exact (see the module docstring).
        The device engine's state is fixed-capacity:
        fast_eval_max_detections / fast_eval_max_labels bound the
        per-image detections and GT boxes (the host engine caps detections
        at 1024 and labels not at all) - DeviceMetrics warns at compute()
        when a scene overflowed; raise these for denser datasets.

        In a process group each rank passes its loader shard and runs this
        together: the loss is the global batch's, the device engine sums
        its state over the ranks (it scores the global batch, as the JAX
        package's SPMD update), the host engine scores this rank's rows,
        and quantize runs rank 0's int8 program on every rank."""
        Trainer._check_keys(config)
        if test_dataloader is None or len(test_dataloader) == 0:
            return None

        if isinstance(variables, torch.nn.Module):
            stack = variables
            device = next(stack.parameters()).device
        else:
            device = resolve_device(device)
            stack = model.module(device)
            stack.load_state_dict(state_dict_from_flax(variables), strict=True)

        if fast_eval:
            # the engines agree except in constructed cases; say so once
            # per eval so a user comparing against reference numbers knows
            # which knob to turn
            print(
                "fast-eval: device metrics engine (greedy max-IoU "
                "matching, mAP scores binned to 1/4096; integer counters "
                "exact). Engines can differ only when detections compete "
                "for overlapping ground truths - --no-fast-eval restores "
                "the host-exact Hungarian engine.",
                file=sys.stderr,
            )
            metrics: Any = DeviceMetrics(
                classes=config["class_names"],
                include_mAP=include_mAP,
                include_background=include_background,
                max_detections=fast_eval_max_detections,
                max_labels=fast_eval_max_labels,
                device=device,
            )
        else:
            metrics = Metrics(
                classes=config["class_names"],
                include_mAP=include_mAP,
                include_background=include_background,
            )
        loss_kwargs = dict(
            no_obj_weight=config["no_obj_weight"],
            iou_weight=config["iou_weight"],
            classify_weight=config.get("classify_weight", df.CLASSIFY_WEIGHT),
            label_smoothing=config["label_smoothing"],
        )
        quant_params = None
        if quantize:
            # validates the family BEFORE a test batch is consumed for
            # calibration (yogo_tpu/train.py:1031-1040)
            build_qp, _, n_scales, _ = family_quant_plan(model, stack, device=device)
            calib = next(iter(test_dataloader))[0]  # len checked above
            # in a process group every rank runs rank 0's program
            quant_params = quant_program_of_rank0(build_qp, n_scales, [calib], device)
        eval_step = make_eval_step(model, loss_kwargs, quant_params=quant_params)

        losses = []  # device scalars, fetched once after the loop
        for imgs, labels, mask in prefetch_to_device(test_dataloader, device):
            loss, preds = eval_step(stack, imgs, labels, mask)
            losses.append(loss)
            # the batch keeps its fixed shape: the mask excludes padded
            # tail images inside the formatter. Both engines take the
            # predictions where they lie; the host engine fetches the
            # padded detections, the device engine nothing.
            metrics.update(preds, labels, image_mask=mask)

        (
            mAP,
            confusion,
            accuracy,
            roc,
            precision,
            recall,
            calibration_error,
            num_obj_missed_by_class,
            num_obj_extra_by_class,
            total_num_true_objects,
        ) = metrics.compute()

        mean_loss = float(
            torch.stack(losses).cpu().numpy().astype(np.float64).sum()
        ) / max(len(losses), 1)
        return (
            mean_loss,
            mAP,
            confusion,
            accuracy,
            roc,
            precision,
            recall,
            calibration_error,
            num_obj_missed_by_class,
            num_obj_extra_by_class,
            total_num_true_objects,
            config["class_names"],
        )

    @staticmethod
    def _check_keys(config: Dict[str, Any]) -> None:
        required = (
            "class_names",
            "iou_weight",
            "no_obj_weight",
            "label_smoothing",
            "half",
        )
        for key in required:
            if key not in config:
                raise ValueError(
                    f"{key} is required in config (full list of keys: {required})"
                )

    def _log_test_metrics(self, *metrics) -> None:
        (
            mean_test_loss,
            mAP,
            confusion,
            accuracy,
            roc,
            precision,
            recall,
            calibration_error,
            num_obj_missed_by_class,
            num_obj_extra_by_class,
            total_num_true_objects,
            class_names,
        ) = metrics
        summary = {
            "test loss": mean_test_loss,
            "test mAP": mAP.get("map"),
            "test mAP (full)": {
                k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in mAP.items()
            },
            "test precision": float(np.mean(precision)),
            "test recall": float(np.mean(recall)),
            "calibration error": calibration_error,
            "num obj missed by class": num_obj_missed_by_class.tolist(),
            "num obj extra by class": num_obj_extra_by_class.tolist(),
            "total num true objects": int(total_num_true_objects[0]),
            "per-class precision": {
                f"test precision {cn}": float(precision[i])
                for i, cn in enumerate(class_names)
            },
            "per-class recall": {
                f"test recall {cn}": float(recall[i])
                for i, cn in enumerate(class_names)
            },
            "test confusion": confusion.tolist(),
            "test accuracy": accuracy.tolist(),
            # archived metric files must record which engine produced them:
            # fast-eval (default) = device greedy matching with 1/4096-
            # binned mAP scores; host = reference-exact Hungarian
            "eval engine": (
                "device-fast-eval"
                if self.config.get("fast_eval", True)
                else "host-hungarian"
            ),
        }
        self.logger.summary(summary)


def _start_profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, run_dir: Optional[Path]) -> None:
    prof.stop()
    out = (run_dir or Path(".")) / "profile"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def do_training(args) -> None:
    """Build a config dict from parsed args and run training - the CLI entry
    (reference: yogo/train.py:606-656, minus the mp.spawn/NCCL machinery:
    one process drives one device)."""
    config = {
        "learning_rate": args.learning_rate,
        "decay_factor": args.lr_decay_factor,
        "weight_decay": args.weight_decay,
        "label_smoothing": args.label_smoothing,
        "iou_weight": args.iou_weight,
        "no_obj_weight": args.no_obj_weight,
        "classify_weight": args.classify_weight,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "anchor_w": df.ANCHOR_W,
        "anchor_h": df.ANCHOR_H,
        "model": args.model,
        "half": args.half,
        "rgb": args.rgb_images,
        "image_hw": tuple(args.image_hw),
        "pretrained_path": args.from_pretrained,
        "normalize_images": args.normalize_images,
        "dataset_split_override": args.dataset_split_override,
        "dataset_descriptor_file": args.dataset_descriptor_file,
        "torch-version": torch.__version__,
        "python-version": sys.version,
        "name": args.name,
        "note": args.note,
        "tags": args.tags,
        "wandb_entity": args.wandb_entity,
        "wandb_project": args.wandb_project,
        "use_wandb": getattr(args, "wandb", True),
        "profile_steps": getattr(args, "profile_steps", 0),
        "resume": getattr(args, "resume", False),
        "resume_optimizer": getattr(args, "resume_optimizer", False),
        "remat": getattr(args, "remat", "none"),
        "spatial_parallel": getattr(args, "spatial_parallel", 1),
        "fsdp": getattr(args, "fsdp", False),
        "accumulate_grad_batches": getattr(args, "accumulate_grad_batches", 1),
        "packed_cache": getattr(args, "packed_cache", None),
        "checkpoint_interval": getattr(args, "checkpoint_interval", 1),
        "fast_eval": getattr(args, "fast_eval", False),
        "fast_eval_max_detections": getattr(
            args, "fast_eval_max_detections", 256
        ),
        "fast_eval_max_labels": getattr(args, "fast_eval_max_labels", 256),
    }
    trainer = Trainer(config, device=getattr(args, "device", None))
    trainer.init()
    return trainer.train()
