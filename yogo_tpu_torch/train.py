"""The training step (port of yogo_tpu/train.py:70-294): train state,
optimizer recipe, train step and eval step. The Trainer class, the data
pipeline and the `train` / `test` subcommands are not ported yet.

Recipe (reference: yogo/train.py:206-223,295-342): AdamW(lr 3e-4, wd 5e-2)
with decoupled weight decay on every parameter, a cosine schedule stepped
per optimizer step from lr to lr/decay_factor, and an elementwise gradient
clamp to +-clip_value before the optimizer sees the gradients.

Where the JAX step is a pure function of an immutable state, this one
mutates: the ConvStack holds parameters and BN statistics, the AdamW its
moments, and `step` returns the same TrainState it was given. Randomness
comes from an explicit torch.Generator that advances with every draw, where
JAX folds the step number into a key.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from yogo_tpu_torch.data.transforms import random_flips
from yogo_tpu_torch.losses import yogo_loss
from yogo_tpu_torch.models.yogo import REMAT_MODES, YOGO, ConvStack, no_tf32

COMPONENTS = ("iou_loss", "objectness_loss", "classification_loss")


@dataclass
class TrainState:
    stack: ConvStack
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


class ClampedAdamW(torch.optim.AdamW):
    """AdamW that first clamps every gradient elementwise to +-clip_value
    (the reference clamps in per-parameter backward hooks,
    yogo/model.py:75-77; here, as in optax.chain(clip, adamw), the clamp
    sees the whole step's gradient, after any accumulation)."""

    def __init__(self, params, clip_value: float, **kwargs):
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


def _bn_buffers(stack: ConvStack) -> Dict[str, torch.Tensor]:
    return {k: b for k, b in stack.named_buffers() if k.endswith(("running_mean", "running_var"))}


def make_train_step(
    model: YOGO,
    loss_kwargs: Dict[str, float],
    augment: bool = True,
    tuning: bool = False,
    remat: str = "none",
    accumulate: int = 1,
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
    cosine schedule ticks once per optimizer step."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be none|blocks|full, got {remat!r}")
    if accumulate < 1:
        raise ValueError(f"accumulate must be >= 1, got {accumulate}")

    def forward(stack, imgs, labels, img_mask, generator):
        x = imgs.to(model.compute_dtype)
        if augment:
            x, labels = random_flips(generator, x, labels)
        out = model.apply(
            stack, x, train=True, tuning=tuning, generator=generator, remat=remat
        )
        return yogo_loss(out, labels, image_mask=img_mask, **loss_kwargs)

    def step(state: TrainState, imgs, labels, img_mask, generator=None):
        stack = state.stack
        state.optimizer.zero_grad(set_to_none=True)
        # float32 means float32 in the backward convs too
        with no_tf32(imgs.device):
            if accumulate == 1:
                loss, comps = forward(stack, imgs, labels, img_mask, generator)
                loss.backward()
            else:
                if imgs.shape[0] != accumulate:
                    raise ValueError(
                        f"expected {accumulate} stacked micro-batches, got {imgs.shape[0]}"
                    )
                stats = {} if tuning else _bn_buffers(stack)
                lsum = wsum = 0.0
                csum = dict.fromkeys(COMPONENTS, 0.0)
                for mi, ml, mm in zip(imgs, labels, img_mask):
                    before = {k: b.clone() for k, b in stats.items()}
                    loss, comps = forward(stack, mi, ml, mm, generator)
                    # loss and gradient came back divided by max(count, 1):
                    # count * value recovers the sums (zero for all padding)
                    w = mm.float().sum()
                    (w * loss).backward()
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
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, loss.detach(), {k: comps[k].detach() for k in COMPONENTS}

    return step


def make_eval_step(
    model: YOGO, loss_kwargs: Dict[str, float], quant_params=None
) -> Callable:
    """(stack, imgs, labels, img_mask) -> (loss, decoded inference preds):
    the loss of the eval-mode output with class logits, and the same
    output with softmaxed classes for the metrics."""
    if quant_params is not None:
        raise NotImplementedError(
            "the int8 eval path waits for the port of ops/quant.py "
            "(ROADMAP.md Queue 1 item 11)"
        )

    def step(stack: ConvStack, imgs, labels, img_mask: Optional[torch.Tensor]):
        out_train = model.apply(stack, imgs.to(model.compute_dtype), train=False)
        with torch.no_grad():
            loss, _ = yogo_loss(out_train, labels, image_mask=img_mask, **loss_kwargs)
            probs = torch.softmax(out_train[:, 5:], dim=1)
            preds_inf = torch.cat([out_train[:, :5], probs], dim=1)
        return loss, preds_inf

    return step
