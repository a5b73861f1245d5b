"""The plain reference: YOGO's decode, NMS and count, loss and AdamW
step, in plain PyTorch, float32 with TF32 off, written from the published
descriptions (czbiohub-sf/yogo: yogo/model.py, yogo_loss.py,
utils/prediction_formatting.py). Each family's forward pass is in
families/<family>.py, found by the configuration's `family`
(manifest.family); `grid`, `head` and `train_steps` dispatch through it.
It imports nothing of the program and takes nothing it made: weights come
from the benchmark (weights.py, ckpt.py).

`cast` is the precision of the convs' and Dense layers' operands: the
identity for float32, `fp8` for the control that computes them in
float8 e4m3 (the precision below bfloat16).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yogo_bench import manifest

WH_CLAMP = 80.0
FP8_MAX = 448.0

Cast = Callable[[torch.Tensor], torch.Tensor]


def f32(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a tensor (its absolute
    maximum to 448), back in float32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


@contextlib.contextmanager
def exact():
    """TF32 off for cuDNN and cuBLAS while the reference runs."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def grid(cfg: dict) -> Tuple[int, int]:
    """(Sx, Sy) of the configuration's head."""
    return manifest.family(cfg["family"]).grid(cfg)


def head(w, frames: torch.Tensor, cfg: dict, cast: Cast = f32, block: int = 8) -> torch.Tensor:
    """The (B, Sy, Sx, 5+C) float32 head of uint8 frames (B, 1, H, W) on
    w's device, `block` images at a time, without autograd."""
    fwd = manifest.family(cfg["family"]).forward
    dev = next(iter(w.values())).device
    out = []
    with torch.no_grad(), exact():
        for i in range(0, frames.shape[0], block):
            x = torch.as_tensor(frames[i:i + block]).to(dev).float()
            out.append(fwd(w, x, cfg, cast=cast))
    return torch.cat(out)


# ------------------------------------------------------ decode, NMS, count


def decode(raw: torch.Tensor, cfg: dict) -> torch.Tensor:
    """YOLO9000 direct-location decode of a (..., Sy, Sx, 5+C) head ->
    float32 (..., Sy, Sx, 5+C) [xc, yc, w, h, objectness, class probs]."""
    sx, sy = grid(cfg)
    raw = raw.float()
    dev = raw.device
    cx = torch.linspace(0.0, 1.0 - 1.0 / sx, sx, device=dev)[None, :].expand(sy, sx)
    cy = torch.linspace(0.0, 1.0 - 1.0 / sy, sy, device=dev)[:, None].expand(sy, sx)
    xc = torch.sigmoid(raw[..., 0]) * (1.0 / sx) + cx
    yc = torch.sigmoid(raw[..., 1]) * (1.0 / sy) + cy
    bw = cfg["anchor_w"] * torch.exp(torch.clamp(raw[..., 2], max=WH_CLAMP))
    bh = cfg["anchor_h"] * torch.exp(torch.clamp(raw[..., 3], max=WH_CLAMP))
    obj = torch.sigmoid(raw[..., 4])
    return torch.cat([torch.stack([xc, yc, bw, bh, obj], -1), torch.softmax(raw[..., 5:], -1)], -1)


def detections(raw_image: torch.Tensor, cfg: dict, obj_thresh: float = 0.5, iou_thresh: float = 0.5,
               max_detections: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """One image's (Sy, Sx, 5+C) head -> (its detections (N, 5+C) cxcywh
    rows, their flat cell indices): the cells whose objectness is strictly
    above obj_thresh, the `max_detections` most objective of them, then
    greedy NMS in order of max(class prob) * objectness (ties: the lower
    cell index first), suppressing IoU strictly above iou_thresh."""
    d = decode(raw_image, cfg).reshape(-1, raw_image.shape[-1])
    obj = d[:, 4]
    idx = torch.nonzero(obj > obj_thresh).flatten()
    if len(idx) > max_detections:
        order = torch.argsort(-obj[idx], stable=True)[:max_detections]
        idx = idx[order]
    rows = d[idx]
    xc, yc, bw, bh = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    boxes = torch.stack([xc - bw / 2, yc - bh / 2, xc + bw / 2, yc + bh / 2], -1)
    ext = torch.clamp(boxes[:, 2:] - boxes[:, :2], 0, 1e19)
    area = ext[:, 0] * ext[:, 1]
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = torch.clamp(rb - lt, 0, 1e19)
    inter = wh[..., 0] * wh[..., 1]
    iou = (inter / (area[:, None] + area[None, :] - inter)).cpu().numpy()
    score = (rows[:, 5:].amax(-1) * rows[:, 4]).cpu().numpy()
    cells = idx.cpu().numpy()
    order = np.lexsort((cells, -score))
    keep: List[int] = []
    for i in order:
        if all(not iou[j, i] > iou_thresh for j in keep):
            keep.append(int(i))
    keep = sorted(keep, key=lambda i: (-score[i], cells[i]))
    return rows[keep].cpu().numpy(), cells[keep]


def counts(raw: torch.Tensor, cfg: dict, image_mask: Optional[Sequence[bool]] = None, **thresholds) -> np.ndarray:
    """(B, Sy, Sx, 5+C) head -> (C,) per-class counts of the detections of
    each image (argmax class), images with a false mask left out."""
    c = raw.shape[-1] - 5
    total = np.zeros(c, np.int64)
    for b in range(raw.shape[0]):
        if image_mask is not None and not image_mask[b]:
            continue
        rows, _ = detections(raw[b], cfg, **thresholds)
        if len(rows):
            total += np.bincount(rows[:, 5:].argmax(1), minlength=c)
    return total


# --------------------------------------------------------------- training


def flips(images: torch.Tensor, labels: torch.Tensor, do_h: bool, do_v: bool):
    """Whole-batch flips of images (B, C, H, W) and label grids (B, 6, Sy,
    Sx) [mask, x1, y1, x2, y2, class]."""
    if do_h:
        m, x1, y1, x2, y2, c = labels.unbind(1)
        labels = torch.stack([m, (1 - x2) * m, y1, (1 - x1) * m, y2, c], 1).flip(3)
        images = images.flip(3)
    if do_v:
        m, x1, y1, x2, y2, c = labels.unbind(1)
        labels = torch.stack([m, x1, (1 - y2) * m, x2, (1 - y1) * m, c], 1).flip(2)
        images = images.flip(2)
    return images, labels


def step_draws(seed: int, cfg: dict, batch: int) -> Tuple[bool, bool, Dict[int, torch.Tensor]]:
    """The random draws of one training step from a CPU generator seeded
    `seed`: two coins (horizontal, vertical flip, each at p = 0.5), then a
    channel-dropout mask (B, C, 1, 1) for each block with dropout, in block
    order: rand < p drops a channel, kept ones scale by 1 / (1 - p)."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    u = torch.rand(2, generator=g).tolist()
    masks = {}
    for i, b in enumerate(cfg["blocks"]):
        if b["dropout"] > 0:
            r = torch.rand((batch, b["out"], 1, 1), generator=g)
            masks[i] = (r >= b["dropout"]).float() / (1.0 - b["dropout"])
    return u[0] < 0.5, u[1] < 0.5, masks


def _ciou(p: torch.Tensor, t: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete-IoU loss of xyxy boxes (torchvision's form; a zero height
    inside atan taken as 1)."""
    x1, y1, x2, y2 = p.unbind(-1)
    a1, b1, a2, b2 = t.unbind(-1)
    iw = (torch.minimum(x2, a2) - torch.maximum(x1, a1)).clamp(min=0)
    ih = (torch.minimum(y2, b2) - torch.maximum(y1, b1)).clamp(min=0)
    inter = iw * ih
    union = (x2 - x1) * (y2 - y1) + (a2 - a1) * (b2 - b1) - inter
    iou = inter / (union + eps)
    diag = (torch.maximum(x2, a2) - torch.minimum(x1, a1)) ** 2 + (torch.maximum(y2, b2) - torch.minimum(y1, b1)) ** 2 + eps
    center = ((x1 + x2 - a1 - a2) ** 2 + (y1 + y2 - b1 - b2) ** 2) / 4
    hp = torch.where(y2 - y1 == 0, torch.ones_like(y1), y2 - y1)
    ht = torch.where(b2 - b1 == 0, torch.ones_like(b1), b2 - b1)
    v = (4 / math.pi ** 2) * (torch.atan((a2 - a1) / ht) - torch.atan((x2 - x1) / hp)) ** 2
    alpha = (v / (1 - iou + v + eps)).detach()
    return 1 - iou + center / diag + alpha * v


def loss(raw: torch.Tensor, labels: torch.Tensor, cfg: dict, job: dict) -> torch.Tensor:
    """YOGO's loss (yogo/yogo_loss.py) of a (B, Sy, Sx, 5+C) head against
    label grids (B, 6, Sy, Sx), summed over cells and divided by B:
    iou_weight * CIoU of the clamped predicted boxes on object cells (boxes
    of zero width or height left out), classify_weight * cross-entropy
    with label smoothing on object cells, and the squared error of the
    objectness, weighted no_obj_weight off objects and 1 on them."""
    d = decode(raw, cfg)
    d = torch.cat([d[..., :5], raw[..., 5:].float()], -1)  # class logits
    b = raw.shape[0]
    mask = labels[:, 0]
    cx, cy, bw, bh = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    p = torch.stack([cx - 0.5 * bw, cy - 0.5 * bh, cx + 0.5 * bw, cy + 0.5 * bh], -1)
    ok = ((p[..., 0] != p[..., 2]) & (p[..., 1] != p[..., 3])).float() * mask
    tgt = labels[:, 1:5].permute(0, 2, 3, 1)
    tgt = torch.where(ok[..., None] > 0, tgt, tgt.new_tensor([0.0, 0.0, 1.0, 1.0]))
    iou_l = job["iou_weight"] * (_ciou(p.clamp(0, 1), tgt) * ok).sum() / b
    logp = F.log_softmax(d[..., 5:], -1)
    eps = job["label_smoothing"]
    nll = -logp.gather(-1, labels[:, 5].long()[..., None])[..., 0]
    ce = (1 - eps) * nll + eps * (-logp.mean(-1))
    cls_l = job["classify_weight"] * (mask * ce).sum() / b
    obj_w = mask * (1 - job["no_obj_weight"]) + job["no_obj_weight"]
    obj_l = (((d[..., 4] - mask) ** 2) * obj_w).sum() / b
    return obj_l + iou_l + cls_l


def lr_at(job: dict, step: int) -> float:
    """The learning rate of optimizer step `step` (0-based): cosine from
    learning_rate to learning_rate / decay_factor over total_steps."""
    t = min(max(step, 0), job["total_steps"])
    frac = 0.5 * (1 + math.cos(math.pi * t / job["total_steps"]))
    a = 1.0 / job["decay_factor"]
    return job["learning_rate"] * ((1 - a) * frac + a)


def train_steps(w0: Dict[str, torch.Tensor], batches, cfg: dict, job: dict, cast: Cast = f32,
                half_batch: bool = False, start: int = 0, moments=None):
    """Steps of training from weights w0: for each (frames uint8 (B, 1,
    H, W), label grids (B, 6, Sy, Sx), step seed) the step's flips and
    dropout masks (step_draws), the forward with batch statistics, the
    loss, its gradient clamped to +-clip_value and AdamW (betas 0.9 /
    0.999, eps 1e-8, decoupled weight decay on every parameter). The
    first batch is optimizer step `start` (0-based), with AdamW's moments
    `moments` ({name: first moment}, {name: second moment}) as they stand
    before it; None: zeros, at step 0. Returns (losses, the first clamped
    gradient, the parameters after each step). half_batch=True is a
    fault: the step takes the first half of each batch only."""
    dev = next(iter(w0.values())).device
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items() if "running" not in k}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    else:
        m = {k: moments[0][k].detach().to(dev, torch.float32).clone() for k in params}
        v2 = {k: moments[1][k].detach().to(dev, torch.float32).clone() for k in params}
    fixed = {k: v for k, v in w0.items() if "running" in k}
    fwd = manifest.family(cfg["family"]).forward
    losses, first_grad, after = [], None, []
    b1, b2, eps = 0.9, 0.999, 1e-8
    with exact():
        for t, (frames, labels, seed) in enumerate(batches, start=start + 1):
            x = torch.as_tensor(frames).to(dev).float()
            y = torch.as_tensor(labels).to(dev).float()
            do_h, do_v, masks = step_draws(seed, cfg, x.shape[0])
            x, y = flips(x, y, do_h, do_v)
            masks = {i: mk.to(dev) for i, mk in masks.items()}
            if half_batch:
                n = x.shape[0] // 2
                x, y, masks = x[:n], y[:n], {i: mk[:n] for i, mk in masks.items()}
            lval = loss(fwd({**params, **fixed}, x, cfg, train=True, masks=masks, cast=cast), y, cfg, job)
            grads = torch.autograd.grad(lval, list(params.values()))
            lr = lr_at(job, t - 1)
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    g = g.clamp(-job["clip_value"], job["clip_value"])
                    if t == start + 1:
                        first_grad = first_grad or {}
                        first_grad[k] = g.clone()
                    p.mul_(1 - lr * job["weight_decay"])
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
            losses.append(float(lval.detach()))
            after.append({k: p.detach().clone() for k, p in params.items()})
    return losses, first_grad, after
