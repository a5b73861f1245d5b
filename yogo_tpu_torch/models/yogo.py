"""YOGO model for PyTorch (port of yogo_tpu/models/yogo.py).

  - `YOGO`: the frozen configuration (image size, anchors, classes,
    multipliers, compute dtype) with `grid`, `resize`, `with_compute_dtype`
    and the functional forward `apply(stack, x, decode=...)`;
  - `ConvStack`: the spec-driven conv backbone as an nn.Module, modules named
    conv{i} / bn{i} like the flax tree (utils/weights.py carries weights
    both ways). `train` / `bn_frozen` are arguments of the forward, as in
    flax, not the module's mode: BN batch statistics with flax's running
    update (biased variance) - over every rank's rows in a process group
    of N > 1 ranks, as flax's BatchNorm under a batch-sharded jit -,
    channel dropout from an explicit generator, and per-block or
    whole-stack activation checkpointing;
  - `ConvNeXtSmall` / `ConvNeXtBlock`: the convnext family (models/yogo.py
    of the JAX package, flax parameter names), its residual stream in
    NHWC float32 whatever the compute dtype, with flax's LayerNorm
    (`layer_norm`);
  - `SwinSmall` / `SwinBlock` / `SwinMerge`: the swin family, which only
    the port has (Swin-S as its padded detection backbone runs it), NHWC
    with a float32 residual stream, window attention through
    scaled_dot_product_attention;
  - `ViTDetBase` / `ViTBlock`: the vitdet family, which only the port has
    (ViTDet's ViT-B backbone and the stride-8 level of its simple feature
    pyramid), NHWC with a float32 residual stream, windowed and global
    attention with decomposed relative positions (`rel_pos_attention`);
    both transformer trunks share `TransformerTrunk`'s forward;
  - `decode_predictions`: the YOLO9000 direct-location decode.

Block 0 of a canonical conv stack runs as the fused CUDA stem kernel
(ops/stem.py) whenever the input is raw uint8, compute is bf16 and the
forward is not a training one - there is no switch to turn it off, unlike
the JAX package's YOGO_PALLAS_STEM.

Parameters stay float32; convs run in the compute dtype (weights cast per
call, as flax's param_dtype/dtype do). A float32 forward on CUDA turns
TF32 off (cuDNN's and cuBLAS's) for its duration, so float32 means float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from yogo_tpu_torch.models.defns import ConvSpec, ModelDefn, get_model_defn
from yogo_tpu_torch.ops.grid import WH_CLAMP, cell_offsets, grid_size
from yogo_tpu_torch.ops.layer_norm import Windows, layer_norm_cuda
from yogo_tpu_torch.ops.stem import STEM_CHANNELS, fold_stem_params, fused_stem_nchw
from yogo_tpu_torch.ops.window_merge import window_merge_cuda
from yogo_tpu_torch.parallel.distributed import all_reduce_sum_autograd, world_size
from yogo_tpu_torch.utils import tracing

LEAKY_SLOPE = 0.01
REMAT_MODES = ("none", "blocks", "full")
LN_EPS = 1e-6
CONVNEXT_DEPTHS = (3, 3, 27, 3)
CONVNEXT_DIMS = (96, 192, 384, 768)
SWIN_DEPTHS = (2, 2, 18, 2)
SWIN_DIMS = (96, 192, 384, 768)
SWIN_HEADS = (3, 6, 12, 24)
SWIN_WINDOW = 7
SWIN_LN_EPS = 1e-5
SWIN_MASK = -100.0  # the shift mask's additive logit between regions
VIT_DIM = 768
VIT_DEPTH = 12
VIT_HEADS = 12
VIT_PATCH = 16
VIT_WINDOW = 14
VIT_GLOBAL_BLOCKS = (2, 5, 8, 11)
VIT_GLOBAL_SIZE = 64  # the published img_size 1024 over the patch: global tables of 2 * 64 - 1 rows
VIT_POS_SIZE = 14  # the position embedding's grid: pretrain_img_size 224 over the patch
VIT_NECK = 256  # the simple feature pyramid's out_channels


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on CUDA unless the caller asks for
    another device; with no GPU and no explicit device they raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _activation(name: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if name is None:
        return x
    if name == "leaky_relu":
        return F.leaky_relu(x, LEAKY_SLOPE)
    if name == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {name}")


def _batch_norm(
    bn: nn.BatchNorm2d, x: torch.Tensor, batch_stats: bool, update_stats: bool
) -> torch.Tensor:
    """BatchNorm as flax's nn.BatchNorm(momentum=0.9) computes it: the
    statistics in float32 whatever x's dtype, the output in x's dtype.

    With batch statistics torch folds the *unbiased* batch variance into
    running_var; flax folds in the *biased* one, the same that normalises.
    torch's update is therefore taken into a zeroed scratch buffer (which
    then holds momentum * unbiased variance) and rescaled by (n-1)/n.
    With running statistics the module's tensors are taken to x's device
    (a row shard's; a no-op on the module's own)."""
    if not batch_stats:
        dev = x.device
        return F.batch_norm(
            x, bn.running_mean.to(dev), bn.running_var.to(dev), bn.weight.to(dev),
            bn.bias.to(dev), False, 0.0, bn.eps,
        )
    if world_size() > 1:
        return _global_batch_norm(bn, x, update_stats)
    n = x.numel() // x.shape[1]
    # a recomputation runs the very same op (activation checkpointing
    # counts the tensors it saves) into buffers that are thrown away
    mean = bn.running_mean if update_stats else bn.running_mean.clone()
    scratch = torch.zeros_like(bn.running_var)
    y = F.batch_norm(x, mean, scratch, bn.weight, bn.bias, True, bn.momentum, bn.eps)
    if update_stats:
        with torch.no_grad():
            bn.running_var.mul_(1.0 - bn.momentum).add_(scratch, alpha=(n - 1) / n)
    return y


def _global_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
    """Batch statistics over every rank's rows, as flax's BatchNorm computes
    them under a batch-sharded jit (XLA inserts the collectives): see
    batch_norm_shards, here with one shard. (nn.SyncBatchNorm runs only on
    a card and folds the unbiased variance.)"""
    return batch_norm_shards(bn, [x], update_stats)[0]


def batch_norm_shards(
    bn: nn.BatchNorm2d, parts: Sequence[torch.Tensor], update_stats: bool
) -> List[torch.Tensor]:
    """BatchNorm with batch statistics over several pieces of one batch
    (the row shards of parallel/spatial.py, on their devices) and over
    every rank's rows: each piece's per-channel sums of x and x^2 (x in
    float32, the sums accumulated in float64) and its element count,
    summed on bn's device (the copies are differentiable), then over the
    ranks by ONE autograd-aware all_reduce, so the backward of the
    statistics crosses the shards and the ranks too; flax's fast variance
    max(E[x^2] - E[x]^2, 0), taken in float64 (in float32 it loses 6e-6
    of the variance to cancellation over a 772x1032 batch of raw frames,
    whose block-0 channels have means 6 standard deviations from 0), then
    float32; each piece normalised on its own device. The global mean and
    the biased global variance are folded into the running statistics
    once, on bn's device, identically on every rank."""
    home = bn.weight.device
    xfs = [x.float() for x in parts]
    c = xfs[0].shape[1]
    total = None
    for xf in xfs:
        local = torch.cat([
            xf.sum((0, 2, 3), dtype=torch.float64),
            (xf * xf).sum((0, 2, 3), dtype=torch.float64),
            xf.new_full((1,), xf.numel() // c, dtype=torch.float64),
        ]).to(home)
        total = local if total is None else total + local
    total = all_reduce_sum_autograd(total)
    n = total[2 * c]
    mean = total[:c] / n
    var = torch.clamp_min(total[c:2 * c] / n - mean * mean, 0.0)
    mean, var = mean.float(), var.float()
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    out = []
    for x, xf in zip(parts, xfs):
        m, k, b = (t.to(x.device)[None, :, None, None] for t in (mean, mul, bn.bias))
        out.append(((xf - m) * k + b).to(x.dtype))
    if update_stats:
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
    return out


class ConvStack(nn.Module):
    """Spec-driven conv backbone (the 11 conv_stack architectures).

    `channels_last` selects the memory format blocks run in; cuDNN's bf16
    convs on Hopper are measured in both (PERF.md) and the faster is the
    default."""

    def __init__(self, blocks: Tuple[ConvSpec, ...], in_channels: int = 1,
                 channels_last: bool = True):
        super().__init__()
        self.blocks = tuple(blocks)
        self.channels_last = channels_last
        c = in_channels
        for i, s in enumerate(self.blocks):
            if s.transpose:
                raise NotImplementedError("transpose-conv blocks are not ported yet")
            self.add_module(
                f"conv{i}",
                nn.Conv2d(c, s.out, s.kernel, s.stride, s.padding, bias=s.bias),
            )
            if s.bn:
                self.add_module(f"bn{i}", nn.BatchNorm2d(s.out, eps=1e-5, momentum=0.1))
            c = s.out

    def forward(
        self,
        x: torch.Tensor,
        start_block: int = 0,
        *,
        train: bool = False,
        bn_frozen: bool = False,
        generator: Optional[torch.Generator] = None,
        remat: str = "none",
        batch_rows: Optional[Tuple[int, int]] = None,
        split=None,
    ) -> torch.Tensor:
        """(B, C, H, W) in the compute dtype -> (B, 5+C, Sy, Sx) head logits.
        start_block > 0 skips blocks the fused stem already computed.

        train=True normalises BN with batch statistics and folds them into
        the running ones, and drops whole channels per sample on the blocks
        whose spec has dropout, with masks drawn from `generator` (on its
        own device; None draws from the global generator of x's device).
        batch_rows=(start, global_batch) draws the masks of a global batch
        and keeps rows [start, start + B): a rank of a data-parallel run
        then drops what one process running the whole batch would.
        bn_frozen=True is the fine-tune BN-freeze: running statistics
        normalise and are never updated while the rest trains.

        remat recomputes activations in the backward pass instead of
        storing them: "blocks" keeps only each block's input, "full" only
        the stack's. The recomputation sees the same dropout masks and does
        not fold the batch statistics in a second time.

        split (a parallel/spatial.RowSplit) runs the blocks with each
        image's rows over its devices, this module's weights taken to each
        shard's device, the BN statistics over every shard's rows and the
        same dropout masks on every shard; the head's rows are gathered on
        the first device. "blocks" then checkpoints one layer over all its
        shards."""
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be none|blocks|full, got {remat!r}")
        fmt = torch.channels_last if self.channels_last else torch.contiguous_format
        x = x.contiguous(memory_format=fmt)
        masks = self._dropout_masks(x, start_block, generator, batch_rows) if train else {}
        batch_stats = train and not bn_frozen

        def run(x, first, last, calls):
            # the first call of a checkpointed segment is the forward; a
            # later one is its recomputation, which must leave the running
            # statistics alone
            update_stats = not calls
            calls.append(None)
            for i in range(first, last):
                if split is None:
                    x = self._block(i, x, batch_stats, update_stats, masks.get(i))
                else:
                    x = split.stack_layer(self, i, x, batch_stats, update_stats, masks.get(i))
            return x

        if split is not None:
            if start_block:
                raise ValueError("a row split runs the stack from block 0")
            x = split.scatter(x)
        n = len(self.blocks)
        if remat == "none" or not torch.is_grad_enabled():
            x = run(x, start_block, n, [])
        else:
            segments = [(start_block, n)] if remat == "full" else [
                (i, i + 1) for i in range(start_block, n)
            ]
            for first, last in segments:
                x = checkpoint(run, x, first, last, [], use_reentrant=False)
        return x if split is None else split.gather(x, 2)

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Block i's conv, its weights in x's dtype on x's device."""
        s = self.blocks[i]
        conv = getattr(self, f"conv{i}")
        bias = conv.bias.to(x.device, x.dtype) if conv.bias is not None else None
        return F.conv2d(x, conv.weight.to(x.device, x.dtype), bias, s.stride, s.padding)

    def _finish(self, i: int, x: torch.Tensor, drop_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Block i's activation and channel dropout, after its BN."""
        x = _activation(self.blocks[i].act, x)
        if drop_mask is not None:
            x = x * drop_mask.to(x.device)
        return x

    def _block(
        self,
        i: int,
        x: torch.Tensor,
        batch_stats: bool,
        update_stats: bool,
        drop_mask: Optional[torch.Tensor],
    ) -> torch.Tensor:
        x = self._conv(i, x)
        if self.blocks[i].bn:
            x = _batch_norm(getattr(self, f"bn{i}"), x, batch_stats, update_stats)
        return self._finish(i, x, drop_mask)

    def _dropout_masks(
        self,
        x: torch.Tensor,
        start_block: int,
        generator: Optional[torch.Generator],
        batch_rows: Optional[Tuple[int, int]] = None,
    ) -> dict:
        """{block: (B, C, 1, 1) mask of 0 or 1/(1-p)} in x's dtype: whole
        channels per sample (Dropout2d), drawn in block order before any
        block runs so that a recomputation reuses them; rows
        [start, start + B) of a global batch's draw with batch_rows."""
        draw_on = x.device if generator is None else generator.device
        b = x.shape[0]
        start, n_rows = batch_rows if batch_rows is not None else (0, b)
        masks = {}
        for i, s in enumerate(self.blocks):
            if i < start_block or s.dropout <= 0:
                continue
            u = torch.rand((n_rows, s.out, 1, 1), generator=generator, device=draw_on)
            u = u[start: start + b]
            keep = (u >= s.dropout).to(torch.float32) / (1.0 - s.dropout)
            masks[i] = keep.to(device=x.device, dtype=x.dtype)
        return masks

    def folded_stem(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block 0's conv + BN folded for the fused stem kernel."""
        conv0, bn0 = self.conv0, self.bn0
        return fold_stem_params(
            conv0.weight, conv0.bias, bn0.weight, bn0.bias,
            bn0.running_mean, bn0.running_var, eps=bn0.eps,
        )


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """flax's nn.LayerNorm over the last axis, in float32 whatever x's
    dtype (flax without `dtype` returns float32 from bf16 input and f32
    parameters): the fast variance max(0, E[x^2] - E[x]^2) and
    (x - mean) * (rsqrt(var + eps) * scale) + bias, as flax orders it.
    F.layer_norm computes the variance another way."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


def _records(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class LayerNorm(nn.Module):
    """Parameters of one LayerNorm over the channels (flax's scale / bias
    are weight / bias). The forward is `layer_norm` with the parameters
    taken to x's device, its float32 output cast to `dtype` when given,
    and, given `windows`, laid out in Swin's windows (swin_window_layout).
    A CUDA input for which no gradient is recorded (inference) takes the
    same arithmetic as one kernel, ops/layer_norm.layer_norm_cuda, which
    writes `dtype` (and the windows) directly; the CPU and autograd take
    the plain chain."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                windows: Optional[Windows] = None) -> torch.Tensor:
        if x.device.type == "cuda" and not _records(x, self.weight, self.bias):
            w, b = (p.to(x.device, torch.float32) for p in (self.weight, self.bias))
            return layer_norm_cuda(x.contiguous(), w, b, self.eps, dtype or torch.float32, windows)
        y = layer_norm(x, self.weight.to(x.device), self.bias.to(x.device), self.eps)
        y = y if dtype is None else y.to(dtype)
        return y if windows is None else swin_window_layout(y, windows)


def _conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Conv(dtype=dtype) on an NHWC tensor: input, kernel and bias
    (where the conv has one) cast to `dtype` (the module's tensors taken to
    x's device), the conv run on the channels_last NCHW view, NHWC out in
    `dtype` (contiguous)."""
    bias = conv.bias.to(x.device, dtype) if conv.bias is not None else None
    y = F.conv2d(
        x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(x.device, dtype), bias,
        conv.stride, conv.padding, conv.dilation, conv.groups,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def _linear(x: torch.Tensor, fc: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype) over the last axis."""
    bias = fc.bias.to(x.device, dtype) if fc.bias is not None else None
    return F.linear(x.to(dtype), fc.weight.to(x.device, dtype), bias)


def format_head(net: nn.Module, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """YOGO's head on a trunk's NHWC output: `net`'s 1x1 format conv and
    stride-4 transpose upsample (both row-local) -> the head's NHWC rows in
    `dtype`."""
    h = _conv_nhwc(h, net.format_conv, dtype).permute(0, 3, 1, 2)
    up = net.format_up
    out = F.conv_transpose2d(h, up.weight.to(h.device, dtype), up.bias.to(h.device, dtype), up.stride)
    return out.permute(0, 2, 3, 1).contiguous()


class ConvNeXtBlock(nn.Module):
    """One ConvNeXt block (yogo_tpu/models/yogo.py ConvNeXtBlock): 7x7
    depthwise conv, LayerNorm, Dense 4x, exact-erf GELU, Dense back, the
    per-channel `gamma` (1e-6 at init) and the residual. NHWC in, NHWC
    float32 out: the LayerNorm's statistics are float32 and its output is
    in the Dense's dtype, so in a bf16 model only the convs and Dense
    layers compute in bf16. `dw` is the one op that reads
    neighbouring rows; `rest` is row-local (a row shard runs `dw` on its
    window, `rest` on its own rows)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def dw(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _conv_nhwc(x, self.dwconv, dtype)

    def rest(self, x: torch.Tensor, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The block's output from its input x and dw(x) at the same rows."""
        h = F.gelu(_linear(self.norm(h, dtype), self.pwconv1, dtype), approximate="none")
        return x + self.gamma.to(x.device) * _linear(h, self.pwconv2, dtype)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.rest(x, self.dw(x, dtype), dtype)


class ConvNeXtLayers:
    """The layer steps of a ConvNeXt-Small forward, on NHWC activations:
    the module in `dtype` (ConvNeXtSmall) or, with the same names, the
    int8 program (ops/quant_convnext.py). Steps that read neighbouring
    rows take a window of rows (`stem_conv`, `down_conv`, `dw`); the rest
    are row-local. `run_convnext` composes them over the whole image,
    parallel/spatial.RowSplit over row shards."""

    def __init__(self, net: "ConvNeXtSmall", dtype: torch.dtype):
        self.net, self.dtype = net, dtype

    def stem_conv(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW input rows -> the patchify conv's NHWC rows."""
        return _conv_nhwc(x.permute(0, 2, 3, 1), self.net.stem_conv, self.dtype)

    def stem_norm(self, h: torch.Tensor) -> torch.Tensor:
        return self.net.stem_norm(h)

    def down_in(self, s: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self.net, f"down{s}_norm")(h, self.dtype)

    def down_conv(self, s: int, h: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(h, getattr(self.net, f"down{s}_conv"), self.dtype)

    def dw(self, s: int, b: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self.net, f"stage{s}_block{b}").dw(h, self.dtype)

    def rest(self, s: int, b: int, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return getattr(self.net, f"stage{s}_block{b}").rest(x, h, self.dtype)

    def block(self, s: int, b: int, x: torch.Tensor) -> torch.Tensor:
        return self.rest(s, b, x, self.dw(s, b, x))

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The 1x1 format conv and the stride-4 transpose upsample (both
        row-local) -> the head's NHWC rows in the compute dtype."""
        return format_head(self.net, h, self.dtype)


def run_convnext(layers, x: torch.Tensor, depths: Sequence[int], remat: str = "none") -> torch.Tensor:
    """A ConvNeXt-Small forward over the whole image from its layer steps
    (ConvNeXtLayers or the int8 program's): NCHW x -> the NHWC head.
    remat="blocks" checkpoints each block."""
    h = layers.stem_norm(layers.stem_conv(x))
    for s, depth in enumerate(depths):
        if s > 0:
            h = layers.down_conv(s, layers.down_in(s, h))
        for b in range(depth):
            if remat == "blocks":
                h = checkpoint(layers.block, s, b, h, use_reentrant=False)
            else:
                h = layers.block(s, b, h)
    return layers.head(h)


class ConvNeXtSmall(nn.Module):
    """ConvNeXt-Small trunk + YOGO format head (yogo_tpu/models/yogo.py
    ConvNeXtSmall; reference: yogo/model_defns.py:533-558, through timm):
    a 4x4 stride-4 patchify stem + LayerNorm, four stages of ConvNeXt
    blocks with a LayerNorm + 2x2 stride-2 conv between them, a 1x1 conv to
    5+C and a 4x4 stride-4 transpose conv. Module names follow the flax
    tree (utils/weights.py maps them one to one). The compute dtype is the
    input's: YOGO.apply casts the input to it.

    There is no BatchNorm and no dropout: `train`, `bn_frozen`,
    `generator` and `batch_rows` are accepted and change nothing, as in
    flax. remat="blocks" checkpoints each ConvNeXtBlock, "full" the whole
    forward. (In the JAX
    package "blocks" saves the activations named `yogo_block`, which this
    family does not name, so there it recomputes as much as "full";
    recomputation changes memory, never values.) `split` (a
    parallel/spatial.RowSplit) runs it with each image's rows over the
    split's devices; "blocks" then checkpoints a block over its shards."""

    def __init__(self, num_outputs: int, in_channels: int = 1,
                 depths: Tuple[int, ...] = CONVNEXT_DEPTHS,
                 dims: Tuple[int, ...] = CONVNEXT_DIMS):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.stem_conv = nn.Conv2d(in_channels, dims[0], 4, stride=4)
        self.stem_norm = LayerNorm(dims[0])
        for s, (depth, dim) in enumerate(zip(self.depths, self.dims)):
            if s > 0:
                self.add_module(f"down{s}_norm", LayerNorm(dims[s - 1]))
                self.add_module(f"down{s}_conv", nn.Conv2d(dims[s - 1], dim, 2, stride=2))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", ConvNeXtBlock(dim))
        self.format_conv = nn.Conv2d(dims[-1], num_outputs, 1)
        self.format_up = nn.ConvTranspose2d(num_outputs, num_outputs, 4, stride=4)

    def forward(
        self,
        x: torch.Tensor,
        start_block: int = 0,
        *,
        train: bool = False,
        bn_frozen: bool = False,
        generator: Optional[torch.Generator] = None,
        remat: str = "none",
        batch_rows: Optional[Tuple[int, int]] = None,
        split=None,
    ) -> torch.Tensor:
        """(B, C, H, W) in the compute dtype -> (B, 5+C, Sy, Sx) head
        logits in the compute dtype (a channels_last view)."""
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be none|blocks|full, got {remat!r}")
        if start_block:
            raise ValueError("the convnext family has no fused stem to start after")
        del train, bn_frozen, generator  # no BN, no dropout
        recompute = remat != "none" and torch.is_grad_enabled()
        if recompute and remat == "full":
            return checkpoint(self._forward, x, "none", split, use_reentrant=False)
        return self._forward(x, "blocks" if recompute else "none", split)

    def _forward(self, x: torch.Tensor, remat: str, split=None) -> torch.Tensor:
        layers = ConvNeXtLayers(self, x.dtype)
        if split is None:
            out = run_convnext(layers, x, self.depths, remat)
        else:
            out = split.convnext([layers] * len(split.devices), x, remat)
        return out.permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=16)
def swin_relative_index(window: int, device: torch.device) -> torch.Tensor:
    """(w*w, w*w) int64 on `device`: row i, column j is the entry of a
    (2w-1)^2-row relative-bias table that query token i reads for key
    token j of a window (tokens row-major), as Swin builds it: the offsets
    (dy, dx) shifted to start at 0, dy * (2w-1) + dx. Made once a window
    size and device, outside inference mode."""
    with torch.inference_mode(False):
        ar = torch.arange(window)
        coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij")).flatten(1)  # (2, w*w)
        rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
        return (rel[0] * (2 * window - 1) + rel[1]).to(device)


def swin_relative_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """(heads, w*w, w*w) float32: each head's bias between a window's
    query and key tokens, gathered from its column of `table`
    ((2w-1)^2, heads) by swin_relative_index."""
    idx = swin_relative_index(window, table.device)
    return table[idx.flatten()].view(*idx.shape, -1).permute(2, 0, 1)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, Hp, Wp, C), Hp and Wp multiples of `window` -> (B, w*w, nW, C):
    token t of window n (t row-major in the window, n row-major over the
    map's windows). Token-major, so that a projection's (B, w*w, nW,
    heads * d) output is attention's (batch, sequence, nW * heads, d)
    layout as it is."""
    b, hp, wp, c = x.shape
    x = x.view(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, window * window, -1, c)


def window_reverse(x: torch.Tensor, window: int, hp: int, wp: int) -> torch.Tensor:
    """The inverse of window_partition: (B, w*w, nW, C) -> (B, Hp, Wp, C)."""
    b, _, _, c = x.shape
    x = x.view(b, window, window, hp // window, wp // window, c)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, hp, wp, c)


def swin_window_layout(t: torch.Tensor, windows: Windows) -> torch.Tensor:
    """A (B, H, W, C) map in Swin's windows: zero-padded to (Hp, Wp),
    rolled by -shift along both axes where shift > 0, window_partition'ed:
    (B, w*w, nW, C)."""
    hp, wp, win, shift = windows
    t = F.pad(t, (0, 0, 0, wp - t.shape[2], 0, hp - t.shape[1]))
    if shift:
        t = torch.roll(t, (-shift, -shift), (1, 2))
    return window_partition(t, win)


def swin_merge_windows(x: torch.Tensor, t: torch.Tensor, windows: Windows) -> torch.Tensor:
    """x (B, H, W, C) plus the map that t, its (B, w*w, nW, C) windows,
    holds: window_reverse'd, rolled back by +shift, cropped to (H, W)."""
    hp, wp, win, shift = windows
    t = window_reverse(t, win, hp, wp)
    if shift:
        t = torch.roll(t, (shift, shift), (1, 2))
    return x + t[:, :x.shape[1], :x.shape[2]]


def swin_shift_mask(hp: int, wp: int, window: int, shift: int, device) -> torch.Tensor:
    """(nW, w*w, w*w) float32 of 0 and SWIN_MASK: the shifted windows'
    mask over a padded (Hp, Wp) map, as Swin builds it. The map rolled by
    -shift is cut into three regions along each axis (up to -window,
    -window to -shift, the last `shift`), numbered 0-8; a query and a key
    of different regions get SWIN_MASK."""
    region = torch.zeros(1, hp, wp, 1)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    n = 0
    for rows in cuts:
        for cols in cuts:
            region[:, rows, cols] = n
            n += 1
    r = window_partition(region, window)[0, :, :, 0].T  # (nW, w*w)
    diff = r[:, None, :] - r[:, :, None]
    return torch.where(diff != 0, SWIN_MASK, 0.0).to(device)


@contextlib.contextmanager
def fused_attention(device: torch.device):
    """On CUDA, scaled_dot_product_attention limited to its fused backends
    (memory-efficient, cuDNN): where neither takes the call it raises,
    rather than falling back to the math backend, which writes the whole
    (B, heads, L, L) logits to memory. Elsewhere torch chooses."""
    if device.type != "cuda":
        yield
        return
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]):
        yield


class MadeFrom:
    """Tensors made from a module's parameters (a bias, resampled tables),
    one a key (device, dtype, map size), kept until a parameter changes
    (load_state_dict, an optimizer step: its storage or its version) and
    made outside inference mode, so that a training forward may use them
    too. A forward that records gradients makes them anew."""

    def __init__(self):
        self.version, self.made = None, {}

    def get(self, params: Sequence[torch.Tensor], key: tuple, make) -> object:
        if _records(*params):
            return make()
        version = tuple((p.data_ptr(), p._version) for p in params)
        if self.version != version:
            self.version, self.made = version, {}
        if key not in self.made:
            with torch.inference_mode(False), torch.no_grad():
                self.made[key] = make()
        return self.made[key]


def attention_inputs(t: torch.Tensor, qkv: nn.Linear, heads: int, dtype: torch.dtype):
    """(q, k, v), each (B, G * heads, L, d), of tokens t (B, L, G, C) laid
    out token-major in G groups (windows, or one whole map): three Denses
    in `dtype`, the q, k and v rows of the one qkv kernel, whose outputs
    are attention's layout without a copy."""
    b, n, g, c = t.shape
    wq, bq = qkv.weight.to(t.device, dtype), qkv.bias.to(t.device, dtype)
    return tuple(F.linear(t, wq[i * c:(i + 1) * c], bq[i * c:(i + 1) * c])
                 .view(b, n, g * heads, c // heads).transpose(1, 2) for i in range(3))


def merge_windows_add(x: torch.Tensor, t: torch.Tensor, windows: Windows) -> torch.Tensor:
    """x plus the map that its windows t hold (swin_merge_windows): one
    kernel, window_merge_cuda, for a CUDA input for which no gradient is
    recorded (the LayerNorm kernel's own condition); the plain layout on
    the CPU and under autograd."""
    if x.device.type == "cuda" and not _records(x, t):
        return window_merge_cuda(x, t, windows)
    return swin_merge_windows(x, t, windows)


class SwinBlock(nn.Module):
    """One Swin Transformer block on an NHWC float32 map (residual stream),
    as the padded detection backbone runs it
    (Swin-Transformer-Object-Detection, mmdet/models/backbones/
    swin_transformer.py SwinTransformerBlock): LayerNorm, zero padding to
    a multiple of the window, the cyclic shift (roll by -shift) where
    `shift` > 0, windows of w*w tokens, window attention with the
    relative bias (and the shift mask), the projection, the reverse
    layout, the crop and the residual; then LayerNorm, MLP (Dense 4x,
    exact GELU, Dense back) and the residual. The Denses compute in the
    forward's dtype.

    The layout has no pass of its own on the card: where the LayerNorms
    take their kernel (a CUDA input, no gradient recorded), the first one
    stores straight into the windows (ops/layer_norm.layer_norm_cuda with
    `windows`) and one kernel (ops/window_merge.window_merge_cuda) adds
    the projected windows back into the residual map; the CPU and autograd
    run the same steps as torch ops (swin_window_layout, swin_merge_windows).

    The bias plus the mask of each padded map size is one additive tensor
    in the compute dtype, (1, nW * heads, w*w, w*w), broadcast over the
    batch; it is made once a device, dtype and map size, and made again
    when the table changes (load_state_dict), except in a forward that
    records gradients, which makes it anew."""

    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.attn_norm = LayerNorm(dim, SWIN_LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.mlp_norm = LayerNorm(dim, SWIN_LN_EPS)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self._bias = MadeFrom()

    def attn_bias(self, hp: int, wp: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        """(1, nW * heads, w*w, w*w) in `dtype`: the relative bias plus,
        where the block shifts, the shift mask of a padded (Hp, Wp) map.
        Its rows are padded to a multiple of 8 elements and sliced back,
        so that the fused kernels read it in place (the memory-efficient
        one would copy a tensor whose row stride is not a multiple of 8)."""
        return self._bias.get((self.rel_bias,), (device, dtype, hp, wp),
                              lambda: self._make_bias(hp, wp, dtype, device))

    def _make_bias(self, hp: int, wp: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        w2 = self.window * self.window
        bias = swin_relative_bias(self.rel_bias.to(device), self.window)[None]  # (1, heads, w2, w2)
        if self.shift:
            bias = bias + swin_shift_mask(hp, wp, self.window, self.shift, device)[:, None]
        else:
            bias = bias.expand((hp // self.window) * (wp // self.window), -1, -1, -1)
        out = torch.zeros(1, bias.shape[0] * self.heads, w2, -(-w2 // 8) * 8, dtype=dtype, device=device)
        out[..., :w2] = bias.reshape(1, -1, w2, w2)
        return out[..., :w2]

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, h, w, c = x.shape
        win, shift, heads = self.window, self.shift, self.heads
        hp, wp = -(-h // win) * win, -(-w // win) * win
        n_win = (hp // win) * (wp // win)
        tracing.add(swin_windows=b * n_win * heads, swin_pad_tokens=b * (hp * wp - h * w))
        windows = Windows(hp, wp, win, shift)
        with tracing.span("swin/layout", x.device):
            t = self.attn_norm(x, dtype, windows)  # (B, w*w, nW, C)
        q, k, v = attention_inputs(t, self.qkv, heads, dtype)
        bias = self.attn_bias(hp, wp, dtype, x.device)
        with tracing.span("swin/attn", x.device):
            t = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=(c // heads) ** -0.5)
        t = _linear(t.transpose(1, 2).reshape(b, win * win, n_win, c), self.proj, dtype)
        with tracing.span("swin/layout", x.device):
            x = merge_windows_add(x, t, windows)
        y = F.gelu(_linear(self.mlp_norm(x, dtype), self.fc1, dtype), approximate="none")
        return x + _linear(y, self.fc2, dtype)


class SwinMerge(nn.Module):
    """Swin's patch merging, as the detection backbone runs it: an odd
    height or width padded by one zero row or column, each 2x2 patch's
    four tokens concatenated (x0 x1 x2 x3: (0,0), (1,0), (0,1), (1,1)),
    LayerNorm over 4C and a Dense without bias to 2C, in `dtype`; the
    output goes back to the float32 residual stream."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, SWIN_LN_EPS)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return _linear(self.norm(x, dtype), self.reduction, dtype).float()


class TransformerTrunk(nn.Module):
    """The forward that the transformer trunks (SwinSmall, ViTDetBase)
    share. Like ConvNeXtSmall they have no BatchNorm and no dropout:
    `train`, `bn_frozen`, `generator` and `batch_rows` change nothing.
    remat="blocks" checkpoints each block, "full" the whole forward. A
    forward takes the whole input at once: no fused stem to start after
    (`start_block`), no row split (`split`); each refusal names the
    `family`. A subclass gives `_forward(x, remat)`."""

    family = ""

    def forward(
        self,
        x: torch.Tensor,
        start_block: int = 0,
        *,
        train: bool = False,
        bn_frozen: bool = False,
        generator: Optional[torch.Generator] = None,
        remat: str = "none",
        batch_rows: Optional[Tuple[int, int]] = None,
        split=None,
    ) -> torch.Tensor:
        """(B, C, H, W) in the compute dtype -> (B, 5+C, Sy, Sx) head
        logits in the compute dtype (a channels_last view)."""
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be none|blocks|full, got {remat!r}")
        if start_block:
            raise ValueError(f"the {self.family} family has no fused stem to start after")
        if split is not None:
            raise NotImplementedError(f"no row split for the {self.family} family")
        del train, bn_frozen, generator, batch_rows  # no BN, no dropout
        recompute = remat != "none" and torch.is_grad_enabled()
        if recompute and remat == "full":
            return checkpoint(self._forward, x, "none", use_reentrant=False)
        return self._forward(x, "blocks" if recompute else "none")


class SwinSmall(TransformerTrunk):
    """Swin-S trunk + YOGO format head (Liu et al. 2021, arXiv:2103.14030;
    timm's swin_small_patch4_window7_224 for the widths, the padded
    detection backbone of Swin-Transformer-Object-Detection for the
    layout): a 4x4 stride-4 patch embedding + LayerNorm, four stages of
    SwinBlocks (every second one shifted by window // 2) with a SwinMerge
    between them, a final LayerNorm, then YOGO's 1x1 conv to 5+C and 4x4
    stride-4 transpose conv. NHWC throughout, the residual stream float32,
    the convs and Denses in the input's dtype (YOGO.apply casts the input
    to the compute dtype); LayerNorms as `layer_norm`, eps 1e-5.

    Departures from the published code, none of which changes the
    arithmetic at sides that are multiples of 4:
      - the patch embedding crops a side that is not a multiple of 4 (the
        grid arithmetic's floor) where the published code pads it;
      - qkv runs as three Denses (q, k, v: rows of the one qkv kernel) on
        token-major windows (window_partition), whose outputs are
        attention's layout without a copy;
      - attention is F.scaled_dot_product_attention with the relative bias
        and the shift mask as one additive tensor in the compute dtype
        (in a bf16 forward the bias is rounded to bf16); on CUDA only its
        fused backends run (fused_attention);
      - the relative-bias tensor is a block's own (each block has its
        table) and is kept between forwards (SwinBlock.attn_bias);
      - on the card the window layout lives in the kernels around it: the
        attention LayerNorm's kernel stores into the shifted, padded
        windows, and one kernel merges the projected windows back into the
        residual add (SwinBlock); the CPU and autograd pad, roll and
        partition as the published code does;
      - no stochastic depth or dropout (the published rates act in
        training only), no absolute position embedding (off in Swin-S).

    The forward's arguments are TransformerTrunk's. The spans
    "swin/layout" (the attention LayerNorm into the windows; the windows
    merged back into the residual add) and "swin/attn" (the attention) and
    the counters `swin_windows` and `swin_pad_tokens` are
    utils/tracing.py's."""

    family = "swin"

    def __init__(self, num_outputs: int, in_channels: int = 1,
                 depths: Tuple[int, ...] = SWIN_DEPTHS,
                 dims: Tuple[int, ...] = SWIN_DIMS,
                 heads: Tuple[int, ...] = SWIN_HEADS):
        super().__init__()
        self.depths, self.dims, self.heads = tuple(depths), tuple(dims), tuple(heads)
        self.stem_conv = nn.Conv2d(in_channels, dims[0], 4, stride=4)
        self.stem_norm = LayerNorm(dims[0], SWIN_LN_EPS)
        for s, (depth, dim) in enumerate(zip(self.depths, self.dims)):
            if s > 0:
                self.add_module(f"merge{s}", SwinMerge(dims[s - 1], dim))
            for b in range(depth):
                shift = SWIN_WINDOW // 2 if b % 2 else 0
                self.add_module(f"stage{s}_block{b}", SwinBlock(dim, heads[s], SWIN_WINDOW, shift))
        self.final_norm = LayerNorm(dims[-1], SWIN_LN_EPS)
        self.format_conv = nn.Conv2d(dims[-1], num_outputs, 1)
        self.format_up = nn.ConvTranspose2d(num_outputs, num_outputs, 4, stride=4)

    def _forward(self, x: torch.Tensor, remat: str) -> torch.Tensor:
        dtype = x.dtype
        with fused_attention(x.device):
            h = self.stem_norm(_conv_nhwc(x.permute(0, 2, 3, 1), self.stem_conv, dtype))
            for s, depth in enumerate(self.depths):
                if s > 0:
                    h = getattr(self, f"merge{s}")(h, dtype)
                for b in range(depth):
                    block = getattr(self, f"stage{s}_block{b}")
                    h = checkpoint(block, h, dtype, use_reentrant=False) if remat == "blocks" else block(h, dtype)
            out = format_head(self, self.final_norm(h, dtype), dtype)
        return out.permute(0, 3, 1, 2)


def vit_rel_pos(table: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size, d): ViTDet's get_rel_pos (detectron2 vit.py) for
    queries and keys along one side of `size` tokens: the (n, d) table
    resampled linearly (align_corners False) to 2 * size - 1 rows where it
    has another length, then row i - j + size - 1 for query i, key j."""
    rows = 2 * size - 1
    if table.shape[0] != rows:
        table = F.interpolate(table.t()[None], size=rows, mode="linear")[0].t()
    idx = torch.arange(size, device=table.device)
    return table[idx[:, None] - idx[None, :] + size - 1]


def vit_abs_pos(pos_embed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(1, h, w, C): ViTDet's get_abs_pos: the (1, 1 + n*n, C) embedding
    without its class token, its n x n grid resampled bicubically
    (align_corners False) to h x w where it has another size."""
    grid = pos_embed[:, 1:]
    n = math.isqrt(grid.shape[1])
    if n * n != grid.shape[1]:
        raise ValueError(f"a position embedding of {grid.shape[1]} positions is no square grid")
    grid = grid.reshape(1, n, n, -1)
    if (n, n) == (h, w):
        return grid
    return F.interpolate(grid.permute(0, 3, 1, 2), size=(h, w), mode="bicubic",
                         align_corners=False).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=16)
def vit_key_columns(sh: int, sw: int, d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(sh * sw, P) in `dtype` on `device`: the columns that widen the key
    of token j of an sh x sw map (row-major) for rel_pos_attention: a one
    in column j // sw (its row) and in column sh + j % sw (its column),
    zeros after them, so that d + P, the widened width, is d + sh + sw up
    to a multiple of 8 (the fused kernels' alignment). Made once a
    geometry and device, outside inference mode."""
    p = -(-(d + sh + sw) // 8) * 8 - d
    with torch.inference_mode(False):
        j = torch.arange(sh * sw)
        out = torch.zeros(sh * sw, p, dtype=dtype)
        out[j, j // sw] = 1
        out[j, sh + j % sw] = 1
        return out.to(device)


def rel_pos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor,
                      rel_w: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention with ViTDet's decomposed relative positions
    (add_decomposed_rel_pos) that never holds the (B, S, L, L) bias: q, k,
    v (B, S, L, d) over the L tokens of an sh x sw map (row-major), rel_h
    (sh, sh, d) and rel_w (sw, sw, d) the block's tables (vit_rel_pos).
    The query is widened to [q * scale, q . rel_h, q . rel_w, 0] and the
    key to [k, vit_key_columns]: their dot product is scale * q . k +
    q . rel_h[qh(i), kh(j)] + q . rel_w[qw(i), kw(j)], the published
    logit (the bias from the unscaled q) with the bias rounded to q's
    dtype, and one scaled_dot_product_attention at scale 1 attends over
    them, v as it is. -> (B, S, L, d)."""
    b, s, n, d = q.shape
    sh, sw = rel_h.shape[0], rel_w.shape[0]
    keys = vit_key_columns(sh, sw, d, q.dtype, q.device)
    r = q.reshape(b, s, sh, sw, d)
    qh = torch.einsum("bshwc,hkc->bshwk", r, rel_h).reshape(b, s, n, sh)
    qw = torch.einsum("bshwc,wkc->bshwk", r, rel_w).reshape(b, s, n, sw)
    pad = q.new_zeros(1, 1, 1, keys.shape[1] - sh - sw).expand(b, s, n, -1)
    q = torch.cat([q * scale, qh, qw, pad], -1)
    k = torch.cat([k, keys.expand(b, s, n, -1)], -1)
    return F.scaled_dot_product_attention(q, k, v, scale=1.0)


class ViTBlock(nn.Module):
    """One ViTDet block (detectron2 vit.py Block with use_rel_pos) on an
    NHWC float32 map (residual stream): LayerNorm, attention with
    decomposed relative positions over the windows of the map padded to
    whole windows (`window` > 0) or over the whole map (`window` 0, a
    global block), the projection, the residual; then LayerNorm, MLP
    (Dense 4x, exact GELU, Dense back) and the residual. The Denses
    compute in the forward's dtype, LayerNorms as `layer_norm`, eps 1e-6.
    `rel_size` sizes the tables rel_pos_h / rel_pos_w, (2 * rel_size - 1,
    head dim): the window, or the published global map (1024 / 16).

    A window block carries its layout as SwinBlock does (shift 0): on the
    card the attention LayerNorm's kernel stores straight into the
    windows, padded slots 0 as the published pad after the norm, and one
    kernel adds the projected windows back into the residual; the CPU and
    autograd pad, partition, reverse and crop as torch ops. The tables
    resampled and gathered for a map size (vit_rel_pos) are kept between
    forwards (MadeFrom). Spans: "vit/layout" around the windowed store and
    the merge-add, "vit/win_attn" or "vit/global_attn" around
    rel_pos_attention; counters vit_windows, vit_pad_tokens,
    vit_global_tokens (utils/tracing.py)."""

    def __init__(self, dim: int, heads: int, window: int, rel_size: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.attn_norm = LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_size - 1, dim // heads))
        self.proj = nn.Linear(dim, dim)
        self.mlp_norm = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self._tables = MadeFrom()

    def rel_pos(self, sh: int, sw: int, dtype: torch.dtype, device: torch.device):
        """(rel_h (sh, sh, d), rel_w (sw, sw, d)) in `dtype`: the tables
        for an sh x sw map of queries and keys."""
        return self._tables.get(
            (self.rel_pos_h, self.rel_pos_w), (device, dtype, sh, sw),
            lambda: (vit_rel_pos(self.rel_pos_h.to(device), sh).to(dtype),
                     vit_rel_pos(self.rel_pos_w.to(device), sw).to(dtype)))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, h, w, c = x.shape
        win, heads = self.window, self.heads
        if win:
            hp, wp = -(-h // win) * win, -(-w // win) * win
            windows = Windows(hp, wp, win, 0)
            tracing.add(vit_windows=b * hp * wp // (win * win), vit_pad_tokens=b * (hp * wp - h * w))
            with tracing.span("vit/layout", x.device):
                t = self.attn_norm(x, dtype, windows)  # (B, w*w, nW, C)
            side, name = (win, win), "vit/win_attn"
        else:
            tracing.add(vit_global_tokens=b * h * w)
            t = self.attn_norm(x, dtype).view(b, h * w, 1, c)
            side, name = (h, w), "vit/global_attn"
        n, groups = t.shape[1], t.shape[2]
        q, k, v = attention_inputs(t, self.qkv, heads, dtype)
        rel_h, rel_w = self.rel_pos(*side, dtype, x.device)
        with tracing.span(name, x.device):
            t = rel_pos_attention(q, k, v, rel_h, rel_w, (c // heads) ** -0.5)
        t = _linear(t.transpose(1, 2).reshape(b, n, groups, c), self.proj, dtype)
        if win:
            with tracing.span("vit/layout", x.device):
                x = merge_windows_add(x, t, windows)
        else:
            x = x + t.view(b, h, w, c)
        y = F.gelu(_linear(self.mlp_norm(x, dtype), self.fc1, dtype), approximate="none")
        return x + _linear(y, self.fc2, dtype)


class ViTDetBase(TransformerTrunk):
    """ViTDet's ViT-B backbone + its simple feature pyramid's stride-8
    level + YOGO's 1x1 format conv (Li et al. 2022, arXiv:2203.16527;
    detectron2 projects/ViTDet mask_rcnn_vitdet_b_100ep.py, with the
    backbone of detectron2/modeling/backbone/vit.py): a 16x16 stride-16
    patch embedding plus the absolute position embedding (1 + 14x14
    positions, resampled bicubically to the map), 12 ViTBlocks of width
    768 and 12 heads, windowed (14x14) but for the global blocks 2, 5, 8
    and 11, every block with decomposed relative positions; no final norm;
    then a 2x2 stride-2 transpose conv 768 -> 384, a 1x1 conv to 256
    without bias + LayerNorm, a 3x3 conv 256 -> 256 without bias +
    LayerNorm, and the 1x1 conv to 5+C. NHWC throughout, the residual
    stream float32, the convs and Denses in the input's dtype (YOGO.apply
    casts the input to the compute dtype); the forward's arguments are
    TransformerTrunk's. At 772x1032: a 49x65 map of 3,185 tokens, 20
    windows of the 56x70 padded map, the head on a (Sy, Sx) = (98, 130)
    grid.

    Departures from the published code:
      - one input channel (grayscale frames), where the published takes 3;
      - the frame is zero-padded bottom and right to a multiple of 16 (as
        detectron2's ImageList pads to its size_divisibility), where the
        COCO pipeline pads it square to 1024;
      - of the simple feature pyramid only the stride-8 level, whose map
        is YOGO's grid;
      - no drop path (it acts in training only);
      - the resampled position embedding and relative-position tables are
        kept between forwards (MadeFrom), where the published resamples
        them every forward;
      - attention widens q and k (rel_pos_attention) where the published
        adds a dense (B * heads, L, L) bias: the same logits, with the
        bias rounded to the compute dtype; on CUDA only the fused
        backends of scaled_dot_product_attention run (fused_attention);
      - the window blocks' layout lives in the kernels around the
        attention on the card (ViTBlock), as Swin's does."""

    family = "vitdet"

    def __init__(self, num_outputs: int, in_channels: int = 1, dim: int = VIT_DIM, depth: int = VIT_DEPTH,
                 heads: int = VIT_HEADS, window: int = VIT_WINDOW,
                 global_blocks: Tuple[int, ...] = VIT_GLOBAL_BLOCKS, global_size: int = VIT_GLOBAL_SIZE,
                 pos_size: int = VIT_POS_SIZE, neck: int = VIT_NECK):
        super().__init__()
        self.depth = depth
        self.stem_conv = nn.Conv2d(in_channels, dim, VIT_PATCH, stride=VIT_PATCH)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_size * pos_size, dim))
        for i in range(depth):
            glob = i in global_blocks
            self.add_module(f"block{i}", ViTBlock(dim, heads, 0 if glob else window,
                                                  global_size if glob else window))
        self.neck_up = nn.ConvTranspose2d(dim, dim // 2, 2, stride=2)
        self.lateral_conv = nn.Conv2d(dim // 2, neck, 1, bias=False)
        self.lateral_norm = LayerNorm(neck)
        self.output_conv = nn.Conv2d(neck, neck, 3, padding=1, bias=False)
        self.output_norm = LayerNorm(neck)
        self.format_conv = nn.Conv2d(neck, num_outputs, 1)
        self._pos = MadeFrom()

    def abs_pos(self, h: int, w: int, device: torch.device) -> torch.Tensor:
        """(1, h, w, C) float32: the position embedding of an h x w map."""
        return self._pos.get((self.pos_embed,), (device, h, w),
                             lambda: vit_abs_pos(self.pos_embed.to(device), h, w))

    def _forward(self, x: torch.Tensor, remat: str) -> torch.Tensor:
        dtype = x.dtype
        x = F.pad(x, (0, -x.shape[3] % VIT_PATCH, 0, -x.shape[2] % VIT_PATCH))
        with fused_attention(x.device):
            h = _conv_nhwc(x.permute(0, 2, 3, 1), self.stem_conv, dtype)
            h = h + self.abs_pos(h.shape[1], h.shape[2], x.device)  # float32 from here
            for i in range(self.depth):
                block = getattr(self, f"block{i}")
                h = checkpoint(block, h, dtype, use_reentrant=False) if remat == "blocks" else block(h, dtype)
            up = self.neck_up
            u = F.conv_transpose2d(h.permute(0, 3, 1, 2).to(dtype), up.weight.to(h.device, dtype),
                                   up.bias.to(h.device, dtype), up.stride)
            u = self.lateral_norm(_conv_nhwc(u.permute(0, 2, 3, 1), self.lateral_conv, dtype), dtype)
            u = self.output_norm(_conv_nhwc(u, self.output_conv, dtype), dtype)
            out = _conv_nhwc(u, self.format_conv, dtype)
        return out.permute(0, 3, 1, 2)


# the trunk module of each family but the conv stack (YOGO.module)
TRUNKS = {"convnext": ConvNeXtSmall, "swin": SwinSmall, "vitdet": ViTDetBase}


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init, lecun_normal: a normal truncated at
    +-2 standard deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def decode_predictions(
    raw: torch.Tensor,
    cxs: torch.Tensor,
    cys: torch.Tensor,
    anchor_w: float,
    anchor_h: float,
    width_multiplier: float = 1.0,
    height_multiplier: float = 1.0,
    inference: bool = False,
) -> torch.Tensor:
    """YOLO9000 direct-location decode (reference: yogo/model.py:277-313).

    raw: (B, Sy, Sx, 5+C) NHWC head output. Returns (B, Sy, Sx, 5+C) f32:
    [xc, yc, w, h, objectness, *classes]; classes stay logits unless
    `inference`, then softmax."""
    return decode_rows(
        raw, cxs, cys, raw.shape[2], raw.shape[1], anchor_w, anchor_h,
        width_multiplier, height_multiplier, inference,
    )


@functools.lru_cache(maxsize=32)
def cell_offset_tensors(sx: int, sy: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (Sy, Sx) cell_offsets tables as f32 tensors on `device`, made
    once per grid and device: copying them from pageable host memory at
    every decode would make the host wait for all the work queued before
    it on the device (a pageable upload synchronizes its stream), which
    stops a dispatch from running ahead of the one before. Made outside
    inference mode, so a training forward may use them too."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device) for t in cell_offsets(sx, sy))


def decode_rows(
    raw: torch.Tensor,
    cxs: torch.Tensor,
    cys: torch.Tensor,
    sx: int,
    sy: int,
    anchor_w: float,
    anchor_h: float,
    width_multiplier: float = 1.0,
    height_multiplier: float = 1.0,
    inference: bool = False,
) -> torch.Tensor:
    """The decode of decode_predictions on rows of any leading shape:
    raw (..., 5+C) with its cells' offsets cxs / cys shaped like raw[..., 0],
    on a grid of sx by sy cells. The candidate paths decode the rows they
    select with it, so their values are the full decode's, bit for bit."""
    raw = raw.float()
    tx, ty, tw, th, to = (raw[..., i] for i in range(5))
    cls = raw[..., 5:]
    xc = torch.sigmoid(tx) * (1.0 / sx) + cxs
    yc = torch.sigmoid(ty) * (1.0 / sy) + cys
    w = anchor_w * torch.exp(torch.clamp(tw, max=WH_CLAMP)) * width_multiplier
    h = anchor_h * torch.exp(torch.clamp(th, max=WH_CLAMP)) * height_multiplier
    obj = torch.sigmoid(to)
    if inference:
        cls = torch.softmax(cls, dim=-1)
    return torch.cat([torch.stack([xc, yc, w, h, obj], dim=-1), cls], dim=-1)


_tf32_lock = threading.Lock()
_tf32_holders = 0  # threads inside no_tf32 on a CUDA device
_tf32_saved = (True, False)  # cuDNN's, cuBLAS's


@contextlib.contextmanager
def no_tf32(device: torch.device):
    """cuDNN runs float32 convs in TF32 by default on Ampere and later
    (cuBLAS's float32 matmuls only if asked to); the float32 path turns
    both off for its duration. A training step holds it around forward AND
    backward: the flags are read when each kernel is chosen, the gradient
    convs' included. The flags are global, so holders are counted: they
    stay off while any thread holds them (a server's dispatch and a
    reload's calibration at once) and come back when the last one leaves."""
    global _tf32_holders, _tf32_saved
    if device.type != "cuda":
        yield
        return
    with _tf32_lock:
        if _tf32_holders == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_holders += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_holders -= 1
            if _tf32_holders == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved


@dataclass(frozen=True)
class YOGO:
    """Static model configuration + functional forward (mirrors
    yogo_tpu.models.yogo.YOGO; the weights live in the module of the
    architecture's family, a ConvStack or a trunk of TRUNKS)."""

    img_size: Tuple[int, int]  # (H, W)
    anchor_w: float
    anchor_h: float
    num_classes: int
    is_rgb: bool = False
    normalize_images: bool = False
    clip_value: float = 1.0
    model_version: str = "base_model"
    height_multiplier: float = 1.0
    width_multiplier: float = 1.0
    compute_dtype: torch.dtype = torch.float32

    @property
    def defn(self) -> ModelDefn:
        return get_model_defn(self.model_version)(self.num_classes, self.is_rgb)

    @property
    def input_channels(self) -> int:
        return 3 if self.is_rgb else 1

    @property
    def grid(self) -> Tuple[int, int]:
        """(Sx, Sy) for the current img_size."""
        h, w = self.img_size
        return grid_size(self.defn.blocks, h, w)

    @property
    def Sx(self) -> int:
        return self.grid[0]

    @property
    def Sy(self) -> int:
        return self.grid[1]

    def module(self, device=None, channels_last: bool = True) -> nn.Module:
        """The module of this architecture's family (a ConvStack, or the
        family's trunk in TRUNKS) in eval mode on `device` (default CUDA),
        with torch's default init; load weights with
        load_state_dict(state_dict_from_flax(variables)), or start from
        `init`. Whether a forward trains is an argument of `apply`, not the
        module's mode. `channels_last` picks a conv stack's memory format;
        the trunks always run NHWC."""
        defn = self.defn
        device = resolve_device(device)
        if defn.family in TRUNKS:
            return TRUNKS[defn.family](5 + self.num_classes, self.input_channels).to(device).eval()
        if defn.family != "conv_stack":
            raise NotImplementedError(f"{defn.family} models are not ported")
        stack = ConvStack(defn.blocks, self.input_channels, channels_last)
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        return stack.to(device=device, memory_format=fmt).eval()

    # ------------------------------------------------------------- param init
    def init(
        self,
        generator: Optional[torch.Generator] = None,
        device=None,
        channels_last: bool = True,
    ) -> nn.Module:
        """A freshly initialised module on `device` (default CUDA), as
        yogo_tpu's YOGO.init. A conv stack: conv kernels Kaiming-normal in
        fan-out mode with the LeakyReLU(0.01) gain (reference:
        yogo/model.py:79-87), zero biases, BN scale 1 / bias 0, running mean
        0 / var 1. ConvNeXt: flax's defaults, lecun_normal kernels (fan-in,
        truncated normal), zero biases, LayerNorm scale 1 / bias 0, `gamma`
        1e-6. The transformer trunks: Dense kernels normal with std 0.02
        (truncated at +-2), zero biases, LayerNorm 1 / 0, their convs
        (patch embedding, neck, head) as ConvNeXt's; Swin's relative-bias
        tables as its Dense kernels (timm's), ViTDet's position embedding
        too and its relative-position tables zero (detectron2's
        rel_pos_zero_init). The values are drawn on the CPU from
        `generator` (a CPU generator; None uses torch's global one), so a
        seed gives the same weights on any device."""
        device = resolve_device(device)
        stack = self.module("cpu", channels_last)
        with torch.no_grad():
            if isinstance(stack, ConvNeXtSmall):
                for m in stack.modules():
                    if isinstance(m, (nn.Conv2d, nn.Linear)):
                        _lecun_normal_(m.weight, m.weight[0].numel(), generator)
                        m.bias.zero_()
                    elif isinstance(m, nn.ConvTranspose2d):  # (I, O, kh, kw)
                        _lecun_normal_(m.weight, m.weight.numel() // m.weight.shape[1], generator)
                        m.bias.zero_()
                return stack.to(device)
            if isinstance(stack, TransformerTrunk):
                for m in stack.modules():
                    if isinstance(m, nn.Linear):
                        nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                        if m.bias is not None:
                            m.bias.zero_()
                    elif isinstance(m, SwinBlock):
                        nn.init.trunc_normal_(m.rel_bias, std=0.02, generator=generator)
                    elif isinstance(m, ViTDetBase):
                        nn.init.trunc_normal_(m.pos_embed, std=0.02, generator=generator)
                    elif isinstance(m, nn.Conv2d):
                        _lecun_normal_(m.weight, m.weight[0].numel(), generator)
                        if m.bias is not None:
                            m.bias.zero_()
                    elif isinstance(m, nn.ConvTranspose2d):
                        _lecun_normal_(m.weight, m.weight.numel() // m.weight.shape[1], generator)
                        m.bias.zero_()
                return stack.to(device)
            for m in stack.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.kaiming_normal_(
                        m.weight, a=LEAKY_SLOPE, mode="fan_out",
                        nonlinearity="leaky_relu", generator=generator,
                    )
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()  # scale 1, bias 0, mean 0, var 1
        return stack.to(device)

    @staticmethod
    def num_params(stack: nn.Module) -> int:
        return sum(p.numel() for p in stack.parameters())

    @staticmethod
    def param_norm(tensors: Iterable[torch.Tensor]) -> float:
        """Global L2 norm of an iterable of tensors, e.g. stack.parameters()
        (reference: yogo/model.py:171-181)."""
        return float(torch.sqrt(sum(t.detach().float().pow(2).sum() for t in tensors)))

    @staticmethod
    def grad_norm(stack: nn.Module) -> float:
        """Global L2 norm of the gradients held by the stack's parameters
        (reference: yogo/model.py:157-169)."""
        return YOGO.param_norm(p.grad for p in stack.parameters() if p.grad is not None)

    # ------------------------------------------------------- fused stem gate
    def stem_kernel_eligible(
        self, stack: nn.Module, x: torch.Tensor, train: bool = False
    ) -> bool:
        """Whether block 0 runs as the fused stem kernel for this forward
        (the eligibility rules of yogo_tpu YOGO._stem_pallas_mode): not a
        training forward (the kernel has no backward, and BN is folded into
        its weights), a conv stack whose block 0 is the canonical 1->C
        conv3x3 s2 p1 without bias + BN + LeakyReLU and no dropout, bf16
        compute, raw uint8 input, even H and W, and C a width the kernel is
        built for."""
        if train or stack.training or self.compute_dtype != torch.bfloat16:
            return False
        return self.stem_kernel_takes(x)

    def stem_kernel_takes(self, x: torch.Tensor) -> bool:
        """Whether the fused stem kernel computes block 0 of this
        architecture on input x: the canonical block 0 (see
        stem_kernel_eligible), raw uint8 input, even H and W. The int8
        program asks this alone: its block 0 is bf16 whatever the compute
        dtype."""
        if self.defn.family != "conv_stack" or self.input_channels != 1:
            return False
        b0 = self.defn.blocks[0]
        if not (
            b0.kernel == 3
            and b0.stride == 2
            and b0.padding == 1
            and not b0.bias
            and b0.bn
            and b0.act == "leaky_relu"
            and not b0.transpose
            and b0.dropout == 0
            and b0.out in STEM_CHANNELS
        ):
            return False
        if x.dtype != torch.uint8:
            return False
        h, w = x.shape[-2:]
        return h % 2 == 0 and w % 2 == 0

    # ---------------------------------------------------------------- forward
    @staticmethod
    def _to_nchw(x: torch.Tensor) -> torch.Tensor:
        """Accept (B, C, H, W), (C, H, W) or (H, W), uint8 or float."""
        if x.dim() == 2:
            return x[None, None]
        if x.dim() == 3:
            return x[None]
        return x

    def apply(
        self,
        stack: nn.Module,
        x: torch.Tensor,
        *,
        train: bool = False,
        tuning: bool = False,
        inference: bool = False,
        decode: bool = True,
        generator: Optional[torch.Generator] = None,
        remat: str = "none",
        batch_rows: Optional[Tuple[int, int]] = None,
        split=None,
    ) -> torch.Tensor:
        """Raw input -> decoded (B, 5+C, Sy, Sx) predictions, or with
        decode=False the undecoded NHWC head (B, Sy, Sx, 5+C) in the compute
        dtype (the input of ops.postprocess.format_preds_batched_raw;
        `inference` is then ignored).

        train=False runs without autograd (torch.inference_mode). train=True
        builds the graph: BN batch statistics are used and folded into the
        stack's running statistics in place (flax returns them as a new
        state; here the module holds them), channel dropout draws from
        `generator` (rows `batch_rows` of a global batch's masks), and
        `remat` checkpoints activations (see ConvStack.forward and
        ConvNeXtSmall). tuning=True freezes BN: it
        normalises with the running statistics and never updates them, in
        either mode (reference: yogo/model.py:67-70). ConvNeXt and Swin
        have neither BN nor dropout. `split` (a parallel/spatial.RowSplit over this
        model) runs the module with each image's rows over its devices,
        from x on the first; the fused stem kernel is then not taken (the
        row-split inference of infer / serve is RowSplit.forward_raw)."""
        x = self._to_nchw(x)
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(no_tf32(x.device))
            if not train:
                ctx.enter_context(torch.inference_mode())
            if split is None and self.stem_kernel_eligible(stack, x, train):
                w9, b9 = stack.folded_stem()
                layout = "nhwc" if stack.channels_last else "nchw"
                h = fused_stem_nchw(x[:, 0].contiguous(), w9, b9, layout=layout)
                out = stack(h, start_block=1)
            else:
                if not x.is_floating_point():
                    x = x.float()
                out = stack(
                    x.to(self.compute_dtype), train=train, bn_frozen=tuning,
                    generator=generator, remat=remat, batch_rows=batch_rows, split=split,
                )
            raw = out.permute(0, 2, 3, 1)  # NHWC head
            if not decode:
                return raw
            return self._decode_raw(raw, inference)

    def _decode_raw(self, raw: torch.Tensor, inference: bool) -> torch.Tensor:
        """NHWC head logits -> decoded (B, 5+C, Sy, Sx) predictions."""
        sx, sy = self.grid
        cxs, cys = cell_offset_tensors(sx, sy, raw.device)
        out = decode_predictions(
            raw, cxs, cys, self.anchor_w, self.anchor_h,
            self.width_multiplier, self.height_multiplier, inference=inference,
        )
        return out.permute(0, 3, 1, 2)

    # ----------------------------------------------------------------- resize
    def resize(
        self, img_height: Optional[int] = None, img_width: Optional[int] = None
    ) -> "YOGO":
        """Fully-convolutional crop-resize (reference: yogo/model.py:236-265):
        a new config whose multipliers rescale predicted w/h back to
        original-image fractions."""
        org_h = self.img_size[0] * self.height_multiplier
        org_w = self.img_size[1] * self.width_multiplier
        new_h = int(img_height or self.img_size[0])
        new_w = int(img_width or self.img_size[1])
        return dataclasses.replace(
            self,
            img_size=(new_h, new_w),
            height_multiplier=float(org_h / new_h),
            width_multiplier=float(org_w / new_w),
        )

    def with_compute_dtype(self, dtype: torch.dtype) -> "YOGO":
        return dataclasses.replace(self, compute_dtype=dtype)

    @classmethod
    def from_pth(cls, pth_path, inference: bool = False):
        """Load a reference-format .pth (or native .ckpt) checkpoint ->
        (model config, flax-layout variables, meta), as the reference
        classmethod (reference: yogo/model.py:94-147). `inference` is
        accepted for its signature only: here it is an argument of apply."""
        del inference
        from yogo_tpu_torch.utils.checkpoint import load_any

        return load_any(pth_path)

    @classmethod
    def create(cls, img_size: Tuple[int, int], anchor_w: float, anchor_h: float,
               num_classes: int, **kwargs) -> "YOGO":
        return cls(
            img_size=(int(img_size[0]), int(img_size[1])),
            anchor_w=float(anchor_w),
            anchor_h=float(anchor_h),
            num_classes=int(num_classes),
            **kwargs,
        )
