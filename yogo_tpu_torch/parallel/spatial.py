"""Row-split forwards over several devices (the port's counterpart of the
JAX package's `--spatial-parallel`: get_mesh_2d and space_sharded,
yogo_tpu/parallel/mesh.py:32-81, with the halo exchanges XLA's SPMD
partitioner inserts into the sharded convs), for inference and training,
for the conv stacks and ConvNeXt-Small.

Each image's rows are split over N devices, one row shard each:

  - ownership: for every layer, shard k owns the global output rows
    `[lo_k, hi_k)` of an even split of that layer's OUTPUT height (the
    first h % N shards one row more: 386 rows over 4 are 97/97/96/96),
    not of an even split of its input; the input image is split evenly
    (its height must divide by N, `validate_spatial_height`). A transpose
    conv whose kernel equals its stride (ConvNeXt's 4x4 s4 upsample) maps
    input rows [lo, hi) to output rows [s*lo, s*hi): it keeps its input's
    ownership, scaled;
  - halo exchange: before a conv (kernel k, stride s, padding p) shard k
    gathers the input rows `[(lo - t)*s, min(H, (hi - 1)*s - p + k))`
    from the shards that own them, copies to its device, where
    t = min(ceil(p / s), lo) (0 for the top shard);
  - the conv runs on that slice with its own symmetric padding, and the
    first t output rows are dropped, with any past hi - lo: the op's zero
    rows then fall only on dropped rows, except at the image's true top
    and bottom, where they are the image's padding. So the stem kernel
    (csrc/stem.cu, which pads row -1 and column -1 only, and wants an even
    height: the slices are [2lo - 2, 2hi) and [0, 2hi)), the int8 conv
    kernel (csrc/int8_conv.cu) and cuDNN's convs all run unchanged on
    every shard, and every kept row is the unsplit conv's;
  - everything after a conv is row-local and runs per shard on the rows
    it owns: BN with running statistics, activations, dropout (the same
    (B, C, 1, 1) masks on every shard), LayerNorm, GELU, the Dense layers,
    ConvNeXt's gamma and residual, the int8 requant and casts. BN with
    batch statistics (training) sums each shard's f32 sums of x and x^2 on
    the first device and over the ranks (models/yogo.batch_norm_shards);
  - the head's rows are gathered to the first device, where the loss,
    ops/postprocess.py's count and decode run as for one device.

Copies between shards (Tensor.to, narrow, cat) are differentiable: in a
training step each halo row's gradient flows back to the shard that owns
it, and each parameter, taken to every shard's device from the one module
on the first (models/yogo.py moves a module's tensors to its input's
device), gets the sum of the shards' gradients there. Inference
(`forward_raw`) takes each shard's weights from shard_weights[k] instead,
copies made once (parallel/mesh.replicate).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from yogo_tpu_torch.models.defns import ConvSpec
from yogo_tpu_torch.models.yogo import CONVNEXT_DEPTHS, YOGO, ConvNeXtLayers, batch_norm_shards, no_tf32
from yogo_tpu_torch.ops.quant import block0_takes_stem, quant_block, quant_block0
from yogo_tpu_torch.ops.quant_convnext import QuantLayers
from yogo_tpu_torch.ops.stem import fused_stem_nchw
from yogo_tpu_torch.parallel.mesh import as_device, validate_spatial_height

Rows = Tuple[int, int]


def row_split(h: int, n: int) -> List[Rows]:
    """[lo, hi) of each of n shards over h rows, the first h % n shards
    one row more."""
    base, extra = divmod(h, n)
    out, lo = [], 0
    for k in range(n):
        hi = lo + base + (k < extra)
        out.append((lo, hi))
        lo = hi
    return out


def conv_window(lo: int, hi: int, h_in: int, kernel: int, stride: int, padding: int) -> Tuple[int, int, int]:
    """(a, b, t) for the output rows [lo, hi) of a conv over h_in input
    rows: the conv of input rows [a, b) with its own symmetric padding
    gives those output rows as its rows [t, t + hi - lo). t is
    ceil(padding / stride), or lo where that would start the window above
    the image (a shard whose first rows read the image's top padding,
    e.g. a 7x7 p3 conv's shard from row 2: its window starts at row 0)."""
    t = min(math.ceil(padding / stride), lo)
    return (lo - t) * stride, min(h_in, (hi - 1) * stride - padding + kernel), t


def out_height(h: int, spec: ConvSpec) -> int:
    if spec.transpose:
        return (h - 1) * spec.stride - 2 * spec.padding + spec.kernel + spec.output_padding
    return (h + 2 * spec.padding - spec.kernel) // spec.stride + 1


def convnext_layers(depths: Sequence[int] = CONVNEXT_DEPTHS) -> Tuple[ConvSpec, ...]:
    """The row geometry of ConvNeXt-Small's layers in forward order
    (models/yogo.ConvNeXtSmall): the 4x4 s4 patchify; for each stage its
    2x2 s2 downsample (after the first) and one 7x7 p3 depthwise conv a
    block; the 1x1 format conv; the 4x4 s4 transpose upsample. Only the
    kernel, stride, padding and transpose fields are read."""
    layers = [ConvSpec(0, kernel=4, stride=4, padding=0)]
    for s, depth in enumerate(depths):
        if s > 0:
            layers.append(ConvSpec(0, kernel=2, stride=2, padding=0))
        layers += [ConvSpec(0, kernel=7, stride=1, padding=3)] * depth
    layers += [ConvSpec(0, kernel=1, padding=0), ConvSpec(0, kernel=4, stride=4, padding=0, transpose=True)]
    return tuple(layers)


def layer_specs(model: YOGO) -> Tuple[ConvSpec, ...]:
    """The layers a row split plans for: a conv stack's blocks, or
    ConvNeXt-Small's convnext_layers."""
    family = model.defn.family
    if family == "conv_stack":
        return model.defn.blocks
    if family == "convnext":
        return convnext_layers()
    raise NotImplementedError(f"no row split for the {family} family")


@dataclass(frozen=True)
class LayerRows:
    """One conv layer over the shards: its input and output heights, the
    rows each shard owns of both, and each shard's window (a, b, t)."""

    h_in: int
    h_out: int
    own_in: Tuple[Rows, ...]
    own_out: Tuple[Rows, ...]
    windows: Tuple[Tuple[int, int, int], ...]


def plan_rows(layers: Sequence[ConvSpec], h: int, n: int) -> List[LayerRows]:
    """Every layer's ownership and windows for an input of h rows over n
    shards (h must divide by n; a layer's output must give each shard a row)."""
    validate_spatial_height(n, h)
    own = row_split(h, n)
    plan = []
    for i, spec in enumerate(layers):
        h_out = out_height(h, spec)
        if spec.transpose:
            if spec.kernel != spec.stride or spec.padding or spec.output_padding:
                raise NotImplementedError(
                    f"layer {i}: row split of a transpose conv whose kernel ({spec.kernel}) is not "
                    f"its stride ({spec.stride}) or that pads (its output rows would overlap)"
                )
            out = [(spec.stride * lo, spec.stride * hi) for lo, hi in own]
            windows = tuple((lo, hi, 0) for lo, hi in own)
        else:
            if h_out < n:
                raise ValueError(f"layer {i} gives {h_out} rows, fewer than the {n} row shards")
            out = row_split(h_out, n)
            windows = tuple(conv_window(lo, hi, h, spec.kernel, spec.stride, spec.padding) for lo, hi in out)
        plan.append(LayerRows(h, h_out, tuple(own), tuple(out), windows))
        h, own = h_out, out
    return plan


def _row_dim(t: torch.Tensor) -> int:
    """The row axis of a conv stack's activation: the int8 program's codes
    are NHWC int8, every other activation (uint8 input, f32, bf16) is
    NCHW. (ConvNeXt's activations are NHWC: its steps name the axis.)"""
    return 1 if t.dtype == torch.int8 else 2


def _dense_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """t made dense with its axes in `like`'s memory order (an NCHW tensor
    in NHWC memory stays so; an NHWC view of NCHW memory too): the ops of
    a shard then see the memory layout the unsplit forward's see, and
    round as they do. An axis of size 1 has no stride of its own (a
    frame's channel axis may carry 0): it keeps its place before the next
    axis that has a size."""

    def key(d):
        e = d
        while e < like.dim() and like.shape[e] == 1:
            e += 1
        return -(like.stride(e) if e < like.dim() else 0), d

    order = sorted(range(like.dim()), key=key)
    inverse = sorted(range(len(order)), key=order.__getitem__)
    return t.permute(order).contiguous().permute(inverse)


class RowSplit:
    """The forward of one model (a conv stack or ConvNeXt-Small) with each
    image's rows split over `devices` (N entries; several may name one
    device).

    Work is issued shard by shard, layer by layer, each op on its shard's
    device, so real cards overlap. A halo row is copied with Tensor.to:
    torch orders a copy between two cards on both cards' current streams
    (the copy waits for the producer's queued work and the consumer's
    stream waits for the copy), so no explicit event is needed; N
    handles to one device run in order on its one stream, and a copy to
    the same device is a view.

    Training (and the trainer's validation) passes the split to the
    module's forward (YOGO.apply(..., split=rows)), which calls
    `stack_layer` or `convnext` with its own weights; `forward_raw` is the
    inference forward over per-shard weights."""

    def __init__(self, model: YOGO, devices: Sequence):
        self.model = model
        self.devices = [as_device(d) for d in devices]
        self.plan = plan_rows(layer_specs(model), int(model.img_size[0]), len(self.devices))
        # bytes copied between shards by the last forward (halo rows; a
        # checkpointed layer's recomputation copies them again)
        self.halo_bytes = 0

    def _window(self, parts: List[torch.Tensor], own: Sequence[Rows], a: int, b: int, k: int,
                fmt: Optional[torch.memory_format], dim: int) -> torch.Tensor:
        """Shard k's input rows [a, b) (along `dim`), gathered from their
        owners onto its device, contiguous in `fmt` (None: dense in the
        owners' memory order)."""
        dev = self.devices[k]
        pieces = []
        for j, (lo, hi) in enumerate(own):
            s, e = max(a, lo), min(b, hi)
            if s >= e:
                continue
            piece = parts[j].narrow(dim, s - lo, e - s)
            if j != k:
                self.halo_bytes += piece.numel() * piece.element_size()
            pieces.append(piece.to(dev, non_blocking=True))
        win = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)
        return win.contiguous(memory_format=fmt) if fmt is not None else _dense_like(win, parts[k])

    def _layer(self, i: int, parts: List[torch.Tensor],
               fn: Callable[[int, torch.Tensor], torch.Tensor],
               fmt: Optional[torch.memory_format] = None, dim: Optional[int] = None,
               out_dim: Optional[int] = None) -> List[torch.Tensor]:
        """Layer i over the shards: fn(k, window) on each shard's window
        (rows along `dim`, default _row_dim; contiguous in `fmt`), then the
        rows it owns (along `out_dim`, default `dim`)."""
        lr = self.plan[i]
        out_dim = dim if out_dim is None else out_dim
        out = []
        for k, ((lo, hi), (a, b, t)) in enumerate(zip(lr.own_out, lr.windows)):
            win = self._window(parts, lr.own_in, a, b, k, fmt, _row_dim(parts[0]) if dim is None else dim)
            y = fn(k, win)
            out.append(y.narrow(_row_dim(y) if out_dim is None else out_dim, t, hi - lo))
        return out

    def scatter(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The input batch (NCHW) split evenly over the shards' devices
        (differentiably). Starts a forward: the halo count restarts."""
        self.halo_bytes = 0
        return [x.narrow(2, lo, hi - lo).to(d, non_blocking=True)
                for d, (lo, hi) in zip(self.devices, self.plan[0].own_in)]

    def gather(self, parts: List[torch.Tensor], dim: int) -> torch.Tensor:
        """Every shard's rows (along `dim`) on the first device, in order."""
        dev = self.devices[0]
        return torch.cat([p.to(dev) for p in parts], dim)

    # ----------------------------------------------------------- conv stacks
    def stack_layer(self, stack, i: int, parts: List[torch.Tensor], batch_stats: bool,
                    update_stats: bool, drop_mask: Optional[torch.Tensor]) -> List[torch.Tensor]:
        """Block i of a conv stack (ConvStack.forward's step) over the
        shards, every shard with `stack`'s weights. With batch statistics:
        the conv on each shard's window, then BN over every shard's owned
        rows (and every rank's), folded into `stack`'s running ones once
        when update_stats, then activation and dropout on the owned rows.
        Otherwise the whole block runs on each window."""
        return self._stack_layer([stack] * len(self.devices), i, parts, batch_stats, update_stats, drop_mask)

    def _stack_layer(self, stacks, i, parts, batch_stats, update_stats, drop_mask):
        fmt = torch.channels_last if stacks[0].channels_last else torch.contiguous_format
        if not (batch_stats and stacks[0].blocks[i].bn):
            # all that follows the conv is row-local: the whole block on
            # each window (dense, so BN and the activation run as unsplit),
            # then the rows the shard owns
            return self._layer(i, parts, lambda k, win: stacks[k]._block(i, win, False, False, drop_mask), fmt)
        ys = self._layer(i, parts, lambda k, win: stacks[k]._conv(i, win), fmt)
        ys = batch_norm_shards(getattr(stacks[0], f"bn{i}"), ys, update_stats)
        return [s._finish(i, y, drop_mask) for s, y in zip(stacks, ys)]

    # ----------------------------------------------------------- ConvNeXt
    def convnext(self, layers: Sequence, x: torch.Tensor, remat: str = "none") -> torch.Tensor:
        """ConvNeXt-Small over the shards (models/yogo.run_convnext's
        order): layers[k] are shard k's steps (ConvNeXtLayers of a module,
        or the int8 program's QuantLayers), x the NCHW batch on the first
        device -> the NHWC head on it. The patchify, the downsamples and
        the depthwise convs run on windows; LayerNorm, the block's Dense
        layers, GELU, gamma and the residual on each shard's own rows; the
        format conv and the transpose upsample (row-local) on its own rows,
        whose head rows are gathered. remat="blocks" checkpoints each
        block over its shards."""
        parts = self._layer(0, self.scatter(x), lambda k, win: layers[k].stem_conv(win), dim=2, out_dim=1)
        parts = [f.stem_norm(p) for f, p in zip(layers, parts)]
        i = 1
        for s, depth in enumerate(CONVNEXT_DEPTHS):
            if s > 0:
                parts = [f.down_in(s, p) for f, p in zip(layers, parts)]
                parts = self._layer(i, parts, lambda k, win, s=s: layers[k].down_conv(s, win), dim=1)
                i += 1
            for b in range(depth):
                if remat == "blocks":
                    parts = checkpoint(self._convnext_block, layers, i, s, b, parts, use_reentrant=False)
                else:
                    parts = self._convnext_block(layers, i, s, b, parts)
                i += 1
        return self.gather([f.head(p) for f, p in zip(layers, parts)], 1)

    def _convnext_block(self, layers, i: int, s: int, b: int, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Block b of stage s (plan layer i) over the shards: the 7x7
        depthwise conv on each window, the rest on the shard's own rows."""
        dws = self._layer(i, parts, lambda k, win: layers[k].dw(s, b, win), dim=1)
        return [f.rest(s, b, p, d) for f, p, d in zip(layers, parts, dws)]

    # ------------------------------------------------------------- inference
    def forward_raw(self, shard_weights: Sequence, x: torch.Tensor,
                    record: Optional[list] = None) -> torch.Tensor:
        """(B, C, H, W) batch on the first device -> the undecoded NHWC head
        (B, Sy, Sx, 5+C) on it, inference only. shard_weights[k] is shard
        k's (module, int8 program or None) pair on devices[k]. The float
        module's head (YOGO.apply, decode=False) or, when the weights carry
        an int8 program, the int8 program's (the family's quantized
        forward, decode=False; `record` then receives the codes entering
        each int8 conv, as there)."""
        x = YOGO._to_nchw(x)
        with torch.inference_mode(), no_tf32(x.device):
            if shard_weights[0][1] is not None:
                return self._int8(shard_weights, x, record)
            return self._float(shard_weights, x)

    def _float(self, shard_weights, x: torch.Tensor) -> torch.Tensor:
        model = self.model
        stacks = [s for s, _ in shard_weights]
        if model.defn.family == "convnext":
            xf = (x if x.is_floating_point() else x.float()).to(model.compute_dtype)
            return self.convnext([ConvNeXtLayers(s, model.compute_dtype) for s in stacks], xf)
        parts = self.scatter(x)
        first = 0
        if model.stem_kernel_eligible(stacks[0], x):
            layout = "nhwc" if stacks[0].channels_last else "nchw"
            folded = {}
            for k, stack in enumerate(stacks):
                if id(stack) not in folded:
                    folded[id(stack)] = stack.folded_stem()

            def stem(k, win):
                w9, b9 = folded[id(stacks[k])]
                return fused_stem_nchw(win[:, 0].contiguous(), w9, b9, layout=layout)

            parts = self._layer(0, parts, stem)
            first = 1
        else:
            parts = [(p if p.is_floating_point() else p.float()).to(model.compute_dtype) for p in parts]
        for i in range(first, len(model.defn.blocks)):
            parts = self._stack_layer(stacks, i, parts, False, False, None)
        return self.gather(parts, 2).permute(0, 2, 3, 1)

    def _int8(self, shard_weights, x: torch.Tensor, record: Optional[list]) -> torch.Tensor:
        model = self.model
        qps = [qp for _, qp in shard_weights]
        if model.defn.family == "convnext":
            recs = [[] if record is not None else None for _ in qps]
            head = self.convnext([QuantLayers(qp, rec) for qp, rec in zip(qps, recs)], x.float())
            if record is not None:
                # each shard requantizes the rows it owns: a site's codes
                # are its shards' in row order
                record.extend(self.gather(list(codes), 1) for codes in zip(*recs))
            return head
        stem = block0_takes_stem(model, qps[0], x)
        parts = self._layer(0, self.scatter(x), lambda k, win: quant_block0(model, qps[k], win, stem=stem))
        for j in range(len(qps[0]["blocks"])):
            codes = [] if record is not None else None

            def block(k, win, j=j, codes=codes):
                rec = [] if codes is not None else None
                y = quant_block(model, qps[k], j, win, rec)
                if rec:
                    codes.append(rec[0])
                return y

            parts = self._layer(1 + j, parts, block)
            if codes:
                record.append(self._gather_codes(1 + j, codes))
        return self.gather(parts, 2).permute(0, 2, 3, 1)

    def _gather_codes(self, i: int, codes: List[torch.Tensor]) -> torch.Tensor:
        """The codes entering quantized block i, (B, H, W, Cin), on the first
        device, from each shard's window (overlapping rows are equal)."""
        lr, dev = self.plan[i], self.devices[0]
        b, _, w, c = codes[0].shape
        out = torch.zeros((b, lr.h_in, w, c), dtype=torch.int8, device=dev)
        for q, (a, e, _) in zip(codes, lr.windows):
            out[:, a:e] = q.to(dev)
        return out
