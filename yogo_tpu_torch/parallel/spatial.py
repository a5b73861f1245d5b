"""Row-split inference of the conv stacks over several devices (the port's
counterpart of the JAX package's `--spatial-parallel`: get_mesh_2d and
space_sharded, yogo_tpu/parallel/mesh.py:32-81, with the halo exchanges
XLA's SPMD partitioner inserts into the sharded convs).

Each image's rows are split over N devices, one row shard each:

  - ownership: for every layer, shard k owns the global output rows
    `[lo_k, hi_k)` of an even split of that layer's OUTPUT height (the
    first h % N shards one row more: 386 rows over 4 are 97/97/96/96),
    not of an even split of its input; the input image is split evenly
    (its height must divide by N, `validate_spatial_height`);
  - halo exchange: before a conv (kernel k, stride s, padding p) shard k
    gathers the input rows `[(lo - t)*s, min(H, (hi - 1)*s - p + k))`
    from the shards that own them, copies to its device, where
    t = ceil(p / s) for lo > 0 and 0 for the top shard;
  - the conv runs on that slice with its own symmetric padding, and the
    first t output rows are dropped, with any past hi - lo: the op's zero
    rows then fall only on dropped rows, except at the image's true top
    and bottom, where they are the image's padding. So the stem kernel
    (csrc/stem.cu, which pads row -1 and column -1 only, and wants an even
    height: the slices are [2lo - 2, 2hi) and [0, 2hi)), the int8 conv
    kernel (csrc/int8_conv.cu) and cuDNN's convs all run unchanged on
    every shard, and every kept row is the unsplit conv's;
  - BN (eval), activations, the int8 requant and casts are row-local and
    run per shard on the slice;
  - the head's rows are gathered to the first device, where
    ops/postprocess.py counts and decodes as it does for one device.

The per-block work is the existing code, called per shard:
ConvStack._block, fused_stem_nchw with ConvStack.folded_stem, and the int8
program's quant_block0 / quant_block (ops/quant.py). ConvNeXt-Small is not
split (ROADMAP.md Queue 1 item 15b-4).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from yogo_tpu_torch.models.defns import ConvSpec
from yogo_tpu_torch.models.yogo import YOGO, no_tf32
from yogo_tpu_torch.ops.quant import block0_takes_stem, quant_block, quant_block0
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
    gives those output rows as its rows [t, t + hi - lo)."""
    t = math.ceil(padding / stride) if lo > 0 else 0
    a = (lo - t) * stride
    if a < 0:
        raise ValueError(f"padding {padding} over stride {stride}: no whole-stride window for row {lo}")
    return a, min(h_in, (hi - 1) * stride - padding + kernel), t


def out_height(h: int, spec: ConvSpec) -> int:
    return (h + 2 * spec.padding - spec.kernel) // spec.stride + 1


@dataclass(frozen=True)
class LayerRows:
    """One conv layer over the shards: its input and output heights, the
    rows each shard owns of both, and each shard's window (a, b, t)."""

    h_in: int
    h_out: int
    own_in: Tuple[Rows, ...]
    own_out: Tuple[Rows, ...]
    windows: Tuple[Tuple[int, int, int], ...]


def plan_rows(blocks: Sequence[ConvSpec], h: int, n: int) -> List[LayerRows]:
    """Every layer's ownership and windows for an input of h rows over n
    shards (h must divide by n; a layer's output must give each shard a row)."""
    validate_spatial_height(n, h)
    own = row_split(h, n)
    plan = []
    for i, spec in enumerate(blocks):
        if spec.transpose:
            raise NotImplementedError("row split of a transpose conv (ROADMAP.md Queue 1 item 15b-4)")
        h_out = out_height(h, spec)
        if h_out < n:
            raise ValueError(f"block {i} gives {h_out} rows, fewer than the {n} row shards")
        out = row_split(h_out, n)
        windows = tuple(conv_window(lo, hi, h, spec.kernel, spec.stride, spec.padding) for lo, hi in out)
        plan.append(LayerRows(h, h_out, tuple(own), tuple(out), windows))
        h, own = h_out, out
    return plan


def _row_dim(t: torch.Tensor) -> int:
    """The row axis of an activation: the int8 program's codes are NHWC
    int8, every other activation (uint8 input, f32, bf16) is NCHW."""
    return 1 if t.dtype == torch.int8 else 2


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    """channels_last where t's channels are its innermost axis (an NCHW
    tensor in NHWC memory, even after a row slice), else contiguous."""
    if t.dim() == 4 and t.shape[1] > 1 and t.stride(1) == 1:
        return torch.channels_last
    return torch.contiguous_format


class RowSplit:
    """The forward of one conv-stack model with each image's rows split
    over `devices` (N entries; several may name one device). The weights
    of shard k are passed to each forward as shard_weights[k], a
    (ConvStack, int8 program or None) pair on devices[k].

    Work is issued shard by shard, layer by layer, each op on its shard's
    device, so real cards overlap. A halo row is copied with Tensor.to:
    torch orders a copy between two cards on both cards' current streams
    (the copy waits for the producer's queued work and the consumer's
    stream waits for the copy), so no explicit event is needed; N
    handles to one device run in order on its one stream, and a copy to
    the same device is a view."""

    def __init__(self, model: YOGO, devices: Sequence):
        if model.defn.family != "conv_stack":
            raise NotImplementedError(
                f"--spatial-parallel of the {model.defn.family} family is not "
                "ported yet (ROADMAP.md Queue 1 item 15b-4)"
            )
        self.model = model
        self.devices = [as_device(d) for d in devices]
        self.plan = plan_rows(model.defn.blocks, int(model.img_size[0]), len(self.devices))
        # bytes copied between shards by the last forward (halo rows)
        self.halo_bytes = 0

    def _window(self, parts: List[torch.Tensor], own: Sequence[Rows], a: int, b: int, k: int,
                fmt: Optional[torch.memory_format]) -> torch.Tensor:
        """Shard k's input rows [a, b), gathered from their owners onto its
        device, contiguous in `fmt` (None: the owners' memory format)."""
        dim, dev = _row_dim(parts[0]), self.devices[k]
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
        return win.contiguous(memory_format=fmt or _memory_format(parts[k]))

    def _layer(self, i: int, parts: List[torch.Tensor],
               fn: Callable[[int, torch.Tensor], torch.Tensor],
               fmt: Optional[torch.memory_format] = None) -> List[torch.Tensor]:
        """Layer i over the shards: fn(k, window) on each shard's window
        (contiguous in `fmt`), then the rows it owns."""
        lr = self.plan[i]
        out = []
        for k, ((lo, hi), (a, b, t)) in enumerate(zip(lr.own_out, lr.windows)):
            y = fn(k, self._window(parts, lr.own_in, a, b, k, fmt))
            out.append(y.narrow(_row_dim(y), t, hi - lo))
        return out

    def _scatter(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The input batch (NCHW) split evenly over the shards' devices."""
        return [x.narrow(2, lo, hi - lo).to(d, non_blocking=True)
                for d, (lo, hi) in zip(self.devices, self.plan[0].own_in)]

    def _gather_head(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Every shard's head rows (B, 5+C, rows, Sx) on the first device, as
        the undecoded NHWC head (B, Sy, Sx, 5+C)."""
        dev = self.devices[0]
        return torch.cat([p.to(dev) for p in parts], 2).permute(0, 2, 3, 1)

    def forward_raw(self, shard_weights: Sequence, x: torch.Tensor,
                    record: Optional[list] = None) -> torch.Tensor:
        """(B, C, H, W) batch on the first device -> the undecoded NHWC head
        (B, Sy, Sx, 5+C) on it: the float stack's (YOGO.apply, decode=False)
        or, when the weights carry an int8 program, the int8 program's
        (quantized_forward, decode=False; `record` then receives the codes
        entering each quantized block, as there)."""
        x = YOGO._to_nchw(x)
        self.halo_bytes = 0
        with torch.inference_mode(), no_tf32(x.device):
            if shard_weights[0][1] is not None:
                parts = self._int8(shard_weights, x, record)
            else:
                parts = self._float(shard_weights, x)
            return self._gather_head(parts)

    def _float(self, shard_weights, x: torch.Tensor) -> List[torch.Tensor]:
        model = self.model
        stacks = [s for s, _ in shard_weights]
        # the memory format ConvStack.forward gives the stack's input
        fmt = torch.channels_last if stacks[0].channels_last else torch.contiguous_format
        parts = self._scatter(x)
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
            parts = self._layer(i, parts, lambda k, win, i=i: stacks[k]._block(i, win, False, False, None), fmt)
        return parts

    def _int8(self, shard_weights, x: torch.Tensor, record: Optional[list]) -> List[torch.Tensor]:
        model = self.model
        qps = [qp for _, qp in shard_weights]
        stem = block0_takes_stem(model, qps[0], x)
        parts = self._layer(0, self._scatter(x), lambda k, win: quant_block0(model, qps[k], win, stem=stem))
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
        return parts

    def _gather_codes(self, i: int, codes: List[torch.Tensor]) -> torch.Tensor:
        """The codes entering quantized block i, (B, H, W, Cin), on the first
        device, from each shard's window (overlapping rows are equal)."""
        lr, dev = self.plan[i], self.devices[0]
        b, _, w, c = codes[0].shape
        out = torch.zeros((b, lr.h_in, w, c), dtype=torch.int8, device=dev)
        for q, (a, e, _) in zip(codes, lr.windows):
            out[:, a:e] = q.to(dev)
        return out
