"""YOGO model for PyTorch (port of yogo_tpu/models/yogo.py).

  - `YOGO`: the frozen configuration (image size, anchors, classes,
    multipliers, compute dtype) with `grid`, `resize`, `with_compute_dtype`
    and the functional forward `apply(stack, x, decode=...)`;
  - `ConvStack`: the spec-driven conv backbone as an nn.Module, modules named
    conv{i} / bn{i} like the flax tree (utils/weights.py carries weights
    both ways). `train` / `bn_frozen` are arguments of the forward, as in
    flax, not the module's mode: BN batch statistics with flax's running
    update (biased variance), channel dropout from an explicit generator,
    and per-block or whole-stack activation checkpointing;
  - `decode_predictions`: the YOLO9000 direct-location decode.

Block 0 of a canonical conv stack runs as the fused CUDA stem kernel
(ops/stem.py) whenever the input is raw uint8, compute is bf16 and the
forward is not a training one - there is no switch to turn it off, unlike
the JAX package's YOGO_PALLAS_STEM.

Parameters stay float32; convs run in the compute dtype (weights cast per
call, as flax's param_dtype/dtype do). A float32 forward on CUDA turns
cuDNN's TF32 off for its duration, so float32 means float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from yogo_tpu_torch.models.defns import ConvSpec, ModelDefn, get_model_defn
from yogo_tpu_torch.ops.grid import WH_CLAMP, cell_offsets, grid_size
from yogo_tpu_torch.ops.stem import STEM_CHANNELS, fold_stem_params, fused_stem_nchw

LEAKY_SLOPE = 0.01
REMAT_MODES = ("none", "blocks", "full")


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
    then holds momentum * unbiased variance) and rescaled by (n-1)/n."""
    if not batch_stats:
        return F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps
        )
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
    ) -> torch.Tensor:
        """(B, C, H, W) in the compute dtype -> (B, 5+C, Sy, Sx) head logits.
        start_block > 0 skips blocks the fused stem already computed.

        train=True normalises BN with batch statistics and folds them into
        the running ones, and drops whole channels per sample on the blocks
        whose spec has dropout, with masks drawn from `generator` (on its
        own device; None draws from the global generator of x's device).
        bn_frozen=True is the fine-tune BN-freeze: running statistics
        normalise and are never updated while the rest trains.

        remat recomputes activations in the backward pass instead of
        storing them: "blocks" keeps only each block's input, "full" only
        the stack's. The recomputation sees the same dropout masks and does
        not fold the batch statistics in a second time."""
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be none|blocks|full, got {remat!r}")
        fmt = torch.channels_last if self.channels_last else torch.contiguous_format
        x = x.contiguous(memory_format=fmt)
        masks = self._dropout_masks(x, start_block, generator) if train else {}
        batch_stats = train and not bn_frozen

        def run(x, first, last, calls):
            # the first call of a checkpointed segment is the forward; a
            # later one is its recomputation, which must leave the running
            # statistics alone
            update_stats = not calls
            calls.append(None)
            for i in range(first, last):
                x = self._block(i, x, batch_stats, update_stats, masks.get(i))
            return x

        n = len(self.blocks)
        if remat == "none" or not torch.is_grad_enabled():
            return run(x, start_block, n, [])
        segments = [(start_block, n)] if remat == "full" else [
            (i, i + 1) for i in range(start_block, n)
        ]
        for first, last in segments:
            x = checkpoint(run, x, first, last, [], use_reentrant=False)
        return x

    def _block(
        self,
        i: int,
        x: torch.Tensor,
        batch_stats: bool,
        update_stats: bool,
        drop_mask: Optional[torch.Tensor],
    ) -> torch.Tensor:
        s = self.blocks[i]
        conv = getattr(self, f"conv{i}")
        bias = conv.bias.to(x.dtype) if conv.bias is not None else None
        x = F.conv2d(x, conv.weight.to(x.dtype), bias, s.stride, s.padding)
        if s.bn:
            x = _batch_norm(getattr(self, f"bn{i}"), x, batch_stats, update_stats)
        x = _activation(s.act, x)
        if drop_mask is not None:
            x = x * drop_mask
        return x

    def _dropout_masks(
        self, x: torch.Tensor, start_block: int, generator: Optional[torch.Generator]
    ) -> dict:
        """{block: (B, C, 1, 1) mask of 0 or 1/(1-p)} in x's dtype: whole
        channels per sample (Dropout2d), drawn in block order before any
        block runs so that a recomputation reuses them."""
        draw_on = x.device if generator is None else generator.device
        masks = {}
        for i, s in enumerate(self.blocks):
            if i < start_block or s.dropout <= 0:
                continue
            u = torch.rand((x.shape[0], s.out, 1, 1), generator=generator, device=draw_on)
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
    raw = raw.float()
    sy, sx = raw.shape[1], raw.shape[2]
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


@contextlib.contextmanager
def no_tf32(device: torch.device):
    """cuDNN runs float32 convs in TF32 by default on Ampere and later;
    the float32 path turns that off for its duration. A training step
    holds it around forward AND backward: the flag is read when each
    kernel is chosen, the gradient convs' included."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@dataclass(frozen=True)
class YOGO:
    """Static model configuration + functional forward (mirrors
    yogo_tpu.models.yogo.YOGO; the weights live in a ConvStack)."""

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

    def module(self, device=None, channels_last: bool = True) -> ConvStack:
        """A ConvStack for this architecture in eval mode on `device`
        (default CUDA), with torch's default init; load weights with
        load_state_dict(state_dict_from_flax(variables)), or start from
        `init`. Whether a forward trains is an argument of `apply`, not the
        module's mode."""
        defn = self.defn
        if defn.family != "conv_stack":
            raise NotImplementedError(f"{defn.family} models are not ported yet")
        stack = ConvStack(defn.blocks, self.input_channels, channels_last)
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        return stack.to(device=resolve_device(device), memory_format=fmt).eval()

    # ------------------------------------------------------------- param init
    def init(
        self,
        generator: Optional[torch.Generator] = None,
        device=None,
        channels_last: bool = True,
    ) -> ConvStack:
        """A freshly initialised ConvStack on `device` (default CUDA), as
        yogo_tpu's YOGO.init: conv kernels Kaiming-normal in fan-out mode
        with the LeakyReLU(0.01) gain (reference: yogo/model.py:79-87),
        zero biases, BN scale 1 / bias 0, running mean 0 / var 1. The
        values are drawn on the CPU from `generator` (a CPU generator; None
        uses torch's global one), so a seed gives the same weights on any
        device."""
        device = resolve_device(device)
        stack = self.module("cpu", channels_last)
        with torch.no_grad():
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
    def num_params(stack: ConvStack) -> int:
        return sum(p.numel() for p in stack.parameters())

    @staticmethod
    def param_norm(tensors: Iterable[torch.Tensor]) -> float:
        """Global L2 norm of an iterable of tensors, e.g. stack.parameters()
        (reference: yogo/model.py:171-181)."""
        return float(torch.sqrt(sum(t.detach().float().pow(2).sum() for t in tensors)))

    @staticmethod
    def grad_norm(stack: ConvStack) -> float:
        """Global L2 norm of the gradients held by the stack's parameters
        (reference: yogo/model.py:157-169)."""
        return YOGO.param_norm(p.grad for p in stack.parameters() if p.grad is not None)

    # ------------------------------------------------------- fused stem gate
    def stem_kernel_eligible(
        self, stack: ConvStack, x: torch.Tensor, train: bool = False
    ) -> bool:
        """Whether block 0 runs as the fused stem kernel for this forward
        (the eligibility rules of yogo_tpu YOGO._stem_pallas_mode): not a
        training forward (the kernel has no backward, and BN is folded into
        its weights), a conv stack whose block 0 is the canonical 1->C
        conv3x3 s2 p1 without bias + BN + LeakyReLU and no dropout, bf16
        compute, raw uint8 input, even H and W, and C a width the kernel is
        built for."""
        if train or stack.training:
            return False
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
        if self.compute_dtype != torch.bfloat16 or x.dtype != torch.uint8:
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
        stack: ConvStack,
        x: torch.Tensor,
        *,
        train: bool = False,
        tuning: bool = False,
        inference: bool = False,
        decode: bool = True,
        generator: Optional[torch.Generator] = None,
        remat: str = "none",
    ) -> torch.Tensor:
        """Raw input -> decoded (B, 5+C, Sy, Sx) predictions, or with
        decode=False the undecoded NHWC head (B, Sy, Sx, 5+C) in the compute
        dtype (the input of ops.postprocess.format_preds_batched_raw;
        `inference` is then ignored).

        train=False runs without autograd (torch.inference_mode). train=True
        builds the graph: BN batch statistics are used and folded into the
        stack's running statistics in place (flax returns them as a new
        state; here the module holds them), channel dropout draws from
        `generator`, and `remat` checkpoints activations (see
        ConvStack.forward). tuning=True freezes BN: it normalises with the
        running statistics and never updates them, in either mode
        (reference: yogo/model.py:67-70)."""
        x = self._to_nchw(x)
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(no_tf32(x.device))
            if not train:
                ctx.enter_context(torch.inference_mode())
            if self.stem_kernel_eligible(stack, x, train):
                w9, b9 = stack.folded_stem()
                layout = "nhwc" if stack.channels_last else "nchw"
                h = fused_stem_nchw(x[:, 0].contiguous(), w9, b9, layout=layout)
                out = stack(h, start_block=1)
            else:
                if not x.is_floating_point():
                    x = x.float()
                out = stack(
                    x.to(self.compute_dtype), train=train, bn_frozen=tuning,
                    generator=generator, remat=remat,
                )
            raw = out.permute(0, 2, 3, 1)  # NHWC head
            if not decode:
                return raw
            return self._decode_raw(raw, inference)

    def _decode_raw(self, raw: torch.Tensor, inference: bool) -> torch.Tensor:
        """NHWC head logits -> decoded (B, 5+C, Sy, Sx) predictions."""
        sx, sy = self.grid
        cxs, cys = (torch.from_numpy(a).to(raw.device) for a in cell_offsets(sx, sy))
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
    def create(cls, img_size: Tuple[int, int], anchor_w: float, anchor_h: float,
               num_classes: int, **kwargs) -> "YOGO":
        return cls(
            img_size=(int(img_size[0]), int(img_size[1])),
            anchor_w=float(anchor_w),
            anchor_h=float(anchor_h),
            num_classes=int(num_classes),
            **kwargs,
        )
