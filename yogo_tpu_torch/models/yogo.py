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
  - `ConvNeXtSmall` / `ConvNeXtBlock`: the convnext family (models/yogo.py
    of the JAX package, flax parameter names), its residual stream in
    NHWC float32 whatever the compute dtype, with flax's LayerNorm
    (`layer_norm`);
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
LN_EPS = 1e-6
CONVNEXT_DEPTHS = (3, 3, 27, 3)
CONVNEXT_DIMS = (96, 192, 384, 768)


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


class LayerNorm(nn.Module):
    """Parameters of one LayerNorm over the channels (flax's scale / bias
    are weight / bias); the forward is `layer_norm`."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


def _conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Conv(dtype=dtype) on an NHWC tensor: input, kernel and bias
    cast to `dtype`, the conv run on the channels_last NCHW view, NHWC out
    in `dtype` (contiguous)."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
        conv.stride, conv.padding, conv.dilation, conv.groups,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def _linear(x: torch.Tensor, fc: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype) over the last axis."""
    return F.linear(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype))


class ConvNeXtBlock(nn.Module):
    """One ConvNeXt block (yogo_tpu/models/yogo.py ConvNeXtBlock): 7x7
    depthwise conv, LayerNorm, Dense 4x, exact-erf GELU, Dense back, the
    per-channel `gamma` (1e-6 at init) and the residual. NHWC in, NHWC
    float32 out: the LayerNorm returns float32, so in a bf16 model only the
    convs and Dense layers compute in bf16."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = self.norm(_conv_nhwc(x, self.dwconv, dtype))
        h = F.gelu(_linear(h, self.pwconv1, dtype), approximate="none")
        return x + self.gamma * _linear(h, self.pwconv2, dtype)


class ConvNeXtSmall(nn.Module):
    """ConvNeXt-Small trunk + YOGO format head (yogo_tpu/models/yogo.py
    ConvNeXtSmall; reference: yogo/model_defns.py:533-558, through timm):
    a 4x4 stride-4 patchify stem + LayerNorm, four stages of ConvNeXt
    blocks with a LayerNorm + 2x2 stride-2 conv between them, a 1x1 conv to
    5+C and a 4x4 stride-4 transpose conv. Module names follow the flax
    tree (utils/weights.py maps them one to one). The compute dtype is the
    input's: YOGO.apply casts the input to it.

    There is no BatchNorm and no dropout: `train`, `bn_frozen` and
    `generator` are accepted and change nothing, as in flax. remat="blocks"
    checkpoints each ConvNeXtBlock, "full" the whole forward. (In the JAX
    package "blocks" saves the activations named `yogo_block`, which this
    family does not name, so there it recomputes as much as "full";
    recomputation changes memory, never values.)"""

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
            return checkpoint(self._forward, x, "none", use_reentrant=False)
        return self._forward(x, "blocks" if recompute else "none")

    def _forward(self, x: torch.Tensor, remat: str) -> torch.Tensor:
        dtype = x.dtype
        h = _conv_nhwc(x.permute(0, 2, 3, 1), self.stem_conv, dtype)
        h = self.stem_norm(h)
        for s, depth in enumerate(self.depths):
            if s > 0:
                h = getattr(self, f"down{s}_norm")(h)
                h = _conv_nhwc(h, getattr(self, f"down{s}_conv"), dtype)
            for b in range(depth):
                block = getattr(self, f"stage{s}_block{b}")
                if remat == "blocks":
                    h = checkpoint(block, h, dtype, use_reentrant=False)
                else:
                    h = block(h, dtype)
        h = _conv_nhwc(h, self.format_conv, dtype).permute(0, 3, 1, 2)
        up = self.format_up
        out = F.conv_transpose2d(h, up.weight.to(dtype), up.bias.to(dtype), up.stride)
        return out.contiguous(memory_format=torch.channels_last)


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
    architecture's family, a ConvStack or a ConvNeXtSmall)."""

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
        """The module of this architecture's family (a ConvStack or a
        ConvNeXtSmall) in eval mode on `device` (default CUDA), with torch's
        default init; load weights with
        load_state_dict(state_dict_from_flax(variables)), or start from
        `init`. Whether a forward trains is an argument of `apply`, not the
        module's mode. `channels_last` picks a conv stack's memory format;
        the convnext trunk always runs NHWC."""
        defn = self.defn
        device = resolve_device(device)
        if defn.family == "convnext":
            net = ConvNeXtSmall(5 + self.num_classes, self.input_channels)
            return net.to(device).eval()
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
        1e-6. The values are drawn on the CPU from `generator` (a CPU
        generator; None uses torch's global one), so a seed gives the same
        weights on any device."""
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
        ConvStack.forward and ConvNeXtSmall). tuning=True freezes BN: it
        normalises with the running statistics and never updates them, in
        either mode (reference: yogo/model.py:67-70). ConvNeXt has neither
        BN nor dropout."""
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
