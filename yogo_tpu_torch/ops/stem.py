"""Fused YOGO stem: uint8 -> conv3x3 stride 2 + folded BN + LeakyReLU -> bf16.

Port of yogo_tpu/ops/pallas_stem.py. Both of its Pallas kernels
(`fused_stem`, NHWC out, and `fused_stem_nchw`, NCHW out) compute block 0
of the conv stacks; here they are one hand-written CUDA kernel
(csrc/stem.cu) with a layout switch:

  - layout="nchw": a contiguous (B, C, H/2, W/2) bf16 tensor;
  - layout="nhwc": the same logical shape in torch.channels_last memory
    format, i.e. NHWC bytes, which cuDNN's channels_last convs read as is.

`fused_stem_nchw` launches the kernel for CUDA tensors and runs the plain
PyTorch version `fused_stem_reference` (the same f32 math) for CPU tensors;
nothing else falls back. Each launch adds one to utils/tracing.COUNTS'
`stem_<layout>_kernel_launches`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from yogo_tpu_torch import kernels

LAYOUTS = ("nchw", "nhwc")
# block-0 widths csrc/stem.cu is instantiated for (the registry's scaled
# stacks: quarter/half/base/double/triple filters, and the depth_ver_* stems)
STEM_CHANNELS = (4, 8, 16, 32, 48)


def fold_stem_params(
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    bn_weight: Optional[torch.Tensor] = None,
    bn_bias: Optional[torch.Tensor] = None,
    bn_mean: Optional[torch.Tensor] = None,
    bn_var: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, 1, 3, 3) OIHW conv weight (+ inference BN) -> folded f32
    ((C, 9) weights with column 3*dy+dx, (C,) bias) for the fused stem.
    Same math as yogo_tpu/ops/pallas_stem.py:79-108."""
    w = weight.float().reshape(weight.shape[0], 9)
    b = bias.float() if bias is not None else torch.zeros_like(w[:, 0])
    if bn_weight is not None:
        k = bn_weight.float() * torch.rsqrt(bn_var.float() + eps)
        w = w * k[:, None]
        b = (b - bn_mean.float()) * k + bn_bias.float()
    return w.contiguous(), b.contiguous()


def _check_args(images: torch.Tensor, w: torch.Tensor, b: torch.Tensor, layout: str):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if images.dtype != torch.uint8 or images.dim() != 3:
        raise ValueError(
            f"images must be (B, H, W) uint8, got {tuple(images.shape)} {images.dtype}"
        )
    _, h, wd = images.shape
    if h % 2 or wd % 2:
        raise ValueError(f"image height and width must be even, got {h}x{wd}")
    c = w.shape[0]
    if w.shape != (c, 9) or b.shape != (c,):
        raise ValueError(f"expected weights (C, 9) and bias (C,), got {tuple(w.shape)}, {tuple(b.shape)}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("stem weights and bias must be float32")
    if not (w.device == b.device == images.device):
        raise ValueError("images, weights and bias must be on one device")


def fused_stem_reference(
    images: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    layout: str = "nchw",
    negative_slope: float = 0.01,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same 9-tap f32 sum (bias
    first, taps in 3*dy+dx order), LeakyReLU, one rounding to bf16."""
    _check_args(images, w, b, layout)
    bsz, h, wd = images.shape
    h2, w2 = h // 2, wd // 2
    padded = F.pad(images.float(), (1, 1, 1, 1))
    acc = b.view(1, -1, 1, 1).expand(bsz, -1, h2, w2)
    for dy in range(3):
        for dx in range(3):
            tap = padded[:, dy : dy + 2 * h2 : 2, dx : dx + 2 * w2 : 2]
            acc = acc + w[:, 3 * dy + dx].view(1, -1, 1, 1) * tap[:, None]
    out = torch.where(acc >= 0, acc, negative_slope * acc).to(torch.bfloat16)
    if layout == "nhwc":
        return out.contiguous(memory_format=torch.channels_last)
    return out.contiguous()


def fused_stem_nchw(
    images: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    layout: str = "nchw",
    negative_slope: float = 0.01,
) -> torch.Tensor:
    """images (B, H, W) uint8 (H, W even), w (C, 9) and b (C,) f32 from
    fold_stem_params -> (B, C, H/2, W/2) bf16, NCHW-contiguous or
    channels_last per `layout`. CUDA tensors launch csrc/stem.cu; CPU
    tensors take fused_stem_reference."""
    if images.device.type == "cpu":
        return fused_stem_reference(images, w, b, layout, negative_slope)
    _check_args(images, w, b, layout)
    if images.device.type != "cuda":
        raise ValueError(f"no stem kernel for device {images.device}")
    if not (images.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("stem kernel inputs must be contiguous")
    bsz, h, wd = images.shape
    c = w.shape[0]
    if c not in STEM_CHANNELS:
        raise ValueError(f"stem kernel has no build for {c} channels")
    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    out = torch.empty(
        (bsz, c, h // 2, wd // 2), dtype=torch.bfloat16, device=images.device,
        memory_format=fmt,
    )
    kernels.launch("stem", images.device, images.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                   bsz, h, wd, c, int(layout == "nhwc"), float(negative_slope), counter=f"stem_{layout}")
    return out

