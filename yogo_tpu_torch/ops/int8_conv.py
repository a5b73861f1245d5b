"""s8 x s8 -> s32 convolution with a fused f32 epilogue, for the int8 program.

The JAX package runs the int8 convs and matmuls of its quantized forwards
in XLA (yogo_tpu/ops/quant.py:609-614, yogo_tpu/ops/quant_convnext.py:416-439);
torch has no int8 convolution on CUDA, so here they are one hand-written
CUDA kernel, csrc/int8_conv.cu. For one quantized block or site it computes

    acc[b,y,x,o] = sum_{dy,dx,c} q[b, s*y+dy-p, s*x+dx-p, c] * w8[o,dy,dx,c]   (int32, zero padding)
    h            = act(float(acc) * deq[o] + bias[o])                          (f32)
    out          = h  (f32 NHWC, (B, Ho, Wo, Cout))
                   or clip(rint(h / out_scale), -127, 127)  (int8 NHWC, the next
                   quantized block's input codes, (B, Ho, Wo, padded_channels(Cout)))

Layouts: activation codes are int8 NHWC with the channels padded with zero
codes to a multiple of CIN_ALIGN (32 bytes, one k-step of the tensor cores'
m16n8k32 product); weights are packed once at quantize time by
`pack_weights` as (Cout, kh, kw, Cin padded), K-major per output channel.

`int8_conv` launches the kernel for CUDA tensors and runs the plain PyTorch
version `int8_conv_reference` (exact integer accumulation in float64) for
CPU tensors; nothing else falls back. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yogo_tpu_torch import kernels
from yogo_tpu_torch.models.yogo import _activation

CIN_ALIGN = 32
# activation -> the kernel's code (csrc/int8_conv.cu Act: LeakyReLU 0.01)
ACTS = {None: 0, "leaky_relu": 1, "silu": 2}
# (kernel, stride, padding) the kernel is built for: the conv-stack blocks,
# ConvNeXt's Dense layers (1x1) and its 2x2 stride-2 downsamples
SHAPES = ((3, 1, 1), (3, 2, 1), (1, 1, 0), (2, 2, 0))

# kernel launches by name ("int8_conv"); reset with .clear()
LAUNCHES: Counter = Counter()


def padded_channels(c: int) -> int:
    """Channels of an int8 activation or packed weight holding c real ones."""
    return -(-int(c) // CIN_ALIGN) * CIN_ALIGN


def pack_weights(w8_hwio) -> torch.Tensor:
    """(kh, kw, Cin, Cout) int8 HWIO (the JAX package's layout) -> the
    kernel's (Cout, kh, kw, padded_channels(Cin)) int8, zero in the padding."""
    w = np.asarray(w8_hwio)
    if w.dtype != np.int8 or w.ndim != 4:
        raise ValueError(f"expected (kh, kw, Cin, Cout) int8 weights, got {w.shape} {w.dtype}")
    kh, kw, cin, cout = w.shape
    out = np.zeros((cout, kh, kw, padded_channels(cin)), np.int8)
    out[..., :cin] = np.transpose(w, (3, 0, 1, 2))
    return torch.from_numpy(out)


def out_hw(h: int, w: int, kernel: int, stride: int, padding: int) -> Tuple[int, int]:
    return ((h + 2 * padding - kernel) // stride + 1, (w + 2 * padding - kernel) // stride + 1)


def _check_args(q, w_packed, deq, bias, cin, stride, padding, act, out_scale):
    if act not in ACTS:
        raise NotImplementedError(f"int8 conv: unsupported activation {act}")
    if q.dtype != torch.int8 or q.dim() != 4 or q.shape[-1] % CIN_ALIGN:
        raise ValueError(
            f"codes must be (B, H, W, C) int8 with C a multiple of {CIN_ALIGN}, "
            f"got {tuple(q.shape)} {q.dtype}"
        )
    if w_packed.dtype != torch.int8 or w_packed.dim() != 4 or w_packed.shape[1] != w_packed.shape[2]:
        raise ValueError(f"weights must be packed (Cout, k, k, C) int8, got {tuple(w_packed.shape)}")
    cout, k, _, cp = w_packed.shape
    if cp != q.shape[-1] or not 0 < cin <= cp or padded_channels(cin) != cp:
        raise ValueError(f"codes have {q.shape[-1]} channels, weights {cp}, real input channels {cin}")
    if (k, stride, padding) not in SHAPES:
        raise ValueError(f"int8 conv is built for (kernel, stride, padding) in {SHAPES}, got {(k, stride, padding)}")
    for name, t in (("deq", deq), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (cout,):
            raise ValueError(f"{name} must be ({cout},) float32, got {tuple(t.shape)} {t.dtype}")
    if out_scale is not None and (out_scale.dtype != torch.float32 or out_scale.numel() != 1):
        raise ValueError("out_scale must be a one-element float32 tensor")
    devs = {t.device for t in (q, w_packed, deq, bias)} | ({out_scale.device} if out_scale is not None else set())
    if len(devs) != 1:
        raise ValueError(f"int8 conv inputs must be on one device, got {devs}")


def conv_acc_reference(q: torch.Tensor, w_packed: torch.Tensor, cin: int, stride: int, padding: int) -> torch.Tensor:
    """The int32 accumulators of the conv as exact integers in float64
    (K * 127^2 passes f32's 2^24, not float64's 2^53), NCHW (B, Cout, Ho, Wo).
    cuDNN is kept out of the way on the card: torch's own im2col + GEMM is
    exact for integers, a transform algorithm need not be."""
    x = q[..., :cin].permute(0, 3, 1, 2).double()
    w = w_packed[..., :cin].permute(0, 3, 1, 2).double()
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(x, w, None, stride, padding)


def int8_conv_reference(
    q: torch.Tensor,
    w_packed: torch.Tensor,
    deq: torch.Tensor,
    bias: torch.Tensor,
    *,
    cin: int,
    stride: int,
    padding: int,
    act: Optional[str],
    out_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: exact integer accumulation,
    one rounding of each accumulator to f32, then `float(acc) * deq + bias`
    (two roundings, as the JAX program's ops), the activation, and either
    the f32 NHWC result or its int8 requant (round half to even) with zero
    codes in the padded channels."""
    _check_args(q, w_packed, deq, bias, cin, stride, padding, act, out_scale)
    acc = conv_acc_reference(q, w_packed, cin, stride, padding).permute(0, 2, 3, 1)
    h = _activation(act, acc.float() * deq + bias)
    if out_scale is None:
        return h.contiguous()
    codes = torch.clamp(torch.round(h / out_scale.reshape(())), -127, 127).to(torch.int8)
    cout = w_packed.shape[0]
    return F.pad(codes, (0, padded_channels(cout) - cout)).contiguous()


def int8_conv(
    q: torch.Tensor,
    w_packed: torch.Tensor,
    deq: torch.Tensor,
    bias: torch.Tensor,
    *,
    cin: int,
    stride: int,
    padding: int,
    act: Optional[str],
    out_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """codes (B, H, W, C) int8 NHWC, packed weights (Cout, k, k, C) int8,
    deq / bias (Cout,) f32 -> f32 (B, Ho, Wo, Cout), or, with `out_scale`
    (a one-element f32 tensor, read on the device), the next block's int8
    codes (B, Ho, Wo, padded_channels(Cout)). CUDA tensors launch
    csrc/int8_conv.cu; CPU tensors take int8_conv_reference."""
    if q.device.type == "cpu":
        return int8_conv_reference(
            q, w_packed, deq, bias, cin=cin, stride=stride, padding=padding, act=act, out_scale=out_scale
        )
    _check_args(q, w_packed, deq, bias, cin, stride, padding, act, out_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {q.device}")
    args = (q, w_packed, deq, bias) + ((out_scale,) if out_scale is not None else ())
    if not all(t.is_contiguous() for t in args):
        raise ValueError("int8 conv kernel inputs must be contiguous")
    if q.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("int8 conv kernel codes and weights must be 16-byte aligned")
    bsz, h, w, cp = q.shape
    cout, k = w_packed.shape[:2]
    ho, wo = out_hw(h, w, k, stride, padding)
    if out_scale is None:
        out = torch.empty((bsz, ho, wo, cout), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty((bsz, ho, wo, padded_channels(cout)), dtype=torch.int8, device=q.device)
    lib = kernels.load("int8_conv")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.yogo_int8_conv_launch(
            q.data_ptr(), w_packed.data_ptr(), deq.data_ptr(), bias.data_ptr(),
            out_scale.data_ptr() if out_scale is not None else None, out.data_ptr(),
            bsz, h, w, cp, cout, k, stride, padding, ACTS[act], int(out_scale is not None), stream,
        )
    kernels.check(lib, code, "int8 conv kernel")
    LAUNCHES["int8_conv"] += 1
    return out
