"""Swin's window merge and residual add as one CUDA kernel
(csrc/window_merge.cu).

The plain version is models/yogo.swin_merge_windows: x + the crop of
torch.roll(window_reverse(t), +shift), whose layout steps copy the map
three times before the add reads it. models/yogo.SwinBlock launches this
kernel for a CUDA input when no gradient is recorded, the LayerNorm
kernel's own condition. The kernel reads each map token's window slot in
place (csrc/windows.cuh) and adds it to x in f32: the same bits.

`window_merge_cuda` takes an f32 (B, H, W, C) map x and its windows t,
(B, w*w, nW, C) bf16 or f32, both contiguous (C a multiple of 8 in [8,
1536]). It raises on anything else and never falls back. Each launch adds
one to utils/tracing.COUNTS["window_merge_kernel_launches"].
"""

from __future__ import annotations

import torch

from yogo_tpu_torch import kernels
from yogo_tpu_torch.ops.layer_norm import MAX_C, Windows, check_windows, plan

DTYPES = (torch.bfloat16, torch.float32)


def _check_args(x: torch.Tensor, t: torch.Tensor, windows: Windows) -> None:
    """Raise on what the kernel does not take (any device)."""
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be an f32 (B, H, W, C) map, got {tuple(x.shape)} {x.dtype}")
    if t.dtype not in DTYPES:
        raise ValueError(f"t must be bfloat16 or float32, got {t.dtype}")
    b, h, w, c = x.shape
    if c % 8 or not 8 <= c <= MAX_C:
        raise ValueError(f"C must be a multiple of 8 in [8, {MAX_C}], got {c}")
    check_windows(h, w, windows)
    want = windows.shape(b, c)
    if tuple(t.shape) != want:
        raise ValueError(f"t must be the map's windows {want}, got {tuple(t.shape)}")
    if not (x.is_contiguous() and t.is_contiguous()):
        raise ValueError("x and t must be contiguous")
    if t.device != x.device:
        raise ValueError(f"t is on {t.device}, x on {x.device}: one device")
    if x.device.type != "cuda":
        raise ValueError(f"no window merge kernel for device {x.device}")
    if x.data_ptr() % 16 or t.data_ptr() % 16:
        raise ValueError("x and t must start 16-byte aligned")


def window_merge_cuda(x: torch.Tensor, t: torch.Tensor, windows: Windows) -> torch.Tensor:
    """models/yogo.swin_merge_windows(x, t, windows) in one launch on the
    current stream (no sync): a new f32 (B, H, W, C) map."""
    _check_args(x, t, windows)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    rows = b * h * w
    if rows == 0:
        return out
    tpr, ch = plan(c, torch.float32)
    kernels.launch("window_merge", x.device, x.data_ptr(), t.data_ptr(), out.data_ptr(), rows, c,
                   int(t.dtype == torch.bfloat16), tpr, ch, h, w, *windows)
    return out
