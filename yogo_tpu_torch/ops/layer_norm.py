"""LayerNorm over the last axis as one CUDA kernel (csrc/layer_norm.cu).

The plain version is models/yogo.layer_norm (flax's formula as a chain of
torch ops, f32 whatever the input); models/yogo.LayerNorm launches this
kernel for a CUDA input when no gradient is recorded, and casts the plain
version's output otherwise. The kernel computes the same f32 arithmetic in
one pass: each row read once, written once in the dtype its consumer reads.

`layer_norm_cuda` takes rows of C contiguous elements (C a multiple of 8 in
[8, 1536]), bf16 or f32 in, f32 weight and bias, bf16 or f32 out. It raises
on anything else and never falls back. Each launch adds one to
utils/tracing.COUNTS["layer_norm_kernel_launches"].
"""

from __future__ import annotations

from typing import Tuple

import torch

from yogo_tpu_torch import kernels

MAX_C = 1536
MAX_ELEMS = 64  # elements a lane holds (csrc/layer_norm.cu MAX_ELEMS)
DTYPES = (torch.bfloat16, torch.float32)


def chunk(out_dtype: torch.dtype) -> int:
    """Elements a lane loads and stores at once: 16 bytes of the output."""
    return 16 // out_dtype.itemsize


def plan(c: int, out_dtype: torch.dtype) -> Tuple[int, int]:
    """(lanes a row, chunks a lane) for rows of C elements: the power of two
    up to 32 lanes, each holding at most MAX_ELEMS elements in chunks of
    chunk(out_dtype), that leaves the fewest chunk slots empty, the most
    lanes among equals. A bf16 output: 96 -> 4 x 3, 192 -> 8 x 3, 384 ->
    16 x 3, 768 -> 32 x 3, 1,536 -> 32 x 6; an f32 output: 96 -> 8 x 3."""
    vec = chunk(out_dtype)
    n = c // vec
    best = None
    for tpr in (32, 16, 8, 4, 2, 1):
        ch = -(-n // tpr)
        if ch * vec <= MAX_ELEMS and (best is None or tpr * ch < best[0] * best[1]):
            best = (tpr, ch)
    return best


def _check_args(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype) -> None:
    """Raise on what the kernel does not take (any device)."""
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if out_dtype not in DTYPES:
        raise ValueError(f"the output dtype must be bfloat16 or float32, got {out_dtype}")
    if x.dim() < 1:
        raise ValueError("x must have a last axis to normalise")
    c = x.shape[-1]
    if c % 8 or not 8 <= c <= MAX_C:
        raise ValueError(f"C must be a multiple of 8 in [8, {MAX_C}], got {c}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({c},) float32 tensor, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}: one device")
    if x.device.type != "cuda":
        raise ValueError(f"no LayerNorm kernel for device {x.device}")
    if any(t.data_ptr() % 16 for t in (x, weight, bias)):
        raise ValueError("x, weight and bias must start 16-byte aligned")


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """models/yogo.layer_norm(x, weight, bias, eps).to(out_dtype) in one
    launch on the current stream (no sync): x (..., C) contiguous bf16 or
    f32 on a CUDA device, weight and bias (C,) f32 there."""
    _check_args(x, weight, bias, out_dtype)
    c = x.shape[-1]
    rows = x.numel() // c
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if rows == 0:
        return out
    tpr, ch = plan(c, out_dtype)
    kernels.launch("layer_norm", x.device, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                   rows, c, int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), tpr, ch, float(eps))
    return out
