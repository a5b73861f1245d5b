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
s8 products); weights are packed once at quantize time by `pack_weights` as
(Cout, kh, kw, Cin padded), K-major per output channel.

`launch_plan` computes, in plain Python, everything the kernel's C entry
needs for one shape (tiles, the route that loads the codes, the grid, the
shared-memory layout, the im2col box corners, traversal stride and tap
offsets); the C entry recomputes it, refuses any other, and launches it.
`int8_conv` launches the kernel for CUDA tensors and runs the plain
PyTorch version `int8_conv_reference` (exact integer accumulation in
float64) for CPU tensors; nothing else falls back. Each launch adds one to
utils/tracing.COUNTS' `int8_conv_kernel_launches`.
"""

from __future__ import annotations

from dataclasses import astuple, dataclass, fields
from typing import Iterator, Optional, Tuple

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

# ---- the launch plan (csrc/int8_conv.cu reads it in this field order and
# checks every field)
SMEM_LIMIT = 232_448  # shared memory a block may opt in to on sm_90 (227 KB)
K_BLOCK = 128  # bytes of K a stage: one 128-byte swizzle row of each operand
EPI_SUB_BYTES = 64 * 128  # an epilogue sub-tile: 64 rows of 128 bytes
BARRIER_BYTES = 256  # the mbarriers, after the buffers
SMEM_ALIGN = 1024  # a 128-byte swizzle repeats every 8 rows: 1 KiB-aligned tiles
MAX_STAGES = 8
MIN_RESIDENT_STAGES = 4  # keep the weights resident only with this deep an A ring
H100_SMS = 132
MAX_TAPS = 9
ROUTES = {"tiled": 0, "im2col": 1}  # how the codes reach shared memory
STORES = {"tma": 0, "direct": 1}  # how the output tile reaches device memory


@dataclass(frozen=True)
class LaunchPlan:
    """One launch of csrc/int8_conv.cu. A warpgroup computes a block_m x
    block_n output tile (64 rows: one m64 product; block_n / 2 s32
    accumulators a thread). Each of the `grid` persistent blocks keeps one
    N tile and walks M tiles (plan_tiles), its `consumers` warpgroups (3
    at block_n 128 but for SiLU, else 2) taking turns. A tile is
    `k_blocks` stages of 128 bytes of K: for each tap, `chunks` 128-channel
    chunks. Byte offsets are from the 1 KiB-aligned base of dynamic shared
    memory."""

    block_m: int
    block_n: int
    route: int  # ROUTES: the [M, Cp] code matrix (1x1) or TMA im2col
    chunks: int  # ceil(Cp / 128)
    taps: int  # kh * kw
    k_blocks: int  # taps * chunks
    m_tiles: int
    n_tiles: int
    tiles: int
    grid: int
    stages: int  # depth of the ring of code (and, unless resident, weight) stages
    resident_b: int  # 1: the block's whole [block_n, K] weight tile is loaded once
    store: int  # STORES
    epi_bufs: int  # epilogue sub-tile buffers a consumer warpgroup (TMA store)
    smem_bytes: int  # dynamic shared memory to request (with SMEM_ALIGN of slack)
    a_stage_bytes: int
    b_chunk_bytes: int
    ring_stage_bytes: int
    b_offset: int
    ring_offset: int
    epi_offset: int
    vec_offset: int  # deq and bias of the block's N tile, a copy a consumer
    bar_offset: int
    box_lower: int  # im2col pixel box corners, the same in H and W
    box_upper: int
    traversal_stride: int
    consumers: int  # consumer warpgroups a block
    tap_dx: Tuple[int, ...]  # the im2col offsets of each tap, (dy, dx) row-major
    tap_dy: Tuple[int, ...]

    def to_array(self) -> np.ndarray:
        """The plan as the int32 array the C entry reads: the scalar fields
        in order, then tap_dx and tap_dy padded to MAX_TAPS."""
        head = [v for f, v in zip(fields(self), astuple(self)) if not f.name.startswith("tap_")]
        pad = (0,) * (MAX_TAPS - self.taps)
        return np.asarray(head + list(self.tap_dx + pad) + list(self.tap_dy + pad), np.int32)


PLAN_LEN = len(fields(LaunchPlan)) - 2 + 2 * MAX_TAPS


def launch_plan(bsz: int, h: int, w: int, cp: int, cout: int, kernel: int, stride: int, padding: int,
                *, out_s8: bool, act: Optional[str] = None, num_sms: int = H100_SMS) -> LaunchPlan:
    """The kernel's launch plan for codes (bsz, h, w, cp) and weights
    (cout, kernel, kernel, cp): N tiles of 256 for an f32 output where 256
    divides Cout, else 128; the whole weight tile of a block resident where
    it fits beside MIN_RESIDENT_STAGES code stages; the ring as deep as
    shared memory allows, up to MAX_STAGES (PERF.md measures each choice)."""
    if (kernel, stride, padding) not in SHAPES or cp % CIN_ALIGN or min(bsz, h, w, cp, cout) <= 0:
        raise ValueError(f"no plan for codes {(bsz, h, w, cp)}, Cout {cout}, {(kernel, stride, padding)}")
    ho, wo = out_hw(h, w, kernel, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"a {kernel}x{kernel} window does not fit a {h}x{w} image")
    block_n = 256 if cout % 256 == 0 and not out_s8 else 128
    block_m = 64
    chunks = -(-cp // K_BLOCK)
    taps = kernel * kernel
    k_blocks = taps * chunks
    m = bsz * ho * wo
    m_tiles, n_tiles = -(-m // block_m), -(-cout // block_n)
    tiles = m_tiles * n_tiles
    a_stage, b_chunk = block_m * K_BLOCK, block_n * K_BLOCK
    store = STORES["tma"] if out_s8 or cout % 4 == 0 else STORES["direct"]
    # three consumers of 64 accumulators a thread fit 128 registers; SiLU's
    # division (its slow path is a call) and N tiles of 256 take two
    consumers = 3 if block_n == 128 and act != "silu" else 2
    vec_bytes = consumers * 2 * block_n * 4
    room = SMEM_LIMIT - SMEM_ALIGN - BARRIER_BYTES - vec_bytes

    def epi(bufs):
        return consumers * bufs * EPI_SUB_BYTES if store == STORES["tma"] else 0

    resident_b, b_bytes, ring, epi_bufs = 0, 0, a_stage + b_chunk, 2
    for bufs in (2, 1):  # a block's tiles share one N tile of weights
        if k_blocks * b_chunk + MIN_RESIDENT_STAGES * a_stage + epi(bufs) <= room:
            resident_b, b_bytes, ring, epi_bufs = 1, k_blocks * b_chunk, a_stage, bufs
            break
    stages = min(MAX_STAGES, (room - b_bytes - epi(epi_bufs)) // ring)
    b_offset, ring_offset = 0, b_bytes
    epi_offset = ring_offset + stages * ring
    vec_offset = epi_offset + epi(epi_bufs)
    bar_offset = vec_offset + vec_bytes
    taps_yx = [(dy, dx) for dy in range(kernel) for dx in range(kernel)]
    im2col = kernel > 1
    return LaunchPlan(
        block_m=block_m, block_n=block_n, route=ROUTES["im2col" if im2col else "tiled"], chunks=chunks,
        taps=taps, k_blocks=k_blocks, m_tiles=m_tiles, n_tiles=n_tiles, tiles=tiles,
        grid=n_tiles * max(1, min(num_sms // n_tiles, -(-m_tiles // consumers))), stages=stages,
        resident_b=resident_b, store=store,
        epi_bufs=epi_bufs if store == STORES["tma"] else 0,
        smem_bytes=SMEM_ALIGN + bar_offset + BARRIER_BYTES, a_stage_bytes=a_stage, b_chunk_bytes=b_chunk,
        ring_stage_bytes=ring, b_offset=b_offset, ring_offset=ring_offset, epi_offset=epi_offset,
        vec_offset=vec_offset, bar_offset=bar_offset,
        # pixel p of a tile reads input (base + tap offset), base running
        # over [-padding, size - 1 + padding - (kernel - 1)] in steps of the
        # stride: exactly the output positions, so a 2x2 stride-2 VALID conv
        # over an odd size never starts a window on the last row / column
        box_lower=-padding if im2col else 0, box_upper=padding - (kernel - 1) if im2col else 0,
        traversal_stride=stride, consumers=consumers,
        tap_dx=tuple(dx for _, dx in taps_yx), tap_dy=tuple(dy for dy, _ in taps_yx),
    )


def plan_tiles(plan: LaunchPlan) -> Iterator[Tuple[int, int, int, int]]:
    """(block, consumer warpgroup, m0, n0) in the order the kernel's blocks
    walk their tiles: block b keeps N tile b % n_tiles and takes M tiles
    b // n_tiles, + grid // n_tiles, ..., its consumer warpgroups in turn."""
    step = plan.grid // plan.n_tiles
    for cta in range(plan.grid):
        nt, first = cta % plan.n_tiles, cta // plan.n_tiles
        for j, mt in enumerate(range(first, plan.m_tiles, step)):
            yield cta, j % plan.consumers, mt * plan.block_m, nt * plan.block_n


def im2col_base(m0: int, ho: int, wo: int, stride: int, padding: int) -> Tuple[int, int, int]:
    """The (w, h, n) tensor coordinates of the im2col load of the tile
    whose first output pixel is m0: the top-left input pixel of its window."""
    b, r = divmod(m0, ho * wo)
    oy, ox = divmod(r, wo)
    return ox * stride - padding, oy * stride - padding, b


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
    plan = launch_plan(bsz, h, w, cp, cout, k, stride, padding, out_s8=out_scale is not None, act=act,
                       num_sms=_sm_count(q.device))
    return _launch(q, w_packed, deq, bias, out_scale, stride=stride, padding=padding, act=act, plan=plan)


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _launch(q, w_packed, deq, bias, out_scale, *, stride, padding, act, plan: LaunchPlan) -> torch.Tensor:
    """Allocate the output and launch csrc/int8_conv.cu with `plan` on the
    current stream (arguments checked by int8_conv)."""
    bsz, h, w, cp = q.shape
    cout, k = w_packed.shape[:2]
    ho, wo = out_hw(h, w, k, stride, padding)
    if out_scale is None:
        out = torch.empty((bsz, ho, wo, cout), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty((bsz, ho, wo, padded_channels(cout)), dtype=torch.int8, device=q.device)
    arr = plan.to_array()
    kernels.launch(
        "int8_conv", q.device, q.data_ptr(), w_packed.data_ptr(), deq.data_ptr(), bias.data_ptr(),
        out_scale.data_ptr() if out_scale is not None else None, out.data_ptr(),
        bsz, h, w, cp, cout, k, stride, padding, ACTS[act], int(out_scale is not None),
        arr.ctypes.data, len(arr),
    )
    return out
