"""Post-training int8 quantization for the conv stacks (port of
yogo_tpu/ops/quant.py; same names, same scheme, same calibration payload),
and the family dispatch of `--quantize` (the convnext family's program is
ops/quant_convnext.py).

Scheme (symmetric PTQ):
  - BatchNorm folded into conv weight / bias first (numpy, HWIO, so the
    fold and the payload are the JAX package's bit for bit).
  - Weights: per-output-channel symmetric int8, scale_w[c] = absmax_c / 127.
  - Activations: per-tensor symmetric int8, the scale of each quantized
    block's input calibrated on the f32 folded forward (the conditional
    tail clip of ACT_CLIP_QUANTILE / ACT_CLIP_TAIL_RATIO), after
    per-input-channel equalization (SmoothQuant fold).
  - Block 0 stays bf16, and so do the blocks of skip_blocks (by default
    those with fewer than 128 input channels, and the head).

The quantized forward runs NCHW channels_last around int8 NHWC codes:
  - block 0: the fused stem kernel (ops/stem.py) with the folded weights
    rounded to bf16, when block 1 is a bf16 block and the input is raw
    uint8 (block 1 casts its input to bf16 at once, so the kernel's bf16
    output is the JAX program's up to the order of the sum); otherwise an
    f32 conv over the bf16-rounded input and weights;
  - a bf16 block: by default an f32 conv (TF32 off) over the bf16-rounded
    input and weights, f32 accumulation and no rounding of its output, as
    the JAX program computes it (cuDNN's bf16 conv, which rounds its output
    to bf16 before the bias, moves the head too far: PERF.md §6);
  - a quantized block: the entry requant clip(rint(h / s)) in torch ops,
    then the int8 conv kernel (ops/int8_conv.py), whose epilogue requantizes
    for the next quantized block or writes f32.

Calibration runs the f32 folded forward on the device with TF32 off, block
by block, keeping only the ranges; percentiles take the JAX package's
stride subsample of the NHWC-flattened activation and its linear
interpolation.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yogo_tpu_torch.models.defns import ConvSpec
from yogo_tpu_torch.models.yogo import YOGO, ConvStack, _activation, no_tf32, resolve_device
from yogo_tpu_torch.ops.int8_conv import int8_conv, pack_weights, padded_channels
from yogo_tpu_torch.ops.stem import fused_stem_nchw
from yogo_tpu_torch.utils.weights import flax_from_state_dict

# conv_stack activations this path is validated for; anything else must
# fail loudly rather than silently diverge
_SUPPORTED_ACTS = (None, "leaky_relu", "silu")


def _act(name: Optional[str], x: torch.Tensor) -> torch.Tensor:
    if name not in _SUPPORTED_ACTS:
        raise NotImplementedError(f"quantized path: unsupported activation {name}")
    # the float path's own activation (models/yogo.py), so the two cannot drift
    return _activation(name, x)


def fold_block_params(
    conv: Dict[str, Any], bn_params, bn_stats, eps: float = 1e-5
) -> Tuple[np.ndarray, np.ndarray]:
    """HWIO kernel + optional BN -> HWIO weight and per-channel bias with BN
    folded (yogo_tpu/ops/quant.py:63-83, the same numpy)."""
    w = np.asarray(conv["kernel"], np.float32)
    b = (
        np.asarray(conv["bias"], np.float32)
        if "bias" in conv
        else np.zeros(w.shape[-1], np.float32)
    )
    if bn_params is not None:
        scale = np.asarray(bn_params["scale"], np.float32)
        beta = np.asarray(bn_params["bias"], np.float32)
        mean = np.asarray(bn_stats["mean"], np.float32)
        var = np.asarray(bn_stats["var"], np.float32)
        k = scale / np.sqrt(var + eps)
        w = w * k[None, None, None, :]
        b = (b - mean) * k + beta
    return w, b


def fold_conv_stack(defn, variables) -> List[Tuple[ConvSpec, np.ndarray, np.ndarray]]:
    """All blocks of a conv_stack model as (spec, folded HWIO w, bias).
    `variables`: the flax-layout tree load_any returns, or a ConvStack."""
    if defn.family != "conv_stack":
        raise NotImplementedError(
            f"fold_conv_stack folds conv stacks; the {defn.family} family is "
            "quantized by ops/quant_convnext.py"
        )
    if isinstance(variables, ConvStack):
        variables = flax_from_state_dict(variables.state_dict())
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = []
    for i, s in enumerate(defn.blocks):
        if s.transpose:
            raise NotImplementedError("transpose conv in conv_stack defn")
        w, b = fold_block_params(params[f"conv{i}"], params.get(f"bn{i}"), stats.get(f"bn{i}"))
        out.append((s, w, b))
    return out


def to_nchw_f32(xb) -> torch.Tensor:
    """Calibration batch (NCHW numpy or tensor, uint8 or float, optionally
    unbatched or single-channel-squeezed) -> an NCHW float32 tensor: the
    NCHW counterpart of the JAX package's to_nhwc_f32 (YOGO.apply's input
    handling: uint8 cast, not normalized)."""
    x = torch.as_tensor(xb)
    if x.dim() == 2:
        x = x[None, None]
    elif x.dim() == 3:
        x = x[None]
    return x.float()


def _conv(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    return F.conv2d(x, w, None, spec.stride, spec.padding)


def _f32(a, device) -> torch.Tensor:
    """A float32 tensor on `device` holding a copy of array a."""
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True)).to(device)


def _oihw(w_hwio: np.ndarray, device) -> torch.Tensor:
    return _f32(np.transpose(w_hwio, (3, 2, 0, 1)), device)


def _f32_blocks(folded, device):
    """(spec, OIHW f32 weight, (1, C, 1, 1) bias) of each folded block."""
    return [(s, _oihw(w, device), _f32(b, device).view(1, -1, 1, 1)) for s, w, b in folded]


def _activations(params, x: torch.Tensor):
    """The f32 folded forward, block by block: yields (i, the activation
    entering block i) for i = 0..len(params), the last being the output.
    Lazy, and one activation alive at a time: a caller that stops after
    block i's input runs no block from i on. The one forward loop of
    folded_float_forward and both calibrations, so they cannot drift."""
    h = x.contiguous(memory_format=torch.channels_last)
    for i, (spec, w, b) in enumerate(params):
        yield i, h
        h = _act(spec.act, _conv(h, w, spec) + b)
    yield len(params), h


def folded_float_forward(folded, x, upto: Optional[int] = None, device=None) -> torch.Tensor:
    """f32 forward (TF32 off) through the folded stack on `device` (default
    CUDA): the NCHW output, or with `upto` the input activation of block
    `upto`."""
    device = resolve_device(device)
    params = _f32_blocks(folded[:upto], device)
    with torch.inference_mode(), no_tf32(device):
        for _, h in _activations(params, to_nchw_f32(x).to(device)):
            pass
    return h


def _percentile(v: torch.Tensor, pct: float, dim: Optional[int] = None) -> torch.Tensor:
    """jnp.percentile(v, pct, axis=dim) with its default linear method, in
    f32: the order statistics at floor and ceil of q * (n - 1), weighted
    low * (1 - f) + high * f with the weights computed in f32 as JAX does.
    A selection (kthvalue), not a sort, and not torch.quantile, which some
    versions refuse past 2^24 elements."""
    if dim is None:
        v = v.reshape(-1)
        dim = 0
    n = v.shape[dim]
    q = np.float32(np.float32(pct) / np.float32(100.0)) * np.float32(n - 1)
    lo, hi = int(np.clip(np.floor(q), 0, n - 1)), int(np.clip(np.ceil(q), 0, n - 1))
    hw = np.float32(q - np.floor(q))
    lw = np.float32(np.float32(1.0) - hw)
    low = torch.kthvalue(v, lo + 1, dim=dim).values
    high = low if hi == lo else torch.kthvalue(v, hi + 1, dim=dim).values
    return low * float(lw) + high * float(hw)


def _nhwc_rows(h: torch.Tensor) -> torch.Tensor:
    """|h| of an NCHW activation as (B*H*W, C) rows in NHWC order: the
    element order the JAX package's stride subsamples walk (a view when h
    is channels_last)."""
    return h.abs().permute(0, 2, 3, 1).reshape(-1, h.shape[1])


# per-tensor activation range rule, applied per block AFTER equalization
# (measured in the JAX package, yogo_tpu/ops/quant.py:156-177):
#
#     range = p99.5(|h|)  if absmax(|h|) > TAIL_RATIO * p99.5(|h|)
#             absmax(|h|) otherwise
ACT_CLIP_QUANTILE = 99.5
ACT_CLIP_TAIL_RATIO = 3.0


def calibrate_act_scales(
    folded,
    calib_batches: Iterable[Any],
    first_quant_block: int = 1,
    consumed=None,
    clip_quantile: Optional[float] = None,
    device=None,
) -> np.ndarray:
    """Per-block input activation range over the calibration set ->
    symmetric int8 scales (yogo_tpu/ops/quant.py:180-245). calib_batches
    yields NCHW input batches (uint8 images cast to f32, not normalized).
    Returns scales[i] for blocks first_quant_block..N-1 (the scale of the
    activation ENTERING block i). `consumed` restricts the zero-range check
    to the blocks the quantized program reads. Quantiles are taken on a
    <=1M-element stride subsample of the NHWC-flattened activation; across
    batches the range is the max."""
    device = resolve_device(device)
    n = len(folded)
    absmax = np.zeros(n, np.float64)
    params = _f32_blocks(folded, device)

    def range_of(h):
        flat = _nhwc_rows(h).reshape(-1)
        step = max(1, flat.numel() // 1_000_000)
        v = flat[::step]
        if clip_quantile is None:
            am = v.max()
            p = _percentile(v, ACT_CLIP_QUANTILE)
            return torch.where(am > ACT_CLIP_TAIL_RATIO * p, p, am)
        if clip_quantile >= 100.0:
            return flat.max()
        return _percentile(v, clip_quantile)

    seen = 0
    with torch.inference_mode(), no_tf32(device):
        for xb in calib_batches:
            ranges = np.zeros(n, np.float64)
            for i, h in _activations(params[: n - 1], to_nchw_f32(xb).to(device)):
                if i >= first_quant_block:
                    ranges[i] = float(range_of(h))
            absmax = np.maximum(absmax, ranges)
            seen += 1
    if seen == 0:
        raise ValueError("calibration requires at least one batch")
    bad = [
        i
        for i in range(first_quant_block, n)
        if (consumed is None or i in consumed) and absmax[i] <= 0
    ]
    if bad:
        raise ValueError(
            f"calibration produced a zero activation range entering quantized block(s) {bad}"
        )
    return (absmax[first_quant_block:] / 127.0).astype(np.float32)


# activations of trained conv stacks concentrate their range in a few
# channels; equalization rescales each such input channel INTO the adjacent
# weights - function-preserving - before per-tensor quantization
_HOMOGENEOUS_ACTS = (None, "relu", "leaky_relu")


def equalization_layout(defn, input_channels, skip) -> List[Tuple[int, int]]:
    """[(block_index, cin), ...] for the blocks that receive equalization
    vectors - a pure function of (defn, input_channels, skip)."""
    cins, cin = [], input_channels
    for s in defn.blocks:
        cins.append(cin)
        cin = s.out
    return [
        (i, cins[i])
        for i in range(1, len(defn.blocks))
        if i not in set(skip) and defn.blocks[i - 1].act in _HOMOGENEOUS_ACTS
    ]


def equalization_vectors(
    folded,
    calib_batches: Iterable[Any],
    skip,
    clip_quantile: float = 99.9,
    alpha: float = 0.5,
    device=None,
) -> Dict[int, np.ndarray]:
    """SmoothQuant-style per-input-channel equalization scales
    s_c = m_act_c^alpha / m_w_c^(1-alpha) for each quantized block whose
    preceding block ends in a positively homogeneous activation
    (yogo_tpu/ops/quant.py:273-330). m_act_c: the clip_quantile of |h| per
    channel over a <=200k-row stride subsample of the NHWC rows."""
    n = len(folded)
    quant_idx = [
        i for i in range(1, n) if i not in skip and folded[i - 1][0].act in _HOMOGENEOUS_ACTS
    ]
    if not quant_idx:
        return {}
    device = resolve_device(device)
    params = _f32_blocks(folded, device)
    m_act: Dict[int, np.ndarray] = {}
    seen = 0
    with torch.inference_mode(), no_tf32(device):
        for xb in calib_batches:
            for i, h in _activations(params[: max(quant_idx)], to_nchw_f32(xb).to(device)):
                if i not in quant_idx:
                    continue
                rows = _nhwc_rows(h)
                step = max(1, rows.shape[0] // 200_000)
                cur = _percentile(rows[::step], clip_quantile, dim=0).cpu().numpy().astype(np.float64)
                m_act[i] = np.maximum(m_act.get(i, 0.0), cur)
            seen += 1
    if seen == 0:
        raise ValueError("calibration requires at least one batch")

    out: Dict[int, np.ndarray] = {}
    for i in quant_idx:
        w_i = folded[i][1]  # HWIO
        m_w = np.max(np.abs(w_i), axis=(0, 1, 3))  # per input channel
        ma = np.maximum(m_act[i], 1e-5)
        mw = np.maximum(m_w, 1e-5)
        s = (ma ** alpha) / (mw ** (1.0 - alpha))
        out[i] = np.clip(s, 1e-4, 1e4).astype(np.float32)
    return out


def apply_equalization(folded, eq: Dict[int, np.ndarray]) -> None:
    """Fold the equalization scales into the weights IN PLACE: block i-1's
    output channels (weights + bias) divided by s, block i's input channels
    multiplied by s (yogo_tpu/ops/quant.py:333-343)."""
    for i, s in eq.items():
        spec_p, w_p, b_p = folded[i - 1]
        spec_i, w_i, b_i = folded[i]
        folded[i - 1] = (spec_p, w_p / s, b_p / s)
        folded[i] = (spec_i, w_i * s[None, None, :, None], b_i)


def quantize_weights(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """HWIO f32 -> (int8 HWIO, per-out-channel scale). Symmetric, round half
    to even (np.round, as jnp.round); an all-zero channel gets scale 1."""
    absmax = np.max(np.abs(w), axis=(0, 1, 2))
    sw = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / sw[None, None, None, :]), -127, 127).astype(np.int8)
    return q, sw


def default_skip_blocks(defn, input_channels: int = 1) -> Tuple[int, ...]:
    """Blocks kept in bf16 by default: block i > 0 is skipped iff its input
    has fewer than 128 channels, and the head always is
    (yogo_tpu/ops/quant.py:355-377, measured in the JAX package)."""
    skip = []
    cin = input_channels
    last = len(defn.blocks) - 1
    for i, s in enumerate(defn.blocks):
        if i > 0 and (cin < 128 or i == last):
            skip.append(i)
        cin = s.out
    return tuple(skip)


def family_quant_forward(model):
    """The quantized-forward function for this model's family, with the
    signature fwd(model, qp, x, *, inference=True, decode=True) for both."""
    if model.defn.family == "convnext":
        from yogo_tpu_torch.ops.quant_convnext import quantized_convnext_forward

        return quantized_convnext_forward
    return quantized_forward


def family_quant_plan(model, variables, device=None):
    """The one place the int8 family dispatch lives, shared by `infer
    --quantize`, `serve --quantize` and `test --quantize`. Returns
    (build_qp, fwd_quant, n_scales, all_skip):

      build_qp(calib_batches, act_scales=None) -> qp on `device`
      fwd_quant(model, qp, x, *, inference=True, decode=True)
      n_scales: length of qp["scales"] (the calibration payload)
      all_skip: True iff the program holds no int8 conv (calibration can
          be skipped entirely)
    """
    if model.defn.family == "convnext":
        from yogo_tpu_torch.ops.quant_convnext import quant_sites, quantize_convnext

        def build_convnext_qp(calib_batches, act_scales=None):
            return quantize_convnext(model, variables, calib_batches, act_scales=act_scales, device=device)

        # ConvNeXt-Small always has wide matmuls to quantize
        return build_convnext_qp, family_quant_forward(model), len(quant_sites()), False
    if model.defn.family != "conv_stack":
        raise ValueError(
            f"--quantize supports conv-stack models only (got {model.defn.family})"
        )
    skip = default_skip_blocks(model.defn, model.input_channels)
    n_scales = (len(model.defn.blocks) - 1) + sum(
        c for _, c in equalization_layout(model.defn, model.input_channels, skip)
    )

    def build_qp(calib_batches, act_scales=None):
        return quantize_conv_stack(
            model, variables, calib_batches, skip_blocks=skip, act_scales=act_scales, device=device
        )

    return build_qp, quantized_forward, n_scales, len(skip) == n_scales


def quantize_conv_stack(
    model,
    variables,
    calib_batches: Iterable[Any],
    skip_blocks: Iterable[int] = (),
    act_scales=None,
    device=None,
) -> Dict[str, Any]:
    """Build the int8 program's parameters for `quantized_forward` on
    `device` (default CUDA) (yogo_tpu/ops/quant.py:440-560).

    variables: the flax-layout tree or a ConvStack; calib_batches: NCHW
    input batches (uint8 or float, numpy or tensors); skip_blocks: block
    indices kept bf16; act_scales: a precomputed calibration payload (one
    per-tensor scale per block 1..N-1, then the equalization vectors in
    equalization_layout order; or the legacy (N-1,) scales alone), which
    skips calibration. Returns a dict of tensors:

      stem_w (C0, Cin, k, k) bf16, stem_b (C0,) f32,
      blocks[j] for block j+1: {"w": OIHW bf16, "b": f32} (bf16 block) or
          {"w8": packed (Cout, k, k, Cp) int8, "deq": f32, "b": f32},
      scales: the payload, f32.
    """
    device = resolve_device(device)
    skip = set(skip_blocks)
    if 0 in skip:
        raise ValueError("block 0 always runs bf16; skip_blocks indexes 1..N-1")
    folded = fold_conv_stack(model.defn, variables)
    valid = set(range(1, len(folded)))
    if not skip <= valid:
        raise ValueError(
            f"skip_blocks {sorted(skip - valid)} out of range; this "
            f"{len(folded)}-block model indexes 1..{len(folded) - 1}"
        )
    eq_layout = equalization_layout(model.defn, model.input_channels, skip)
    n_payload = (len(folded) - 1) + sum(c for _, c in eq_layout)
    if act_scales is not None:
        payload = np.asarray(act_scales, np.float32)
        if payload.shape == (n_payload,):
            tensor_scales = payload[: len(folded) - 1]
            eq: Dict[int, np.ndarray] = {}
            off = len(folded) - 1
            for i, c in eq_layout:
                eq[i] = payload[off : off + c]
                off += c
            apply_equalization(folded, eq)
        elif payload.shape == (len(folded) - 1,):
            # legacy payload without equalization vectors
            tensor_scales = payload
        else:
            raise ValueError(
                f"act_scales must be the calibration payload (shape "
                f"({n_payload},): one scale per block 1..{len(folded) - 1} "
                f"+ equalization vectors); got {payload.shape}"
            )
        if skip != valid and not np.all(
            tensor_scales[~np.isin(np.arange(1, len(folded)), sorted(skip))] > 0
        ):
            raise ValueError("act_scales has a zero scale for a quantized block")
    elif skip == valid:
        # no int8 conv in the program: no scale is consumed, so no
        # calibration forward runs; the payload keeps its layout
        warnings.warn(
            "every block is skipped (all input channels below the int8 "
            "payoff width): the quantized program contains no int8 convs "
            "and serves the BN-folded bf16 stack"
        )
        tensor_scales = payload = np.zeros(len(folded) - 1, np.float32)
    else:
        # two passes over the calibration set: per-channel ranges drive the
        # equalization fold, then per-tensor scales are calibrated on the
        # EQUALIZED stack (materialized once; generators don't rewind)
        batches = list(calib_batches)
        eq = equalization_vectors(folded, batches, skip, device=device)
        apply_equalization(folded, eq)
        tensor_scales = calibrate_act_scales(
            folded, batches, first_quant_block=1,
            consumed=set(range(1, len(folded))) - set(skip), device=device,
        )
        payload = np.concatenate(
            [np.asarray(tensor_scales, np.float32)] + [eq[i] for i, _ in eq_layout]
        ) if eq_layout else np.asarray(tensor_scales, np.float32)

    _, w0, b0 = folded[0]
    qp: Dict[str, Any] = {
        "stem_w": _oihw(w0, device).to(torch.bfloat16),
        "stem_b": _f32(b0, device),
        "blocks": [],
        "scales": _f32(payload, device),
    }
    for i in range(1, len(folded)):
        _, w, b = folded[i]
        if i in skip:
            qp["blocks"].append({"w": _oihw(w, device).to(torch.bfloat16), "b": _f32(b, device)})
            continue
        q, sw = quantize_weights(w)
        qp["blocks"].append({
            "w8": pack_weights(q).to(device),
            # dequant factor s_in * s_w[c]; the bias stays separate
            "deq": _f32(tensor_scales[i - 1] * sw, device),
            "b": _f32(b, device),
        })
    return qp


def _block0(model: YOGO, qp, x: torch.Tensor, to_bf16: bool) -> torch.Tensor:
    """Block 0 of the int8 program: the fused stem kernel with the
    bf16-rounded folded weights when the next block is bf16 and the input
    is raw uint8 (bf16 channels_last out); else the f32 conv over the
    bf16-rounded input and weights (f32 out)."""
    spec = model.defn.blocks[0]
    w, b = qp["stem_w"], qp["stem_b"]
    if to_bf16 and model.stem_kernel_takes(x):
        w9 = w.float().reshape(w.shape[0], 9)
        return fused_stem_nchw(x[:, 0].contiguous(), w9, b, layout="nhwc")
    xf = x if x.is_floating_point() else x.float()
    xf = xf.to(torch.bfloat16).float().contiguous(memory_format=torch.channels_last)
    return _act(spec.act, _conv(xf, w.float(), spec) + b.view(1, -1, 1, 1))


def _bf16_block(h: torch.Tensor, blk, spec: ConvSpec) -> torch.Tensor:
    """A skipped block, f32 out: act(conv(bf16(h), w_bf16) + b), the conv
    in f32 over the bf16-rounded operands."""
    b = blk["b"].view(1, -1, 1, 1)
    return _act(spec.act, _conv(h.to(torch.bfloat16).float(), blk["w"].float(), spec) + b)


def requant_nhwc(h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """f32 h -> int8 codes clip(rint(h / s), -127, 127) (round half to
    even, as jnp.round), in h's layout."""
    return torch.div(h.float(), s).round_().clamp_(-127, 127).to(torch.int8)


def requant(h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The entry requant into a quantized block: f32 NCHW h -> int8 NHWC
    codes, channels padded with zero codes to the kernel's multiple of 32."""
    q = requant_nhwc(h.permute(0, 2, 3, 1), s)
    c = q.shape[-1]
    return F.pad(q, (0, padded_channels(c) - c)).contiguous()


def quantized_forward(
    model: YOGO,
    qp: Dict[str, Any],
    x: torch.Tensor,
    *,
    inference: bool = True,
    decode: bool = True,
    record: Optional[list] = None,
) -> torch.Tensor:
    """Int8 inference forward (yogo_tpu/ops/quant.py:563-618): raw input
    (NCHW, uint8 or float, on qp's device) -> decoded (B, 5+C, Sy, Sx), or
    with decode=False the undecoded NHWC head (B, Sy, Sx, 5+C) in f32.
    Blocks whose qp entry holds "w8" run s8 x s8 -> s32 through the int8
    conv kernel; the activation between blocks is f32 (the JAX default
    intermediate_dtype). `record`, if a list, receives the int8 codes
    entering each quantized block, (B, H, W, Cin) NHWC."""
    specs = model.defn.blocks
    blocks = qp["blocks"]
    scales = qp["scales"]
    x = YOGO._to_nchw(x)
    with torch.inference_mode(), no_tf32(x.device):
        h = _block0(model, qp, x, to_bf16="w8" not in blocks[0])
        for j, blk in enumerate(blocks):
            spec = specs[1 + j]
            if "w8" not in blk:
                h = _bf16_block(h, blk, spec)
                continue
            cin = specs[j].out
            q = h if h.dtype == torch.int8 else requant(h, scales[j])
            if record is not None:
                record.append(q[..., :cin])
            nxt = blocks[j + 1] if j + 1 < len(blocks) else None
            out_s8 = nxt is not None and "w8" in nxt
            h = int8_conv(
                q, blk["w8"], blk["deq"], blk["b"], cin=cin, stride=spec.stride,
                padding=spec.padding, act=spec.act,
                out_scale=scales[j + 1 : j + 2] if out_s8 else None,
            )
            if not out_s8:
                h = h.permute(0, 3, 1, 2)  # NCHW view of the NHWC f32 output
        raw = h.permute(0, 2, 3, 1)
        if not decode:
            return raw
        return model._decode_raw(raw, inference)

