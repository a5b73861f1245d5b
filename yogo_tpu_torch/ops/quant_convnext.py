"""Post-training int8 quantization for the convnext family (port of
yogo_tpu/ops/quant_convnext.py; same sites, same scheme, same payload).

The wide matmuls of ConvNeXt-Small are its int8 sites: the pointwise Dense
layers of each block (dim -> 4 dim -> dim) and the 2x2 stride-2 downsample
convs, each kept only if its input has at least MIN_CIN (128) channels: 71
of the 75 (`quant_sites`; stage 0's pwconv1 and down1 have 96 inputs).
Everything else stays float, as in the JAX program:

  - the patchify stem, the 7x7 depthwise convs, the skipped sites, the 1x1
    format head and the stride-4 transpose upsample compute with bf16
    operands, f32 accumulation and an f32 output (no rounding of the
    result): here f32 convs / matmuls over the bf16-rounded operands with
    TF32 off (cuDNN's and cuBLAS's bf16 kernels round their output);
  - the LayerNorms (models/yogo.layer_norm, flax's formula) and the GELU run
    in f32, and so does the residual stream between blocks.

Scheme: weights per-output-channel symmetric int8 (quant.quantize_weights
on the flax-layout kernel); activations per-tensor symmetric int8 with
scale = absmax / 127 over the calibration batches, taken on the f32
functional forward (`float_forward`) at the tensor entering each site. No
percentile clip and no equalization: LayerNorm feeds most sites.

Each int8 site requantizes its f32 NHWC input, clip(rint(h / s), -127, 127)
(round half to even, as jnp.round), and launches the int8 conv kernel
(ops/int8_conv.py) with no activation and an f32 output, float(acc) * deq
+ b: a Dense is its 1x1 conv over the NHWC codes, a downsample the
(2, 2, 0) conv. All ConvNeXt widths are multiples of 32, so the codes need
no channel padding.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yogo_tpu_torch.models.yogo import (
    CONVNEXT_DEPTHS as DEPTHS,
    CONVNEXT_DIMS as DIMS,
    YOGO,
    layer_norm,
    no_tf32,
    resolve_device,
    run_convnext,
)
from yogo_tpu_torch.ops.int8_conv import int8_conv, pack_weights
from yogo_tpu_torch.ops.quant import quantize_weights, requant_nhwc, to_nchw_f32
from yogo_tpu_torch.utils.weights import state_dict_from_flax

# minimum matmul input width for int8 (the JAX package's measured rule,
# the same as quant.default_skip_blocks)
MIN_CIN = 128

Site = Callable[[str, torch.Tensor, Optional[int]], torch.Tensor]


def quant_sites(
    depths: Tuple[int, ...] = DEPTHS, dims: Tuple[int, ...] = DIMS, min_cin: int = MIN_CIN
) -> List[Tuple[str, int]]:
    """Ordered (site key, input width) of every int8 matmul, in forward
    order: the calibration, the scales vector and the quantized forward
    index sites by position in this list."""
    sites: List[Tuple[str, int]] = []
    for s, (depth, dim) in enumerate(zip(depths, dims)):
        if s > 0:
            sites.append((f"down{s}_conv", dims[s - 1]))
        for b in range(depth):
            sites.append((f"stage{s}_block{b}/pwconv1", dim))
            sites.append((f"stage{s}_block{b}/pwconv2", 4 * dim))
    return [(k, c) for k, c in sites if c >= min_cin]


def _module(key: str) -> str:
    """Site key -> the torch module name of its weights."""
    return key.replace("/", ".")


def _round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t's values rounded to `dtype`, as float32."""
    return t.float() if dtype == torch.float32 else t.to(dtype).float()


class SiteLayers:
    """ConvNeXt-Small's layer steps (models/yogo.ConvNeXtLayers' names,
    composed by models/yogo.run_convnext, or over row shards by
    parallel/spatial.RowSplit) as the functional twin of the module
    (inference) over `p`, the module's state_dict tensors, on NHWC
    activations. Float convs take operands rounded to `cdt` and give f32.
    Each site is two steps: `site_in` on the rows its input is computed
    at, `site_conv` on the rows (a downsample's window) the matmul reads;
    here site_in is the identity and site_conv the callback
    site(key, h, stride) -> f32 NHWC (stride None for a Dense, 2 for a
    downsample)."""

    def __init__(self, p: Dict[str, torch.Tensor], site: Optional[Site], cdt: torch.dtype):
        self.p, self.site, self.cdt = p, site, cdt

    def site_in(self, key: str, h: torch.Tensor) -> torch.Tensor:
        return h

    def site_conv(self, key: str, h: torch.Tensor, stride: Optional[int]) -> torch.Tensor:
        return self.site(key, h, stride)

    def _conv(self, h_nhwc, name, stride=1, padding=0, groups=1):
        p, cdt = self.p, self.cdt
        y = F.conv2d(_round_to(h_nhwc, cdt).permute(0, 3, 1, 2), _round_to(p[f"{name}.weight"], cdt),
                     None, stride, padding, 1, groups)
        return y.permute(0, 2, 3, 1) + p[f"{name}.bias"]

    def _norm(self, h, name):
        return layer_norm(h, self.p[f"{name}.weight"], self.p[f"{name}.bias"])

    def stem_conv(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x.permute(0, 2, 3, 1), "stem_conv", stride=4)

    def stem_norm(self, h: torch.Tensor) -> torch.Tensor:
        return self._norm(h, "stem_norm")

    def down_in(self, s: int, h: torch.Tensor) -> torch.Tensor:
        return self.site_in(f"down{s}_conv", self._norm(h, f"down{s}_norm"))

    def down_conv(self, s: int, h: torch.Tensor) -> torch.Tensor:
        return self.site_conv(f"down{s}_conv", h, 2)

    def dw(self, s: int, b: int, h: torch.Tensor) -> torch.Tensor:
        return self._conv(h, f"stage{s}_block{b}.dwconv", padding=3, groups=DIMS[s])

    def rest(self, s: int, b: int, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        blk = f"stage{s}_block{b}"
        h = self._norm(h, f"{blk}.norm")
        key = f"{blk}/pwconv1"
        h = F.gelu(self.site_conv(key, self.site_in(key, h), None), approximate="none")
        key = f"{blk}/pwconv2"
        return x + self.p[f"{blk}.gamma"] * self.site_conv(key, self.site_in(key, h), None)

    def block(self, s: int, b: int, x: torch.Tensor) -> torch.Tensor:
        return self.rest(s, b, x, self.dw(s, b, x))

    def head(self, h: torch.Tensor) -> torch.Tensor:
        p, cdt = self.p, self.cdt
        h = self._conv(h, "format_conv").permute(0, 3, 1, 2)
        up = F.conv_transpose2d(_round_to(h, cdt), _round_to(p["format_up.weight"], cdt), None, 4)
        return up.permute(0, 2, 3, 1) + p["format_up.bias"]


def _forward(p: Dict[str, torch.Tensor], x: torch.Tensor, site: Site, cdt: torch.dtype) -> torch.Tensor:
    """Functional twin of models/yogo.ConvNeXtSmall (inference) with every
    site routed through `site(key, h, stride)` (SiteLayers). x: NCHW float.
    Returns the f32 NHWC head."""
    return run_convnext(SiteLayers(p, site, cdt), x, DEPTHS)


class QuantLayers(SiteLayers):
    """The int8 program's layer steps: an int8 site requantizes its f32
    input (`site_in`, clip(rint(h / s), -127, 127); the codes appended to
    `record` if a list) and launches the int8 conv kernel on the codes
    (`site_conv`: a Dense is its 1x1 conv, a downsample the (2, 2, 0)
    conv, f32 out); a site that is not int8 is the bf16 float site. So a
    row shard requantizes the rows it owns, and a downsample's window
    gathers codes."""

    def __init__(self, qp: Dict[str, Any], record: Optional[list] = None):
        int8, flt = qp["int8"], qp["float"]
        keys = [k for k, _ in quant_sites(min_cin=0) if k in int8]
        if len(keys) != len(int8):
            raise ValueError("qp['int8'] has keys outside the known site set")
        super().__init__(flt, _float_site(flt, torch.bfloat16), torch.bfloat16)
        self.int8, self.scales, self.record = int8, qp["scales"], record
        self.index = {k: i for i, k in enumerate(keys)}

    def site_in(self, key: str, h: torch.Tensor) -> torch.Tensor:
        if key not in self.int8:
            return h
        q = requant_nhwc(h, self.scales[self.index[key]])
        if self.record is not None:
            self.record.append(q)
        return q

    def site_conv(self, key: str, h: torch.Tensor, stride: Optional[int]) -> torch.Tensor:
        if key not in self.int8:
            return self.site(key, h, stride)
        blk = self.int8[key]
        return int8_conv(h.contiguous(), blk["w8"], blk["deq"], blk["b"], cin=h.shape[-1],
                         stride=stride or 1, padding=0, act=None)


def _float_site(p: Dict[str, torch.Tensor], cdt: torch.dtype) -> Site:
    """site() computing the matmul in float: operands rounded to `cdt`,
    f32 accumulation and output, then the f32 bias."""

    def site(key, h, stride):
        name = _module(key)
        w, hq = _round_to(p[f"{name}.weight"], cdt), _round_to(h, cdt)
        if stride is None:
            out = F.linear(hq, w)
        else:
            out = F.conv2d(hq.permute(0, 3, 1, 2), w, None, stride).permute(0, 2, 3, 1)
        return out + p[f"{name}.bias"]

    return site


def _params(variables, device) -> Dict[str, torch.Tensor]:
    """The module's float32 tensors by state_dict name on `device`, from a
    ConvNeXtSmall or the flax-layout tree load_any returns."""
    sd = variables.state_dict() if isinstance(variables, nn.Module) else state_dict_from_flax(variables)
    return {k: v.detach().to(device=device, dtype=torch.float32) for k, v in sd.items()}


def float_forward(variables, x, device=None) -> torch.Tensor:
    """The f32 functional forward (TF32 off) on `device` (default CUDA):
    the reference the calibration scales describe. x: NCHW (uint8 cast,
    not normalized). Returns the f32 NHWC head."""
    device = resolve_device(device)
    p = _params(variables, device)
    with torch.inference_mode(), no_tf32(device):
        return _forward(p, to_nchw_f32(x).to(device), _float_site(p, torch.float32), torch.float32)


def calibrate_act_scales(
    variables, calib_batches: Iterable[Any], min_cin: int = MIN_CIN, device=None
) -> np.ndarray:
    """Per-site input absmax over the calibration batches (NCHW, uint8 cast
    to f32, not normalized) on the f32 functional forward -> symmetric int8
    scales absmax / 127, one per quant_sites() entry in forward order."""
    keys = [k for k, _ in quant_sites(min_cin=min_cin)]
    if not keys:
        return np.zeros(0, np.float32)
    device = resolve_device(device)
    p = _params(variables, device)
    float_site = _float_site(p, torch.float32)
    absmax = np.zeros(len(keys), np.float64)
    seen = 0
    with torch.inference_mode(), no_tf32(device):
        for xb in calib_batches:
            taps: Dict[str, torch.Tensor] = {}

            def site(key, h, stride):
                if key in taps:
                    raise ValueError(f"duplicate site {key}")
                taps[key] = h.abs().max()
                return float_site(key, h, stride)

            _forward(p, to_nchw_f32(xb).to(device), site, torch.float32)
            batch = torch.stack([taps[k] for k in keys]).double().cpu().numpy()
            absmax = np.maximum(absmax, batch)
            seen += 1
    if seen == 0:
        raise ValueError("calibration requires at least one batch")
    if not np.all(absmax > 0):
        dead = [keys[i] for i in np.nonzero(absmax == 0)[0]]
        raise ValueError(f"calibration produced a zero activation range: {dead}")
    return (absmax / 127.0).astype(np.float32)


def _hwio(name: str, w: torch.Tensor) -> np.ndarray:
    """A site's torch weight -> its flax-layout kernel as an HWIO array:
    a Dense (O, I) as (1, 1, I, O), a conv (O, I, kh, kw) as (kh, kw, I, O)."""
    a = w.detach().cpu().numpy().astype(np.float32)
    return a.T[None, None] if a.ndim == 2 else a.transpose(2, 3, 1, 0)


def quantize_convnext(
    model: YOGO,
    variables,
    calib_batches: Iterable[Any],
    act_scales=None,
    min_cin: int = MIN_CIN,
    device=None,
) -> Dict[str, Any]:
    """The int8 program of a convnext model for quantized_convnext_forward,
    on `device` (default CUDA) (yogo_tpu/ops/quant_convnext.py:quantize_convnext).

    variables: a ConvNeXtSmall or the flax-layout tree; calib_batches: NCHW
    input batches; act_scales: precomputed per-site scales (qp["scales"]),
    which skip calibration. Returns

      float: {state_dict name: tensor} of every parameter outside the int8
          sites, conv / Dense weights bf16, norms, biases and gamma f32;
      int8: {site key: {"w8": packed (Cout, k, k, Cin) int8,
          "deq": s_in * s_w (Cout,) f32, "b": (Cout,) f32}};
      scales: (n_sites,) f32."""
    if model.defn.family != "convnext":
        raise NotImplementedError(
            f"quantize_convnext supports the convnext family only (got {model.defn.family}); "
            "use quantize_conv_stack"
        )
    device = resolve_device(device)
    keys = [k for k, _ in quant_sites(min_cin=min_cin)]
    p = _params(variables, device)
    missing = [k for k in keys if f"{_module(k)}.weight" not in p]
    if missing:
        raise NotImplementedError(
            f"quantize_convnext is pinned to the ConvNeXt-Small geometry (DEPTHS={DEPTHS}, "
            f"DIMS={DIMS}); this model lacks site(s) {missing[:3]}"
        )
    if act_scales is not None:
        scales = np.asarray(act_scales, np.float32)
        if scales.shape != (len(keys),):
            raise ValueError(
                f"act_scales must have one entry per quantized site (shape ({len(keys)},)); "
                f"got {scales.shape}"
            )
        if not np.all(scales > 0):
            raise ValueError("act_scales has a zero scale for a quantized site")
    else:
        scales = calibrate_act_scales(variables, calib_batches, min_cin=min_cin, device=device)

    int8: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, key in enumerate(keys):
        name = _module(key)
        q, sw = quantize_weights(_hwio(name, p[f"{name}.weight"]))
        int8[key] = {
            "w8": pack_weights(q).to(device),
            "deq": torch.from_numpy(scales[i] * sw).to(device),
            "b": p[f"{name}.bias"].clone(),
        }
    sites = {_module(k) for k in int8}
    flt = {}
    for k, v in p.items():
        module, leaf = k.rsplit(".", 1)
        if module in sites:
            continue
        is_kernel = leaf == "weight" and v.dim() > 1  # a conv or Dense, not a norm
        flt[k] = v.to(torch.bfloat16) if is_kernel else v
    return {"float": flt, "int8": int8, "scales": torch.from_numpy(scales.copy()).to(device)}


def quantized_convnext_forward(
    model: YOGO,
    qp: Dict[str, Any],
    x: torch.Tensor,
    *,
    inference: bool = True,
    decode: bool = True,
    record: Optional[list] = None,
) -> torch.Tensor:
    """Int8 inference forward (yogo_tpu/ops/quant_convnext.py:
    quantized_convnext_forward): raw input (NCHW, uint8 or float, on qp's
    device) -> decoded (B, 5+C, Sy, Sx), or with decode=False the undecoded
    NHWC head (B, Sy, Sx, 5+C) in f32. The residual stream is f32 (the
    JAX default intermediate_dtype). `record`, if a list, receives the
    int8 codes entering each int8 site, NHWC, in site order."""
    x = YOGO._to_nchw(x)
    with torch.inference_mode(), no_tf32(x.device):
        raw = run_convnext(QuantLayers(qp, record), x.float(), DEPTHS)
        if not decode:
            return raw
        return model._decode_raw(raw, inference)
