"""ConvNeXt-Small as the trunk of YOGO (Liu et al. 2022, through timm's
convnext_small as czbiohub-sf/yogo's model_defns.py builds it): a
patchify stem, four stages of blocks with downsampling between them, and
YOGO's 1x1 format conv and 4x4 stride-4 transpose conv as the head."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from yogo_bench.weights import Spec


def spec(cfg: dict) -> Spec:
    """ConvNeXt-Small's weights as the configuration file states them
    (`init`): truncated-normal kernels of variance 1 / fan-in (flax's
    lecun_normal), biases normal with std init.bias_std, LayerNorms 1 / 0,
    the layer scale `gamma` uniform in init.layer_scale, and the head's
    objectness set for production density (weights.production_density)."""
    init = cfg["init"]
    dims, depths, k_dw, ratio = cfg["dims"], cfg["depths"], cfg["dw_kernel"], cfg["mlp_ratio"]
    nout, patch = 5 + cfg["num_classes"], cfg["patch"]
    bstd = init["bias_std"]
    out: Spec = []

    def conv(name, cout, cin, k, groups=1):
        fan_in = cin // groups * k * k
        out.append((f"{name}.weight", (cout, cin // groups, k, k), "trunc", 1.0 / math.sqrt(fan_in)))
        out.append((f"{name}.bias", (cout,), "normal", bstd))

    def norm(name, d):
        out.extend([(f"{name}.weight", (d,), "const", 1.0), (f"{name}.bias", (d,), "const", 0.0)])

    conv("stem_conv", dims[0], 1, patch)
    norm("stem_norm", dims[0])
    for s, (depth, d) in enumerate(zip(depths, dims)):
        if s > 0:
            norm(f"down{s}_norm", dims[s - 1])
            conv(f"down{s}_conv", d, dims[s - 1], 2)
        for b in range(depth):
            p = f"stage{s}_block{b}"
            conv(f"{p}.dwconv", d, d, k_dw, groups=d)
            norm(f"{p}.norm", d)
            out.append((f"{p}.pwconv1.weight", (ratio * d, d), "trunc", 1.0 / math.sqrt(d)))
            out.append((f"{p}.pwconv1.bias", (ratio * d,), "normal", bstd))
            out.append((f"{p}.pwconv2.weight", (d, ratio * d), "trunc", 1.0 / math.sqrt(ratio * d)))
            out.append((f"{p}.pwconv2.bias", (d,), "normal", bstd))
            out.append((f"{p}.gamma", (d,), "uniform", tuple(init["layer_scale"])))
    conv("format_conv", nout, dims[-1], 1)
    out.append(("format_up.weight", (nout, nout, 4, 4), "trunc", 1.0 / math.sqrt(nout * 16)))
    out.append(("format_up.bias", (nout,), "normal", bstd))
    return out


def _ln(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)


def _conv_nhwc(x, w, name, stride, cast, padding=0, groups=1):
    y = F.conv2d(cast(x.permute(0, 3, 1, 2)), cast(w[f"{name}.weight"]), w[f"{name}.bias"],
                 stride, padding, 1, groups)
    return y.permute(0, 2, 3, 1)


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, *, cast, train: bool = False,
            masks=None) -> torch.Tensor:
    """(B, 1, H, W) float32 pixels -> (B, Sy, Sx, 5+C) head: patchify
    stem + LayerNorm, four stages of blocks (7x7 depthwise conv, LayerNorm,
    Dense 4x, exact GELU, Dense back, layer scale, residual) with LayerNorm
    + 2x2 stride-2 conv between them, a 1x1 conv to 5+C and a 4x4 stride-4
    transpose conv. No training path."""
    if train:
        raise NotImplementedError("the convnext family has no training path")
    eps, k = cfg["ln_eps"], cfg["dw_kernel"]
    h = F.conv2d(cast(x), cast(w["stem_conv.weight"]), w["stem_conv.bias"], cfg["patch"])
    h = _ln(h.permute(0, 2, 3, 1), w, "stem_norm", eps)
    for s, depth in enumerate(cfg["depths"]):
        if s > 0:
            h = _conv_nhwc(_ln(h, w, f"down{s}_norm", eps), w, f"down{s}_conv", 2, cast)
        for b in range(depth):
            p = f"stage{s}_block{b}"
            y = _conv_nhwc(h, w, f"{p}.dwconv", 1, cast, padding=k // 2, groups=h.shape[-1])
            y = _ln(y, w, f"{p}.norm", eps)
            y = F.gelu(F.linear(cast(y), cast(w[f"{p}.pwconv1.weight"]), w[f"{p}.pwconv1.bias"]))
            y = F.linear(cast(y), cast(w[f"{p}.pwconv2.weight"]), w[f"{p}.pwconv2.bias"])
            h = h + w[f"{p}.gamma"] * y
    y = F.conv2d(cast(h.permute(0, 3, 1, 2)), cast(w["format_conv.weight"]), w["format_conv.bias"])
    y = F.conv_transpose2d(cast(y), cast(w["format_up.weight"]), w["format_up.bias"], 4)
    return y.permute(0, 2, 3, 1)


def grid(cfg: dict) -> Tuple[int, int]:
    """(Sx, Sy): the stage-4 map after the patchify stem and three 2x2
    stride-2 downsamples, upsampled 4x by the transpose conv."""
    h, w = cfg["img_size"]
    h, w = h // cfg["patch"], w // cfg["patch"]
    for _ in cfg["depths"][1:]:
        h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    return 4 * w, 4 * h


def macs_per_image(cfg: dict) -> int:
    h, w = cfg["img_size"]
    dims, k, r, p = cfg["dims"], cfg["dw_kernel"], cfg["mlp_ratio"], cfg["patch"]
    h, w = h // p, w // p
    total = h * w * dims[0] * p * p
    for s, (depth, d) in enumerate(zip(cfg["depths"], dims)):
        if s > 0:
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
            total += h * w * d * dims[s - 1] * 4
        total += depth * h * w * (d * k * k + 2 * r * d * d)
    nout = 5 + cfg["num_classes"]
    total += h * w * nout * dims[-1]  # 1x1 format conv
    total += h * w * nout * nout * 16  # 4x4 stride-4 transpose: each input pixel feeds 16 outputs
    return total
