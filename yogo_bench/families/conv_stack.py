"""The conv stack of czbiohub-sf/yogo (yogo/model_defns.py): blocks of
conv, optional BN, LeakyReLU(0.01) and channel dropout, as the
configuration's `blocks` list them. The BN is applied as a BN, not
folded."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from yogo_bench.weights import Spec

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5


def spec(cfg: dict) -> Spec:
    """A conv stack's initial state, as the reference yogo/model.py:79-87
    inits it: conv kernels Kaiming-normal in fan-out mode with the
    LeakyReLU(0.01) gain, zero biases, BN scale 1 and bias 0, running mean
    0 and variance 1."""
    out: Spec = []
    cin = 1
    gain = math.sqrt(2.0 / (1.0 + LEAKY_SLOPE ** 2))
    for i, b in enumerate(cfg["blocks"]):
        k, cout = b["kernel"], b["out"]
        out.append((f"conv{i}.weight", (cout, cin, k, k), "normal", gain / math.sqrt(cout * k * k)))
        if b["bias"]:
            out.append((f"conv{i}.bias", (cout,), "const", 0.0))
        if b["bn"]:
            out += [(f"bn{i}.weight", (cout,), "const", 1.0), (f"bn{i}.bias", (cout,), "const", 0.0),
                    (f"bn{i}.running_mean", (cout,), "const", 0.0),
                    (f"bn{i}.running_var", (cout,), "const", 1.0)]
        cin = cout
    return out


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, *, cast, train: bool = False,
            masks: Optional[Dict[int, torch.Tensor]] = None) -> torch.Tensor:
    """(B, 1, H, W) float32 pixels -> (B, Sy, Sx, 5+C) head. train=True
    normalises BN with the batch's statistics (biased variance) and
    applies the channel-dropout masks {block: (B, C, 1, 1)}."""
    for i, b in enumerate(cfg["blocks"]):
        bias = w.get(f"conv{i}.bias")
        x = F.conv2d(cast(x), cast(w[f"conv{i}.weight"]), bias, b["stride"], b["padding"])
        if b["bn"]:
            if train:
                mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
            else:
                mean, var = w[f"bn{i}.running_mean"], w[f"bn{i}.running_var"]
            scale = w[f"bn{i}.weight"] / torch.sqrt(var + BN_EPS)
            x = (x - mean[:, None, None]) * scale[:, None, None] + w[f"bn{i}.bias"][:, None, None]
        if b["act"] == "leaky_relu":
            x = F.leaky_relu(x, LEAKY_SLOPE)
        elif b["act"] is not None:
            raise ValueError(f"unknown activation {b['act']}")
        if train and masks and i in masks:
            x = x * masks[i]
    return x.permute(0, 2, 3, 1)


def grid(cfg: dict) -> Tuple[int, int]:
    """(Sx, Sy): the frame folded through each block's conv."""
    h, w = cfg["img_size"]
    for b in cfg["blocks"]:
        h = (h + 2 * b["padding"] - b["kernel"]) // b["stride"] + 1
        w = (w + 2 * b["padding"] - b["kernel"]) // b["stride"] + 1
    return w, h


def macs_per_image(cfg: dict) -> int:
    h, w = cfg["img_size"]
    total, cin = 0, 1
    for b in cfg["blocks"]:
        h = (h + 2 * b["padding"] - b["kernel"]) // b["stride"] + 1
        w = (w + 2 * b["padding"] - b["kernel"]) // b["stride"] + 1
        total += h * w * b["out"] * cin * b["kernel"] ** 2
        cin = b["out"]
    return total
