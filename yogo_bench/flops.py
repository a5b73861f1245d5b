"""Operations and bytes counted from a configuration's shapes: the model
FLOPs of an image (2 x multiply-accumulates of every conv and Dense layer;
norms, activations and the decode are not counted) and the bytes the stem
kernel has to move."""

from __future__ import annotations

from yogo_bench.reference import grid


def macs_per_image(cfg: dict) -> int:
    """Multiply-accumulates of one image's forward pass."""
    h, w = cfg["img_size"]
    if cfg["family"] == "convnext":
        return _convnext_macs(cfg, h, w)
    total, cin = 0, 1
    for b in cfg["blocks"]:
        h = (h + 2 * b["padding"] - b["kernel"]) // b["stride"] + 1
        w = (w + 2 * b["padding"] - b["kernel"]) // b["stride"] + 1
        total += h * w * b["out"] * cin * b["kernel"] ** 2
        cin = b["out"]
    return total


def _convnext_macs(cfg: dict, h: int, w: int) -> int:
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


def flops_per_image(cfg: dict) -> int:
    return 2 * macs_per_image(cfg)


def stem_bytes(cfg: dict, batch: int) -> int:
    """Bytes the fused stem kernel moves at least: the uint8 frames read
    once and block 0's bf16 NHWC output written once (the weights are
    under a kilobyte)."""
    h, w = cfg["img_size"]
    b0 = cfg["blocks"][0]
    ho = (h + 2 * b0["padding"] - b0["kernel"]) // b0["stride"] + 1
    wo = (w + 2 * b0["padding"] - b0["kernel"]) // b0["stride"] + 1
    return batch * (h * w + ho * wo * b0["out"] * 2)


__all__ = ["macs_per_image", "flops_per_image", "stem_bytes", "grid"]
