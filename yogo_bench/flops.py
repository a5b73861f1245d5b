"""Operations and bytes counted from a configuration's shapes: the model
FLOPs of an image (2 x multiply-accumulates of every conv and Dense layer;
norms, activations and the decode are not counted) and the bytes the stem
kernel has to move."""

from __future__ import annotations

from yogo_bench import manifest
from yogo_bench.reference import grid


def macs_per_image(cfg: dict) -> int:
    """Multiply-accumulates of one image's forward pass (the family's count)."""
    return manifest.family(cfg["family"]).macs_per_image(cfg)


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
