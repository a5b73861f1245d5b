"""Paired image + label-grid flips on whole batches (port of
yogo_tpu/data/transforms.py). They run on the device inside the train step.

Label grid layout (B, 6, Sy, Sx): [mask, x1, y1, x2, y2, class]; a
horizontal flip maps x -> 1 - x (new x1 = 1 - old x2) and reverses the Sx
axis; vertical likewise. Empty cells stay zero through the mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def hflip(images: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip a whole batch horizontally. images (B, C, H, W), labels (B, 6, Sy, Sx)."""
    mask, x1, y1, x2, y2, cls = labels.unbind(1)
    labels = torch.stack([mask, (1.0 - x2) * mask, y1, (1.0 - x1) * mask, y2, cls], dim=1)
    return images.flip(3), labels.flip(3)


def vflip(images: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip a whole batch vertically."""
    mask, x1, y1, x2, y2, cls = labels.unbind(1)
    labels = torch.stack([mask, x1, (1.0 - y2) * mask, x2, (1.0 - y1) * mask, cls], dim=1)
    return images.flip(2), labels.flip(2)


def apply_flips(
    images: torch.Tensor, labels: torch.Tensor, do_h: bool, do_v: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flips of random_flips for two given decisions."""
    if do_h:
        images, labels = hflip(images, labels)
    if do_v:
        images, labels = vflip(images, labels)
    return images, labels


def flip_coins(generator: Optional[torch.Generator], p: float = 0.5) -> Tuple[bool, bool]:
    """(do_h, do_v): one coin per batch per axis, from `generator` (on its
    own device; None draws from torch's global CPU generator)."""
    device = "cpu" if generator is None else generator.device
    u = torch.rand(2, generator=generator, device=device).tolist()
    return u[0] < p, u[1] < p


def random_flips(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    labels: torch.Tensor,
    p: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-level random horizontal + vertical flips, each with
    probability p (reference: yogo/data/yogo_dataloader.py:203-210)."""
    return apply_flips(images, labels, *flip_coins(generator, p))
