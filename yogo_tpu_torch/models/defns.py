"""Declarative backbone registry (copy of yogo_tpu/models/defns.py, plus
`swin_small` and `vitdet_base`, which only the port has).

The reference defines 12 architectures as hand-written torch nn.Sequential
stacks (reference: yogo/model_defns.py:30-558). Here each architecture is a
*data* description - a tuple of ConvSpec - consumed by one nn.Module
(models.yogo.ConvStack), and grid-size arithmetic (ops.grid.grid_size) folds
over the same specs the model runs. The convnext, swin and vitdet families
run modules of their own; their specs carry only the grid arithmetic.

Registry semantics match the reference exactly: ``get_model_defn(None)`` and
unknown names fall back to base_model (reference: yogo/model_defns.py:11-18).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple


@dataclass(frozen=True)
class ConvSpec:
    """One conv block: conv (+BN) (+activation) (+channel dropout)."""

    out: int
    kernel: int = 3
    stride: int = 1
    padding: int = 1
    bias: bool = True
    bn: bool = False
    act: Optional[str] = "leaky_relu"
    dropout: float = 0.0
    transpose: bool = False
    output_padding: int = 0


@dataclass(frozen=True)
class ModelDefn:
    """A named stack of conv blocks ending in a 1x1 head producing 5+C channels."""

    name: str
    blocks: Tuple[ConvSpec, ...]
    # non-conv-stack architectures (convnext) carry an extra tag
    family: str = "conv_stack"

    @property
    def head_index(self) -> int:
        return len(self.blocks) - 1


DefnBuilder = Callable[[int, bool], ModelDefn]

MODELS: Dict[str, DefnBuilder] = {}


def register_model(builder: DefnBuilder) -> DefnBuilder:
    MODELS[builder.__name__] = builder
    return builder


@contextlib.contextmanager
def temporary_model(builder: DefnBuilder) -> Iterator[DefnBuilder]:
    """Scoped registration for experiment-only architectures (e.g. the
    zero-dropout head-to-head variant): the builder is visible to
    get_model_defn inside the block and guaranteed gone afterwards, so the
    process-wide registry always ends with exactly the registered models
    regardless of tool/test import order."""
    name = builder.__name__
    prev = MODELS.get(name)
    MODELS[name] = builder
    try:
        yield builder
    finally:
        if prev is None:
            MODELS.pop(name, None)
        else:  # pragma: no cover - shadowed registration
            MODELS[name] = prev


def get_model_defn(model_name: Optional[str]) -> DefnBuilder:
    """Name -> builder; None or unknown names fall back to base_model."""
    if model_name is None:
        return base_model
    return MODELS.get(model_name, base_model)


def _scaled_stack(
    name: str, num_classes: int, c: Tuple[int, ...], act: str = "leaky_relu"
) -> ModelDefn:
    """The shared 8-block topology of base/silu/double/triple/half/quarter:
    three stride-2 convs (grid = input / 8), BN on blocks 1, 5, 6,
    channel-dropout on blocks 2, 3, 4, 1x1 head."""
    return ModelDefn(
        name=name,
        blocks=(
            ConvSpec(c[0], stride=2, bias=False, bn=True, act=act),
            ConvSpec(c[1], act=act, dropout=0.05),
            ConvSpec(c[2], stride=2, act=act, dropout=0.10),
            ConvSpec(c[3], act=act, dropout=0.15),
            ConvSpec(c[4], stride=2, bias=False, bn=True, act=act),
            ConvSpec(c[5], bn=True, act=act),
            ConvSpec(c[6], act=act),
            ConvSpec(5 + num_classes, kernel=1, padding=0, act=None),
        ),
    )


@register_model
def base_model(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:31-77
    return _scaled_stack(
        "base_model", num_classes, (16, 32, 64, 128, 128, 128, 128)
    )


@register_model
def silu_model(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:81-127
    return _scaled_stack(
        "silu_model", num_classes, (16, 32, 64, 128, 128, 128, 128), act="silu"
    )


@register_model
def double_filters(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:131-177
    return _scaled_stack(
        "double_filters", num_classes, (32, 64, 128, 256, 256, 256, 256)
    )


@register_model
def triple_filters(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:181-227
    return _scaled_stack(
        "triple_filters", num_classes, (48, 96, 192, 384, 384, 384, 384)
    )


@register_model
def half_filters(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:231-277
    return _scaled_stack("half_filters", num_classes, (8, 16, 32, 64, 64, 64, 64))


@register_model
def quarter_filters(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:281-327
    return _scaled_stack(
        "quarter_filters", num_classes, (4, 8, 16, 32, 32, 32, 32)
    )


@register_model
def depth_ver_0(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:331-354
    return ModelDefn(
        name="depth_ver_0",
        blocks=(
            ConvSpec(32, stride=2, bias=False, bn=True),
            ConvSpec(128, stride=2, dropout=0.10),
            ConvSpec(128, stride=2, bias=False, bn=True),
            ConvSpec(5 + num_classes, kernel=1, padding=0, act=None),
        ),
    )


@register_model
def depth_ver_1(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:358-392
    return ModelDefn(
        name="depth_ver_1",
        blocks=(
            ConvSpec(16, stride=2, bias=False, bn=True),
            ConvSpec(64, stride=2, dropout=0.10),
            ConvSpec(128, dropout=0.15),
            ConvSpec(128, stride=2, bias=False, bn=True),
            ConvSpec(128),
            ConvSpec(5 + num_classes, kernel=1, padding=0, act=None),
        ),
    )


@register_model
def depth_ver_2(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:396-397 (alias of base_model)
    defn = base_model(num_classes, rgb_input)
    return ModelDefn(name="depth_ver_2", blocks=defn.blocks)


@register_model
def depth_ver_3(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:401-458
    return ModelDefn(
        name="depth_ver_3",
        blocks=(
            ConvSpec(16, stride=2, bias=False, bn=True),
            ConvSpec(32, dropout=0.05),
            ConvSpec(32, dropout=0.05),
            ConvSpec(64, stride=2, dropout=0.10),
            ConvSpec(128, dropout=0.15),
            ConvSpec(128, bn=True),
            ConvSpec(128, stride=2, bias=False),  # note: no BN on this one
            ConvSpec(128, bn=True),
            ConvSpec(128),
            ConvSpec(5 + num_classes, kernel=1, padding=0, act=None),
        ),
    )


@register_model
def depth_ver_4(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    # reference: yogo/model_defns.py:462-529
    return ModelDefn(
        name="depth_ver_4",
        blocks=(
            ConvSpec(16, stride=2, bias=False, bn=True),
            ConvSpec(16),
            ConvSpec(32, dropout=0.05),
            ConvSpec(32, dropout=0.05),
            ConvSpec(64, stride=2, dropout=0.10),
            ConvSpec(64),
            ConvSpec(128, dropout=0.15),
            ConvSpec(128, bn=True),
            ConvSpec(128, stride=2),
            ConvSpec(128, bn=True),
            ConvSpec(128),
            ConvSpec(5 + num_classes, kernel=1, padding=0, act=None),
        ),
    )


@register_model
def convnext_small(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    """ConvNeXt-Small backbone + 1x1 head + ConvTranspose(4, stride 4) upsample
    to restore the YOGO grid (reference: yogo/model_defns.py:533-558, which
    delegates to timm). The JAX package implements ConvNeXt natively in
    flax (not yet ported here); the spec
    only carries the layers that affect grid-size arithmetic: the stem
    (stride-4 patchify), three stride-2 downsamples, and the stride-4
    transpose head => overall stride 8, same as base_model.
    """
    return ModelDefn(
        name="convnext_small",
        family="convnext",
        blocks=(
            # stem: 4x4 stride-4 patchify conv
            ConvSpec(96, kernel=4, stride=4, padding=0, act=None),
            # three downsample convs between stages
            ConvSpec(192, kernel=2, stride=2, padding=0, act=None),
            ConvSpec(384, kernel=2, stride=2, padding=0, act=None),
            ConvSpec(768, kernel=2, stride=2, padding=0, act=None),
            # 1x1 conv head to 5+C
            ConvSpec(5 + num_classes, kernel=1, padding=0, act=None),
            # transpose conv restores grid: kernel 4, stride 4
            ConvSpec(
                5 + num_classes,
                kernel=4,
                stride=4,
                padding=0,
                act=None,
                transpose=True,
            ),
        ),
    )


@register_model
def swin_small(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    """Swin-S (arXiv:2103.14030; timm's swin_small_patch4_window7_224) as
    the trunk, the padded detection backbone of
    Swin-Transformer-Object-Detection, with ConvNeXt's 1x1 head and stride-4
    transpose upsample (models.yogo.SwinSmall). As for convnext_small the
    spec carries only the grid arithmetic: the 4x4 stride-4 patch
    embedding, three patch merges and the head.
    """
    return ModelDefn(
        name="swin_small",
        family="swin",
        blocks=(
            # patch embedding: 4x4 stride-4 conv
            ConvSpec(96, kernel=4, stride=4, padding=0, act=None),
            # patch merging pads an odd side by one and takes 2x2 patches:
            # ceil(h / 2), which a kernel-1 stride-2 conv's
            # floor((h - 1) / 2) + 1 equals
            ConvSpec(192, kernel=1, stride=2, padding=0, act=None),
            ConvSpec(384, kernel=1, stride=2, padding=0, act=None),
            ConvSpec(768, kernel=1, stride=2, padding=0, act=None),
            ConvSpec(5 + num_classes, kernel=1, padding=0, act=None),
            ConvSpec(5 + num_classes, kernel=4, stride=4, padding=0, act=None, transpose=True),
        ),
    )


@register_model
def vitdet_base(num_classes: int, rgb_input: bool = False) -> ModelDefn:
    """ViTDet's ViT-B backbone (arXiv:2203.16527; detectron2
    projects/ViTDet, mask_rcnn_vitdet_b_100ep) with the stride-8 level of
    its simple feature pyramid and YOGO's 1x1 head
    (models.yogo.ViTDetBase). As for swin_small the spec carries only the
    grid arithmetic: the patch embedding, the pyramid's 2x2 stride-2
    transpose and the head.
    """
    return ModelDefn(
        name="vitdet_base",
        family="vitdet",
        blocks=(
            # the 16x16 stride-16 patch embedding of the frame zero-padded
            # bottom and right to a multiple of 16: ceil(h / 16), which a
            # kernel-1 stride-16 conv's floor((h - 1) / 16) + 1 equals
            ConvSpec(768, kernel=1, stride=16, padding=0, act=None),
            # the simple feature pyramid's 2x2 stride-2 transpose (its 1x1
            # and 3x3 convs keep the map's size)
            ConvSpec(384, kernel=2, stride=2, padding=0, act=None, transpose=True),
            ConvSpec(5 + num_classes, kernel=1, padding=0, act=None),
        ),
    )
