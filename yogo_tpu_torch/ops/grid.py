"""Grid-size arithmetic and cell-offset grids (copy of
yogo_tpu/ops/grid.py:19-75).

Folds conv shape arithmetic over the declarative layer specs (reference:
yogo/model.py:189-234) and builds the YOLO9000 "direct location prediction"
cell-corner grids (reference: yogo/model.py:48-61). At 772x1032 the
base_model grid is Sx=129, Sy=97.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np

# exp overflow guard in the w/h decode (reference: yogo/model.py:284-287)
WH_CLAMP = 80.0


def conv_out_size(
    size: int, kernel: int, stride: int, padding: int, dilation: int = 1
) -> int:
    return int(
        math.floor((size + 2 * padding - dilation * (kernel - 1) - 1) / stride + 1)
    )


def conv_transpose_out_size(
    size: int,
    kernel: int,
    stride: int,
    padding: int,
    output_padding: int = 0,
    dilation: int = 1,
) -> int:
    return (size - 1) * stride - 2 * padding + dilation * (kernel - 1) + output_padding + 1


def grid_size(layer_specs: Iterable, img_h: int, img_w: int) -> Tuple[int, int]:
    """Fold conv shape arithmetic over layer specs, returning (Sx, Sy).

    Each spec must expose .kernel, .stride, .padding and optionally
    .transpose / .output_padding (see models.defns.ConvSpec).
    """
    h, w = img_h, img_w
    for s in layer_specs:
        if getattr(s, "transpose", False):
            h = conv_transpose_out_size(
                h, s.kernel, s.stride, s.padding, getattr(s, "output_padding", 0)
            )
            w = conv_transpose_out_size(
                w, s.kernel, s.stride, s.padding, getattr(s, "output_padding", 0)
            )
        else:
            h = conv_out_size(h, s.kernel, s.stride, s.padding)
            w = conv_out_size(w, s.kernel, s.stride, s.padding)
    return int(w), int(h)  # (Sx, Sy)


def cell_offsets(Sx: int, Sy: int) -> Tuple[np.ndarray, np.ndarray]:
    """Cell-corner coordinate grids (Cxs, Cys), each (Sy, Sx) float32.

    Cx = linspace(0, 1 - 1/Sx, Sx) broadcast over rows; Cy analogous
    (reference: yogo/model.py:48-61).
    """
    cxs = np.broadcast_to(
        np.linspace(0.0, 1.0 - 1.0 / Sx, Sx, dtype=np.float32), (Sy, Sx)
    )
    cys = np.broadcast_to(
        np.linspace(0.0, 1.0 - 1.0 / Sy, Sy, dtype=np.float32)[:, None], (Sy, Sx)
    )
    return np.ascontiguousarray(cxs), np.ascontiguousarray(cys)
