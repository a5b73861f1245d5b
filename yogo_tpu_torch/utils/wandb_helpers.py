"""wandb table/plot helpers + small runtime utilities (port of
yogo_tpu/utils/wandb_helpers.py; reference: yogo/utils/utils.py:50-140).
wandb is imported only inside the functions that build its objects.

The reference's and the JAX package's `choose_device` (the best device
present, the CPU when there is no accelerator) is not ported: the port's
entry points run on CUDA and raise without it unless the caller asks for
the CPU (models/yogo.resolve_device), and a picker that falls back to the
CPU would hide a missing card.
"""

from __future__ import annotations

import socket
from typing import List, Sequence, Union

import numpy as np


def get_free_port() -> int:
    """Bind port 0 and return the assigned port (reference:
    yogo/utils/utils.py:137-140): a rendezvous port for
    torch.distributed.init_process_group's tcp://localhost:<port>."""
    sock = socket.socket()
    sock.bind(("", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def get_wandb_roc(
    fpr: Union[Sequence, Sequence[Sequence]],
    tpr: Sequence[Sequence],
    thresholds: Union[Sequence, Sequence[Sequence]],
    classes: Sequence,
):
    """Long-form wandb Table of per-class ROC curves
    (reference: yogo/utils/utils.py:50-88).

    Accepts ragged per-class curves (different lengths per class, as
    per-class-threshold ROC implementations produce): the iteration below
    is pure-python zips, so only shared 1-D inputs are broadcast."""

    def _is_flat(seq) -> bool:
        arr = np.asarray(seq, dtype=object)
        return arr.ndim == 1 and (arr.size == 0 or np.isscalar(arr.flat[0]))

    if _is_flat(fpr):
        fpr = [fpr] * len(tpr)
    if _is_flat(thresholds):
        thresholds = [thresholds] * len(tpr)
    assert len(fpr) == len(tpr), "Number of fprs and tprs must match"
    assert len(classes) == len(tpr), "Number of classes and tprs must match"

    data = [
        [float(x), float(y), float(thr), classes[i]]
        for i, (xs, ys, thrs) in enumerate(zip(fpr, tpr, thresholds))
        for x, y, thr in zip(xs, ys, thrs)
    ]

    import wandb  # slow import, only when needed

    return wandb.Table(data=data, columns=["fpr", "tpr", "threshold", "class"])


def get_wandb_confusion(
    confusion_data: np.ndarray,
    class_names: List[str],
    title: str = "confusion matrix",
):
    """wandb confusion-matrix plot with index-prefixed class names to fix
    wandb's alphabetic sorting (reference: yogo/utils/utils.py:91-129)."""
    confusion_data = np.asarray(confusion_data)
    nc1, nc2 = confusion_data.shape
    assert nc1 == nc2 == len(class_names), (
        f"nc1 != nc2 != len(class_names)! "
        f"(nc1 = {nc1}, nc2 = {nc2}, class_names = {class_names})"
    )

    rows = [
        (
            f"{i} - {class_names[i]}",
            f"{j} - {class_names[j]}",
            int(confusion_data[i, j]),
        )
        for i in range(nc1)
        for j in range(nc2)
    ]

    import wandb

    return wandb.plot_table(
        "wandb/confusion_matrix/v1",
        wandb.Table(columns=["Actual", "Predicted", "nPredictions"], data=rows),
        {
            "Actual": "Actual",
            "Predicted": "Predicted",
            "nPredictions": "nPredictions",
        },
        {"title": title},
    )
