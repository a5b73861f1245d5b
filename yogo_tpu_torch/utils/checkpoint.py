"""Read and write native `.ckpt` checkpoints (port of
yogo_tpu/utils/checkpoint.py:31-125).

The file is one msgpack map {"meta": JSON str, "variables": flax tree,
["opt_state": bytes]}, format "yogo_tpu.ckpt.v1", the same the JAX package
reads and writes: a checkpoint of either package resumes in the other. It
is coded with the port's own `msgpack_lite`, so neither msgpack nor flax is
needed. Reading reference `.pth` files is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.utils.msgpack_lite import packb, unpackb
from yogo_tpu_torch.utils.weights import load_optax_state

CKPT_SUFFIX = ".ckpt"


def model_config_dict(model: YOGO) -> Dict[str, Any]:
    cfg = {
        f.name: getattr(model, f.name)
        for f in dataclasses.fields(model)
        if f.name != "compute_dtype"
    }
    cfg["img_size"] = list(cfg["img_size"])
    return cfg


def model_from_config(cfg: Dict[str, Any]) -> YOGO:
    cfg = dict(cfg)
    cfg["img_size"] = tuple(cfg["img_size"])
    return YOGO(**cfg)


def _key_sorted(tree: Any) -> Any:
    """Dicts with their keys in sorted order, recursively: the order flax
    writes them in, so that the same trees give the same bytes."""
    if isinstance(tree, dict):
        return {k: _key_sorted(tree[k]) for k in sorted(tree)}
    return tree


def save_checkpoint(
    path: Union[str, Path],
    model: YOGO,
    variables: Dict[str, Any],
    opt_state: Any = None,
    epoch: int = 0,
    step: int = 0,
    classes: Optional[list] = None,
    model_name: Optional[str] = None,
    **extra_metadata,
) -> None:
    """Write one checkpoint file atomically. `variables` is the flax-layout
    numpy tree (utils.weights.flax_from_state_dict(stack.state_dict())) and
    `opt_state` the optax-layout one (utils.weights.optax_state_from_torch),
    stored as the bytes flax's serialization.to_bytes would give."""
    payload = {
        "meta": json.dumps(
            {
                "format": "yogo_tpu.ckpt.v1",
                "epoch": epoch,
                "step": step,
                "normalize_images": bool(model.normalize_images),
                "classes": classes,
                "model_name": model_name,
                "model_version": model.model_version,
                "model_config": model_config_dict(model),
                **extra_metadata,
            }
        ),
        "variables": variables,
    }
    if opt_state is not None:
        payload["opt_state"] = packb(_key_sorted(opt_state))
    data = packb(_key_sorted(payload))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # pid-unique tmp name: even if two processes ever write the same
    # checkpoint path, neither renames a torn interleaved file into place
    tmp = path.with_suffix(path.suffix + f".tmp.{os.getpid()}")
    # fsync BEFORE the rename: the rename alone can be journaled durable
    # while the tmp file's data blocks are not, leaving a truncated file at
    # the final path after power loss. The directory fsync afterwards makes
    # the rename itself durable.
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)  # atomic: never leave a torn checkpoint
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # e.g. a filesystem that can't fsync directories


def load_checkpoint(
    path: Union[str, Path],
) -> Tuple[YOGO, Dict[str, Any], Dict[str, Any]]:
    """Returns (model config, variables as nested dicts of numpy arrays in
    the flax layout, meta). meta carries the raw optimizer-state bytes under
    '_opt_state_bytes' when the file has them (restore with
    restore_opt_state once the optimizer is built). Turn the variables into
    a torch state_dict with utils.weights.state_dict_from_flax."""
    payload = unpackb(Path(path).read_bytes())
    meta = json.loads(payload["meta"])
    model = model_from_config(meta["model_config"])
    variables = payload["variables"]
    if "opt_state" in payload:
        meta["_opt_state_bytes"] = payload["opt_state"]
    return model, variables, meta


def restore_opt_state(
    meta: Dict[str, Any],
    stack: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
) -> bool:
    """Load the checkpoint's optimizer state, if it has one, into the
    optimizer and scheduler of train.make_optimizer; returns whether it
    did. Without one they stay as they are, as in the JAX package."""
    if "_opt_state_bytes" not in meta:
        return False
    load_optax_state(unpackb(meta["_opt_state_bytes"]), stack, optimizer, scheduler)
    return True
