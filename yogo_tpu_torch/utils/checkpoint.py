"""Read native `.ckpt` checkpoints (port of yogo_tpu/utils/checkpoint.py:
41-44, 104-117).

The file is one msgpack map {"meta": JSON str, "variables": flax tree,
["opt_state": bytes]} written by the JAX package. It is decoded with the
port's own `msgpack_lite`, so neither msgpack nor flax is needed. Reading
reference `.pth` files is not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple, Union

from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.utils.msgpack_lite import unpackb

CKPT_SUFFIX = ".ckpt"


def model_from_config(cfg: Dict[str, Any]) -> YOGO:
    cfg = dict(cfg)
    cfg["img_size"] = tuple(cfg["img_size"])
    return YOGO(**cfg)


def load_checkpoint(
    path: Union[str, Path],
) -> Tuple[YOGO, Dict[str, Any], Dict[str, Any]]:
    """Returns (model config, variables as nested dicts of numpy arrays in
    the flax layout, meta). meta carries the raw optimizer-state bytes under
    '_opt_state_bytes' when the file has them. Turn the variables into a
    torch state_dict with utils.weights.state_dict_from_flax."""
    payload = unpackb(Path(path).read_bytes())
    meta = json.loads(payload["meta"])
    model = model_from_config(meta["model_config"])
    variables = payload["variables"]
    if "opt_state" in payload:
        meta["_opt_state_bytes"] = payload["opt_state"]
    return model, variables, meta
