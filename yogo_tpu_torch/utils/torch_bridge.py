"""Reference `.pth` checkpoints, both ways (port of
yogo_tpu/utils/torch_bridge.py for the conv-stack family).

The reference stores one torch.save dict whose model_state_dict keys follow
its nn.Sequential layout (reference: yogo/train.py:267-293,
yogo/model.py:94-147): every block is Sequential(conv, [bn], act, [drop])
at `model.{i}`, except the bare 1x1 head conv `model.{i}` itself. These
functions map those keys onto the flax-layout variables that the rest of
the port (and the JAX package) carries, so a `.pth` from the reference or
from either package loads into either package.

ConvNeXt `.pth` keys (timm's module naming) are not ported: they raise,
naming ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from yogo_tpu_torch.models.defns import ModelDefn
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.ops.grid import cell_offsets


def _torch_key_layout(defn: ModelDefn):
    """Yield (block index, spec, conv key prefix, bn key prefix or None)."""
    for i, s in enumerate(defn.blocks):
        if i == defn.head_index:
            yield i, s, f"model.{i}", None
        else:
            yield i, s, f"model.{i}.0", (f"model.{i}.1" if s.bn else None)


def _require_conv_stack(defn: ModelDefn) -> None:
    if defn.family == "convnext":
        raise NotImplementedError(
            f".pth interop for '{defn.name}' (family convnext) is not ported "
            "yet: ROADMAP.md Queue 1 item 12 brings the ConvNeXt family and "
            "its .pth keys"
        )
    if defn.family != "conv_stack":
        raise NotImplementedError(
            f".pth interop is implemented for the conv_stack family; "
            f"'{defn.name}' is family '{defn.family}'"
        )


def _np(t: Any) -> np.ndarray:
    # a copy: .numpy() is a view of the live tensor
    return np.array(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, copy=True)


def state_dict_to_variables(
    state_dict: Dict[str, Any], defn: ModelDefn
) -> Dict[str, Any]:
    """Reference-layout state_dict -> flax {'params', 'batch_stats'} of
    numpy arrays (conv weights OIHW -> HWIO)."""
    _require_conv_stack(defn)
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for i, s, conv_key, bn_key in _torch_key_layout(defn):
        p = {"kernel": np.transpose(_np(state_dict[f"{conv_key}.weight"]), (2, 3, 1, 0))}
        if s.bias:
            p["bias"] = _np(state_dict[f"{conv_key}.bias"])
        params[f"conv{i}"] = p
        if bn_key is not None:
            params[f"bn{i}"] = {
                "scale": _np(state_dict[f"{bn_key}.weight"]),
                "bias": _np(state_dict[f"{bn_key}.bias"]),
            }
            batch_stats[f"bn{i}"] = {
                "mean": _np(state_dict[f"{bn_key}.running_mean"]),
                "var": _np(state_dict[f"{bn_key}.running_var"]),
            }
    variables: Dict[str, Any] = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    return variables


def variables_to_state_dict(variables: Dict[str, Any], model: YOGO) -> Dict[str, torch.Tensor]:
    """flax variables -> reference-layout state_dict, with the reference
    model's config buffers (reference: yogo/model.py:35-65)."""
    defn = model.defn
    _require_conv_stack(defn)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})

    def t(x):
        return torch.from_numpy(np.array(x, copy=True))

    sd: Dict[str, torch.Tensor] = {}
    for i, s, conv_key, bn_key in _torch_key_layout(defn):
        p = params[f"conv{i}"]
        sd[f"{conv_key}.weight"] = t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        if s.bias:
            sd[f"{conv_key}.bias"] = t(p["bias"])
        if bn_key is not None:
            sd[f"{bn_key}.weight"] = t(params[f"bn{i}"]["scale"])
            sd[f"{bn_key}.bias"] = t(params[f"bn{i}"]["bias"])
            sd[f"{bn_key}.running_mean"] = t(batch_stats[f"bn{i}"]["mean"])
            sd[f"{bn_key}.running_var"] = t(batch_stats[f"bn{i}"]["var"])
            sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    sx, sy = model.grid
    cxs, cys = cell_offsets(sx, sy)
    sd["img_size"] = torch.tensor(list(model.img_size))
    sd["anchor_w"] = torch.tensor(model.anchor_w)
    sd["anchor_h"] = torch.tensor(model.anchor_h)
    sd["num_classes"] = torch.tensor(model.num_classes)
    sd["clip_value"] = torch.tensor(model.clip_value)
    sd["is_rgb"] = torch.tensor(model.is_rgb)
    sd["normalize_images"] = torch.tensor(model.normalize_images)
    sd["_Cxs"] = t(cxs)
    sd["_Cys"] = t(cys)
    sd["height_multiplier"] = torch.tensor(model.height_multiplier)
    sd["width_multiplier"] = torch.tensor(model.width_multiplier)
    return sd


def load_pth(pth_path) -> Tuple[YOGO, Dict[str, Any], Dict[str, Any]]:
    """Load a reference-format .pth -> (model config, flax variables, meta),
    meta as the reference's from_pth gives it (step, class_names,
    normalize_images, epoch, model_name). Newer keys may be missing, as the
    reference allows. The file is read with weights_only=True: it holds
    tensors, numbers, strings and containers only."""
    loaded = torch.load(str(Path(pth_path)), map_location="cpu", weights_only=True)
    sd = loaded["model_state_dict"]

    def buf(name, default):
        v = sd.get(name)
        if v is None:
            return default
        return v.item() if isinstance(v, torch.Tensor) and v.numel() == 1 else v

    img_size = sd["img_size"]
    normalize_images = bool(buf("normalize_images", loaded.get("normalize_images", False)))
    model = YOGO.create(
        img_size=(int(img_size[0]), int(img_size[1])),
        anchor_w=float(sd["anchor_w"].item()),
        anchor_h=float(sd["anchor_h"].item()),
        num_classes=int(sd["num_classes"].item()),
        is_rgb=bool(buf("is_rgb", False)),
        normalize_images=normalize_images,
        clip_value=float(buf("clip_value", 1.0)),
        model_version=loaded.get("model_version", None) or "base_model",
        height_multiplier=float(buf("height_multiplier", 1.0)),
        width_multiplier=float(buf("width_multiplier", 1.0)),
    )
    variables = state_dict_to_variables(sd, model.defn)
    meta = {
        "step": loaded.get("step", 0),
        "class_names": loaded.get("class_names", loaded.get("classes", None)),
        "normalize_images": normalize_images,
        "epoch": loaded.get("epoch", 0),
        "model_name": loaded.get("model_name", None),
    }
    return model, variables, meta


def save_pth(path, model: YOGO, variables: Dict[str, Any], **metadata) -> None:
    """Write a reference-compatible .pth (schema: reference
    yogo/train.py:267-293)."""
    classes = metadata.pop("classes", None)
    payload = {
        "epoch": metadata.pop("epoch", 0),
        "step": metadata.pop("step", 0),
        "normalize_images": model.normalize_images,
        "classes": classes,
        # the reference's checkpointer writes "classes" but its from_pth
        # reads "class_names" (reference: yogo/train.py:285 vs
        # yogo/model.py:103): both, so the names survive either reader
        "class_names": classes,
        "model_name": metadata.pop("model_name", None),
        "model_state_dict": variables_to_state_dict(variables, model),
        "optimizer_state_dict": metadata.pop("optimizer_state_dict", {}),
        "model_version": model.model_version,
        **metadata,
    }
    torch.save(payload, str(path))
