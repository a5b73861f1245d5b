"""Reference `.pth` checkpoints, both ways (port of
yogo_tpu/utils/torch_bridge.py).

The reference stores one torch.save dict whose model_state_dict keys follow
its nn.Sequential layout (reference: yogo/train.py:267-293,
yogo/model.py:94-147): every block of a conv stack is Sequential(conv,
[bn], act, [drop]) at `model.{i}`, except the bare 1x1 head conv
`model.{i}` itself; convnext_small is timm's ConvNeXt in a Sequential
(`_convnext_key_pairs`). These functions map those keys onto the
flax-layout variables that the rest of the port (and the JAX package)
carries, so a `.pth` from the reference or from either package loads into
either package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from yogo_tpu_torch.models.defns import ModelDefn
from yogo_tpu_torch.models.yogo import CONVNEXT_DEPTHS, YOGO
from yogo_tpu_torch.ops.grid import cell_offsets
from yogo_tpu_torch.utils.weights import flax_params_from_named, named_from_flax_params


def _torch_key_layout(defn: ModelDefn):
    """Yield (block index, spec, conv key prefix, bn key prefix or None)."""
    for i, s in enumerate(defn.blocks):
        if i == defn.head_index:
            yield i, s, f"model.{i}", None
        else:
            yield i, s, f"model.{i}.0", (f"model.{i}.1" if s.bn else None)


def _require_known_family(defn: ModelDefn) -> None:
    if defn.family not in ("conv_stack", "convnext"):
        raise NotImplementedError(
            f".pth interop is implemented for the conv_stack and convnext "
            f"families; '{defn.name}' is family '{defn.family}'"
        )


# The reference builds convnext_small as
#   nn.Sequential(stem, stages) + add_module("format time!", head)
# from timm's ConvNeXt (reference: yogo/model_defns.py:533-558), so its keys
# follow timm's (>= 0.6) module names under the positional Sequential prefix:
#   model.0.0 / model.0.1                        stem conv + LayerNorm2d
#   model.1.{s}.downsample.{0,1}   (s = 1..3)    LayerNorm2d + 2x2 conv
#   model.1.{s}.blocks.{b}.conv_dw|norm|mlp.fc1|mlp.fc2|gamma
#   model.format time!.0 / model.format time!.1   1x1 conv + ConvTranspose2d
# timm's tensors have the port module's layouts, so only the names differ:
# the layouts are carried by utils/weights.py, as for a .ckpt.
def _convnext_key_pairs():
    """Yield (port parameter name, timm key) for ConvNeXt-Small, in timm's
    order."""

    def module(port, timm):
        return ((f"{port}.{leaf}", f"{timm}.{leaf}") for leaf in ("weight", "bias"))

    yield from module("stem_conv", "model.0.0")
    yield from module("stem_norm", "model.0.1")
    for s, depth in enumerate(CONVNEXT_DEPTHS):
        if s > 0:
            yield from module(f"down{s}_norm", f"model.1.{s}.downsample.0")
            yield from module(f"down{s}_conv", f"model.1.{s}.downsample.1")
        for b in range(depth):
            port, pfx = f"stage{s}_block{b}", f"model.1.{s}.blocks.{b}"
            yield from module(f"{port}.dwconv", f"{pfx}.conv_dw")
            yield from module(f"{port}.norm", f"{pfx}.norm")
            yield from module(f"{port}.pwconv1", f"{pfx}.mlp.fc1")
            yield from module(f"{port}.pwconv2", f"{pfx}.mlp.fc2")
            yield f"{port}.gamma", f"{pfx}.gamma"
    yield from module("format_conv", "model.format time!.0")
    yield from module("format_up", "model.format time!.1")


def _convnext_state_dict_to_params(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    return flax_params_from_named({port: state_dict[timm] for port, timm in _convnext_key_pairs()})


def _convnext_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    named = named_from_flax_params(params)
    return {timm: named[port] for port, timm in _convnext_key_pairs()}


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _np(t: Any) -> np.ndarray:
    # a copy: .numpy() is a view of the live tensor
    return np.array(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, copy=True)


def state_dict_to_variables(
    state_dict: Dict[str, Any], defn: ModelDefn
) -> Dict[str, Any]:
    """Reference-layout state_dict -> flax {'params'[, 'batch_stats']} of
    numpy arrays (conv weights OIHW -> HWIO)."""
    _require_known_family(defn)
    if defn.family == "convnext":
        return {"params": _convnext_state_dict_to_params(state_dict)}
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


def _conv_stack_state_dict(defn: ModelDefn, params, batch_stats) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for i, s, conv_key, bn_key in _torch_key_layout(defn):
        p = params[f"conv{i}"]
        sd[f"{conv_key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        if s.bias:
            sd[f"{conv_key}.bias"] = _t(p["bias"])
        if bn_key is not None:
            sd[f"{bn_key}.weight"] = _t(params[f"bn{i}"]["scale"])
            sd[f"{bn_key}.bias"] = _t(params[f"bn{i}"]["bias"])
            sd[f"{bn_key}.running_mean"] = _t(batch_stats[f"bn{i}"]["mean"])
            sd[f"{bn_key}.running_var"] = _t(batch_stats[f"bn{i}"]["var"])
            sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def variables_to_state_dict(variables: Dict[str, Any], model: YOGO) -> Dict[str, torch.Tensor]:
    """flax variables -> reference-layout state_dict, with the reference
    model's config buffers (reference: yogo/model.py:35-65)."""
    defn = model.defn
    _require_known_family(defn)
    params = variables["params"]
    if defn.family == "convnext":
        sd = _convnext_params_to_state_dict(params)
    else:
        sd = _conv_stack_state_dict(defn, params, variables.get("batch_stats", {}))
    sx, sy = model.grid
    cxs, cys = cell_offsets(sx, sy)
    sd["img_size"] = torch.tensor(list(model.img_size))
    sd["anchor_w"] = torch.tensor(model.anchor_w)
    sd["anchor_h"] = torch.tensor(model.anchor_h)
    sd["num_classes"] = torch.tensor(model.num_classes)
    sd["clip_value"] = torch.tensor(model.clip_value)
    sd["is_rgb"] = torch.tensor(model.is_rgb)
    sd["normalize_images"] = torch.tensor(model.normalize_images)
    sd["_Cxs"] = _t(cxs)
    sd["_Cys"] = _t(cys)
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
