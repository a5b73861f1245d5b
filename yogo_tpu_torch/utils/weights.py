"""Carry weights and optimizer state between the JAX package's flax / optax
layout and torch modules, both ways, as numpy trees.

flax keeps conv kernels HWIO, Dense kernels (I, O) and names norm tensors
scale/bias (BN also mean/var); the port's modules (models/yogo.py) keep
torch's layouts and names under the same module paths:

  conv kernel  .../{conv}/kernel (HWIO)   <-> {conv}.weight (OIHW, transpose(3,2,0,1));
               a depthwise (7,7,1,C) gives (C,1,7,7)
  Dense        .../{pwconv1,pwconv2,qkv,proj,fc1,fc2,reduction}/kernel (I,O)
               <-> .weight (O,I)
  transpose    {format_up,neck_up}/kernel (kh,kw,I,O) <-> .weight (I,O,kh,kw),
               spatially flipped: flax's ConvTranspose correlates with the
               kernel as it is, torch's ConvTranspose2d with it flipped
  norms        bn{i} / *norm: scale, bias <-> weight, bias
  ConvNeXt     stage{s}_block{b}/gamma <-> stage{s}_block{b}.gamma (a bare parameter)
  Swin         stage{s}_block{b}/rel_bias <-> stage{s}_block{b}.rel_bias (a bare
               parameter; the swin family is the port's own, so this layout
               is only its checkpoints')
  ViTDet       pos_embed (top level) and block{i}/rel_pos_{h,w}, bare
               parameters likewise (the vitdet family is the port's own too)
  biases       bias <-> bias
  BN stats     batch_stats/bn{i}/{mean,var} <-> bn{i}.running_{mean,var}
  (bn{i}.num_batches_tracked, which flax does not track, is 0 one way and
  dropped the other)

The optimizer of train.make_optimizer is, in the JAX package,
optax.chain(clip, adamw(schedule)), whose state flax serializes as

  {"0": {},                                  # clip
   "1": {"0": {"count", "mu", "nu"},        # scale_by_adam
         "1": {},                            # add_decayed_weights
         "2": {"count"}}}                    # scale_by_schedule

with mu / nu shaped like params. torch.optim.AdamW keeps, per parameter,
step / exp_avg / exp_avg_sq, and the scheduler its own step count.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from yogo_tpu_torch.parallel.mesh import full_tensor, shard_like

_STATS = {"running_mean": "mean", "running_var": "var"}
_LINEAR = ("pwconv1", "pwconv2", "qkv", "proj", "fc1", "fc2", "reduction")
_BARE = ("gamma", "rel_bias", "pos_embed", "rel_pos_h", "rel_pos_w")  # parameters of a module, not of a submodule
_TRANSPOSE = ("format_up", "neck_up")


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _is_norm(module: str) -> bool:
    return module.startswith("bn") or module.endswith("norm")


def _leaf_to_torch(module: str, leaf: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    """(flax leaf name, array) of module `module` -> (torch suffix, array)."""
    if leaf == "kernel" and not _is_norm(module):
        if module in _LINEAR:
            return "weight", a.T
        if module in _TRANSPOSE:
            return "weight", a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        return "weight", a.transpose(3, 2, 0, 1)
    if leaf == "scale" and _is_norm(module):
        return "weight", a
    if leaf == "bias":
        return "bias", a
    raise ValueError(f"unexpected parameter {module}/{leaf}")


def _leaf_to_flax(module: str, suffix: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    """The inverse of _leaf_to_torch."""
    if suffix == "weight":
        if _is_norm(module):
            return "scale", a
        if module in _LINEAR:
            return "kernel", a.T
        if module in _TRANSPOSE:
            return "kernel", a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        return "kernel", a.transpose(2, 3, 1, 0)
    if suffix == "bias":
        return "bias", a
    raise ValueError(f"unexpected parameter {module}.{suffix}")


def named_from_flax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax params-shaped tree (the params, or Adam's mu / nu) ->
    {torch parameter name: float32 tensor} in torch's layouts."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict[str, Any], path: Tuple[str, ...]) -> None:
        for name, child in node.items():
            if isinstance(child, dict):
                walk(child, path + (name,))
            elif name in _BARE:
                out[".".join(path + (name,))] = _tensor(child)
            elif not path:
                raise ValueError(f"unexpected top-level parameter {name!r}")
            else:
                suffix, a = _leaf_to_torch(path[-1], name, np.asarray(child, np.float32))
                out[".".join(path + (suffix,))] = _tensor(a)

    walk(params, ())
    return out


def flax_params_from_named(named: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of named_from_flax_params: {torch parameter name: tensor
    or array} -> a flax params-shaped tree of float32 numpy arrays."""
    params: Dict[str, Any] = {}
    for key, value in named.items():
        a = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        a = np.asarray(a, np.float32)
        *path, suffix = key.split(".")
        if suffix in _BARE:
            node, leaf = params, suffix
        else:
            if not path:
                raise ValueError(f"unexpected parameter {key!r}")
            leaf, a = _leaf_to_flax(path[-1], suffix, a)
            node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    return params


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables {"params": ..., ["batch_stats": ...]} -> a state_dict
    that the architecture's module (YOGO.module) load_state_dict(strict=True)
    accepts."""
    sd = named_from_flax_params(variables["params"])
    for name, stats in variables.get("batch_stats", {}).items():
        for buffer, leaf in _STATS.items():
            sd[f"{name}.{buffer}"] = _tensor(stats[leaf])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A module's state_dict -> flax variables {"params", "batch_stats"}
    as nested dicts of float32 numpy arrays (what save_checkpoint writes
    and the JAX package's YOGO.apply takes). A model without BN gets an
    empty "batch_stats", as the JAX package's Trainer writes it."""
    named, batch_stats = {}, {}
    for key, value in state_dict.items():
        name, _, suffix = key.rpartition(".")
        if suffix in _STATS:
            batch_stats.setdefault(name, {})[_STATS[suffix]] = np.array(
                value.detach().cpu().numpy(), np.float32
            )
        elif suffix != "num_batches_tracked":
            named[key] = value
    return {"params": flax_params_from_named(named), "batch_stats": batch_stats}


# ------------------------------------------------------------ int8 program
def quant_params_from_jax(qp: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's quantize_conv_stack output (leaves as numpy) ->
    the port's int8 program parameters (ops/quant.py quantize_conv_stack's
    layout), CPU tensors: HWIO int8 becomes the int8 conv kernel's packed
    (Cout, k, k, Cin padded) layout, bf16 HWIO kernels OIHW bf16, and
    deq / b / scales are carried as they are. The same program then runs
    through both forwards."""
    from yogo_tpu_torch.ops.int8_conv import pack_weights

    def oihw_bf16(w):
        a = np.asarray(w, np.float32).transpose(3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)

    blocks = []
    for blk in qp["blocks"]:
        if "w8" in blk:
            blocks.append({"w8": pack_weights(np.asarray(blk["w8"], np.int8)),
                           "deq": _tensor(blk["deq"]), "b": _tensor(blk["b"])})
        else:
            blocks.append({"w": oihw_bf16(blk["w"]), "b": _tensor(blk["b"])})
    return {"stem_w": oihw_bf16(qp["stem_w"]), "stem_b": _tensor(qp["stem_b"]),
            "blocks": blocks, "scales": _tensor(qp["scales"])}


# ------------------------------------------------------------ optimizer state
def optax_state_from_torch(
    stack: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
) -> Dict[str, Any]:
    """The AdamW moments and step counts as the optax state tree of the JAX
    package's make_optimizer (see the module docstring). A parameter the
    optimizer has not stepped yet has zero moments."""
    mu, nu, count = {}, {}, 0
    for name, p in stack.named_parameters():
        st = optimizer.state.get(p, {})
        # an FSDP-sharded moment is gathered whole (every rank joins)
        mu[name] = full_tensor(st.get("exp_avg", torch.zeros_like(p)))
        nu[name] = full_tensor(st.get("exp_avg_sq", torch.zeros_like(p)))
        count = max(count, int(st.get("step", 0)))
    adam = {
        "count": np.asarray(count, np.int32),
        "mu": flax_params_from_named(mu),
        "nu": flax_params_from_named(nu),
    }
    schedule = {"count": np.asarray(scheduler.last_epoch, np.int32)}
    return {"0": {}, "1": {"0": adam, "1": {}, "2": schedule}}


def load_optax_state(
    opt_state: Dict[str, Any],
    stack: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
) -> None:
    """Load an optax state tree of make_optimizer (as optax_state_from_torch
    writes it, or decoded from a checkpoint's opt_state bytes) into the
    AdamW and its scheduler: the next step continues where JAX would."""
    adam = opt_state["1"]["0"]
    mu = named_from_flax_params(adam["mu"])
    nu = named_from_flax_params(adam["nu"])
    names = [name for name, _ in stack.named_parameters()]
    if sorted(names) != sorted(mu) or sorted(names) != sorted(nu):
        raise ValueError(
            f"optimizer state has parameters {sorted(mu)}, the model has {sorted(names)}"
        )
    index = {p: i for g in optimizer.param_groups for i, p in enumerate(g["params"])}
    if len(optimizer.param_groups) != 1 or len(index) != len(names):
        raise ValueError("expected one parameter group holding every parameter of the stack")
    step = float(np.asarray(adam["count"]))
    state = {}
    for name, p in stack.named_parameters():
        if mu[name].shape != p.shape:
            raise ValueError(f"{name}: moment shape {tuple(mu[name].shape)} vs {tuple(p.shape)}")
        m, v = mu[name], nu[name]
        if isinstance(p, DTensor):  # an FSDP-sharded parameter: its moments shard with it
            m, v = shard_like(m, p), shard_like(v, p)
        state[index[p]] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": m,
            "exp_avg_sq": v,
        }
    optimizer.load_state_dict(
        {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}
    )
    set_schedule_step(scheduler, int(np.asarray(opt_state["1"]["2"]["count"])))


def set_schedule_step(scheduler: torch.optim.lr_scheduler.LambdaLR, count: int) -> None:
    """Put a LambdaLR at optimizer step `count`: the next optimizer.step()
    uses the learning rate of that step."""
    scheduler.last_epoch = count
    scheduler._step_count = count + 1
    lrs = [base * fn(count) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
